"""NMS-free CenterNet decode, plain: sigmoid, 3x3 max-pool peaks, the exact
top-k over (pixel, class), boxes from the offset and size heads at the
output stride, mapped back through the letterbox into source pixels."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvbench.reference.preprocess import Letterbox


def decode(heatmap: torch.Tensor, offset: torch.Tensor, size: torch.Tensor, stride: int,
           top_k: int, lb: Letterbox, min_score: float = 1.0):
    """One frame's heads (C, H, W), (2, H, W), (2, H, W) -> boxes (K, 4)
    [x0, y0, x1, y1] in source pixels, scores (K,), classes (K,), best
    first: the best ``top_k``, or more, every peak of at least
    ``min_score``."""
    C, H, W = heatmap.shape
    prob = torch.sigmoid(heatmap.float())
    pooled = F.max_pool2d(prob[None], 3, stride=1, padding=1)[0]
    peaks = torch.where(pooled == prob, prob, torch.zeros_like(prob))
    flat = peaks.permute(1, 2, 0).reshape(-1)          # (pixel, class) order
    k = max(top_k, int((flat >= min_score).sum()))
    scores, idx = torch.topk(flat, min(k, flat.numel()))
    cls, pix = idx % C, idx // C
    py, px = (pix // W).float(), (pix % W).float()
    off = offset.reshape(2, -1)[:, pix].float()
    sz = size.reshape(2, -1)[:, pix].float()
    cx, cy = (px + off[0]) * stride, (py + off[1]) * stride
    bw, bh = sz[0] * stride, sz[1] * stride
    sx, sy = lb.w / lb.new_w, lb.h / lb.new_h
    boxes = torch.stack([(cx - bw * 0.5 - lb.x0) * sx, (cy - bh * 0.5 - lb.y0) * sy,
                         (cx + bw * 0.5 - lb.x0) * sx, (cy + bh * 0.5 - lb.y0) * sy], -1)
    return boxes, scores, cls
