"""NMS-free CenterNet decode on the device, and the dense models' class
argmax, palette lookup and bilinear upsample.

Mirrors ``cvm_tpu/ops/decode.py`` (``Detections``, ``decode_centernet``,
``decode_centernet_with_extras``, ``Detections3d``, ``decode_centernet_3d``,
``_decode_core``, ``semseg_argmax``, ``colorize_semseg``,
``upsample_bilinear``): sigmoid, a 3x3 SAME max-pool padded with -inf whose
equality marks peaks, the two-stage exact top-k, and the offset/size gather.
Heads are NHWC and are flattened as NHWC, so candidates rank in the
reference's (pixel, class) order. ``torch.topk`` may order exactly equal
scores differently from ``lax.top_k``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) [x0, y0, x1, y1] in input-pixel coords
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int32


def _maxpool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME max-pool over (B, H, W, C); max_pool2d pads with
    -inf, as the reference's reduce_window."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)


def decode_centernet(heatmap: torch.Tensor, offset: torch.Tensor, size: torch.Tensor,
                     stride: int, top_k: int = 100, from_logits: bool = True) -> Detections:
    """heatmap (B, Hs, Ws, C) logits (by default), offset (B, Hs, Ws, 2)
    sub-pixel centre offsets (x, y), size (B, Hs, Ws, 2) box (w, h) in
    output-stride units -> top_k detections per image."""
    return _decode_core(heatmap, offset, size, stride, top_k, from_logits)[0]


def decode_centernet_with_extras(heatmap: torch.Tensor, offset: torch.Tensor,
                                 size: torch.Tensor, stride: int,
                                 extras: Dict[str, torch.Tensor], top_k: int = 100,
                                 from_logits: bool = True
                                 ) -> Tuple[Detections, Dict[str, torch.Tensor]]:
    """``decode_centernet`` plus each extra dense map {name: (B, Hs, Ws,
    C)} gathered at the detections' peaks -> {name: (B, top_k, C)}."""
    det, pix = _decode_core(heatmap, offset, size, stride, top_k, from_logits)
    B, Hs, Ws, _ = heatmap.shape
    out = {}
    for name, m in extras.items():
        C = m.shape[-1]
        out[name] = torch.gather(m.reshape(B, Hs * Ws, C), 1, pix[..., None].expand(-1, -1, C))
    return det, out


class Detections3d(NamedTuple):
    det: Detections           # 2D boxes / scores / classes
    centers3d: torch.Tensor   # (B, K, 3) camera-frame (X, Y, Z) metres
    dims: torch.Tensor        # (B, K, 3) (h, w, l) metres
    yaw: torch.Tensor         # (B, K) radians


def decode_centernet_3d(heatmap: torch.Tensor, offset: torch.Tensor, size: torch.Tensor,
                        depth3d: torch.Tensor, dims3d: torch.Tensor, rot: torch.Tensor,
                        intrinsics: torch.Tensor, stride: int, top_k: int = 100,
                        from_logits: bool = True) -> Detections3d:
    """Monocular 3D decode: peaks -> metric camera-frame boxes.

    depth3d (B, Hs, Ws, 1) logits of the 1/sigmoid - 1 depth; dims3d (B,
    Hs, Ws, 3) metres; rot (B, Hs, Ws, 2) yaw (sin, cos); intrinsics (B, 4)
    [fx, fy, cx, cy] in model-input pixels (``ops.warp.scale_intrinsics``
    of the source-image ones). The decoded 2D centre (u, v) back-projects
    to X = (u - cx) Z / fx, Y = (v - cy) Z / fy."""
    det, ex = decode_centernet_with_extras(
        heatmap, offset, size, stride, {"depth3d": depth3d, "dims3d": dims3d, "rot": rot},
        top_k, from_logits)
    z = 1.0 / torch.sigmoid(ex["depth3d"][..., 0]) - 1.0
    u = (det.boxes[..., 0] + det.boxes[..., 2]) * 0.5
    v = (det.boxes[..., 1] + det.boxes[..., 3]) * 0.5
    fx, fy, cx, cy = (intrinsics[:, i:i + 1] for i in range(4))
    centers = torch.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], -1)
    yaw = torch.atan2(ex["rot"][..., 0], ex["rot"][..., 1])
    return Detections3d(det, centers, ex["dims3d"], yaw)


def _decode_core(heatmap, offset, size, stride, top_k, from_logits):
    B, Hs, Ws, C = heatmap.shape
    prob = torch.sigmoid(heatmap) if from_logits else heatmap
    peaks = torch.where(_maxpool3x3(prob) == prob, prob, torch.zeros_like(prob))

    # Two-stage exact top-k (see the reference): rank pixels by their best
    # class, then re-rank the full class rows of the top-K pixels.
    k1 = min(top_k, Hs * Ws)
    pix_best = peaks.amax(dim=-1).reshape(B, Hs * Ws)
    cand_pix = torch.topk(pix_best, k1, dim=1).indices                     # (B, K1)
    cand = torch.gather(peaks.reshape(B, Hs * Ws, C), 1,
                        cand_pix[..., None].expand(B, k1, C))              # (B, K1, C)
    scores, idx = torch.topk(cand.reshape(B, k1 * C), min(top_k, k1 * C), dim=1)
    if top_k > k1 * C:  # tiny maps cannot supply top_k candidates: pad
        pad = top_k - k1 * C
        scores = F.pad(scores, (0, pad))
        idx = F.pad(idx, (0, pad))

    cls = (idx % C).to(torch.int32)
    pix = torch.gather(cand_pix, 1, idx // C)
    py = (pix // Ws).to(torch.float32)
    px = (pix % Ws).to(torch.float32)
    off = torch.gather(offset.reshape(B, Hs * Ws, 2), 1, pix[..., None].expand(B, top_k, 2))
    sz = torch.gather(size.reshape(B, Hs * Ws, 2), 1, pix[..., None].expand(B, top_k, 2))

    cx = (px + off[..., 0]) * stride
    cy = (py + off[..., 1]) * stride
    w = sz[..., 0] * stride
    h = sz[..., 1] * stride
    boxes = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)
    return Detections(boxes, scores, cls), pix


def semseg_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) logits -> (B, H, W) int32 class map; the first maximum
    wins a tie, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def colorize_semseg(class_map: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """(..., H, W) int class map + (C, 3) uint8 palette -> (..., H, W, 3)
    RGB: one lookup-table gather on the class map's device."""
    return palette.to(class_map.device)[class_map.long()]


def upsample_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample (B, h, w, C) -> (B, H, W, C) float32 with half-pixel
    centres and border-replicate edges: ``sample_bilinear`` through
    ``full_roi``, as the reference (``F.interpolate`` treats the edges
    otherwise)."""
    from cvm_tpu_torch.ops.image import full_roi, sample_bilinear

    B, h, w = x.shape[:3]
    src_h, src_w = (torch.full((B,), float(n), dtype=torch.float32, device=x.device)
                    for n in (h, w))
    roi = full_roi(src_h, src_w, out_hw[0], out_hw[1])
    return sample_bilinear(x, roi, out_hw)
