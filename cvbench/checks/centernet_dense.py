"""CenterNet detection in a bfloat16 posture: each served detection against
the float32 reference's dense maps of the same frame, pixel by pixel.

A served detection is the heads' values at one pixel of the output map
(one class's score, the offset and size there) put through the box
mapping; so for each one there should be a pixel of the reference's maps
with the same class that gives the same score and the same box. Matching
against every pixel, and not only against the reference's own peaks, is
what a bfloat16 heatmap needs: its logits are rounded to a few bits, so
two neighbouring pixels often round to the same value, and the 3x3
max-pool then keeps both as peaks. The program serves those plateau twins
(the reference, in float32, keeps one), which moves every later rank of
its top-k; ``checks/centernet.py``'s numbers, which match served
detections to reference peaks and compare the sorted scores rank by rank,
read the twins as errors as large as a lower precision's.

Scores are compared as logits, clamped as the served scores are (the
sigmoid of float32 saturates), in units of the spread (standard deviation)
of the reference's heatmap logits over the frame.

  * ``pixel_box_gap_px`` (compared): for each served detection, over the
    reference pixels of its class whose logit lies within ``WINDOW``
    spreads of its score, the least box-coordinate difference in source
    pixels (``NO_MATCH`` where no pixel is within the window); the largest
    over the sample.
  * ``pixel_score_gap`` (compared): for each served detection, over the
    reference pixels of its class whose box lies within ``NEAR_PX`` source
    pixels of its box, the least logit difference in spreads
    (``NO_MATCH`` where none); the largest over the sample.
  * ``peak_miss_share`` (compared): of the reference's peaks whose logit
    lies at least ``MARGIN`` spreads above the least served logit of the
    frame (so well inside the served top-k, whatever the rounding at its
    edge), the share that no served detection of the same class matches
    (box within ``NEAR_PX``, logit within ``WINDOW``), over the sample.
    The two gaps say each served detection is a pixel of the reference's
    maps; this says the served ones are the reference's best.

Each is a largest over the sample, not a quantile: the program's own
errors are bfloat16 rounding, bounded on every detection, and a wrong row
of a batch (one frame in eight) is then one sampled frame's detections.
``checks/centernet.py``'s ``box_gap_px`` and ``score_gap`` are read
beside them, not compared.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cvbench.checks import centernet as peaks
from cvbench.checks.centernet import NO_MATCH, _logit, control  # noqa: F401  (control: the cell's)
from cvbench.reference.decode import decode
from cvbench.reference.model import forward, no_tf32
from cvbench.reference.preprocess import Letterbox, letterbox, preprocess_yuv420

# A served detection's candidates among the reference's pixels: logits within
# WINDOW spreads, boxes within NEAR_PX source pixels. A bfloat16 peak's
# neighbour that rounds above it stands one output pixel (4 input pixels, up
# to 6 source pixels) from the float32 peak, a score rounded to bfloat16 a
# few hundredths of a spread from it.
WINDOW = 1.0
NEAR_PX = 8.0
MARGIN = 1.0        # spreads above the least served logit: a peak that must be served
LOGIT_MAX = float(np.log(1 - 1e-6) - np.log(1e-6))   # the clamp of ``centernet._logit``


def dense_boxes(offset: torch.Tensor, size: torch.Tensor, stride: int,
                lb: Letterbox) -> torch.Tensor:
    """(H*W, 4) [x0, y0, x1, y1] in source pixels: the box each pixel of the
    maps would decode to (``reference/decode.py``'s arithmetic)."""
    _, H, W = offset.shape
    py = torch.arange(H, device=offset.device, dtype=torch.float32)[:, None].expand(H, W)
    px = torch.arange(W, device=offset.device, dtype=torch.float32)[None, :].expand(H, W)
    cx, cy = (px + offset[0].float()) * stride, (py + offset[1].float()) * stride
    bw, bh = size[0].float() * stride, size[1].float() * stride
    sx, sy = lb.w / lb.new_w, lb.h / lb.new_h
    boxes = torch.stack([(cx - bw * 0.5 - lb.x0) * sx, (cy - bh * 0.5 - lb.y0) * sy,
                         (cx + bw * 0.5 - lb.x0) * sx, (cy + bh * 0.5 - lb.y0) * sy], -1)
    return boxes.reshape(H * W, 4)


@torch.no_grad()
def reference_maps(frames: List[dict], weights, cfg: dict, device):
    """Per frame ``(logits (C, H*W) clamped, boxes (H*W, 4), spread,
    letterbox, heads)``: the reference's dense maps, 8 frames a forward."""
    no_tf32()
    out = []
    for i in range(0, len(frames), 8):
        part = frames[i:i + 8]
        xs, lbs = [], []
        for f in part:
            t = {k: torch.from_numpy(f[k][0]).to(device) for k in ("y", "u", "v")}
            h, w = (int(x) for x in f["image_hw"][0])
            xs.append(preprocess_yuv420(t["y"], t["u"], t["v"], h, w, cfg["input_hw"]))
            lbs.append(letterbox(h, w, *cfg["input_hw"]))
        heads = forward(weights, torch.stack(xs), cfg)
        for j, lb in enumerate(lbs):
            hm = heads["heatmap"][j].float()
            C = hm.shape[0]
            out.append((hm.reshape(C, -1).clamp(-LOGIT_MAX, LOGIT_MAX),
                        dense_boxes(heads["offset"][j], heads["size"][j], cfg["stride"], lb),
                        float(hm.std()), lb,
                        {k: heads[k][j] for k in ("heatmap", "offset", "size")}))
    return out


def frame_gaps(served: Dict[str, torch.Tensor], ref, stride: int):
    """One frame's ``(box gaps (K,), score gaps (K,), missed, peaks)``:
    each served detection's two gaps, and how many of the reference's
    peaks ``MARGIN`` spreads inside the served range no served detection
    matches, of how many."""
    logits, boxes, spread, lb, heads = ref
    sb, sc = served["boxes"].float(), served["classes"].long()
    sl = _logit(served["scores"].float())
    z = (sl[:, None] - logits[sc]).abs() / spread                        # (K, H*W)
    d = (sb[:, None, :] - boxes[None, :, :]).abs().amax(-1)              # (K, H*W)
    far = torch.full_like(d, NO_MATCH)
    box_gap = torch.where(z <= WINDOW, d, far).amin(1)
    score_gap = torch.where(d <= NEAR_PX, z, far).amin(1)
    floor = float(sl.min()) + MARGIN * spread
    rb, rs, rc = decode(heads["heatmap"], heads["offset"], heads["size"], stride, 1, lb,
                        float(torch.sigmoid(torch.tensor(floor))))
    keep = _logit(rs) >= floor
    rb, rl, rc = rb[keep], _logit(rs[keep]), rc[keep].long()
    if not len(rl):
        return box_gap, score_gap, 0, 0
    hit = ((rb[:, None, :] - sb[None, :, :]).abs().amax(-1) <= NEAR_PX) \
        & ((rl[:, None] - sl[None, :]).abs() / spread <= WINDOW) & (rc[:, None] == sc[None, :])
    return box_gap, score_gap, int((~hit.any(1)).sum()), len(rl)


def readings(samples, weights, cfg: dict, device) -> Dict[str, float]:
    """The three compared numbers of ``samples`` (frames and their served
    outputs with a batch axis of 1)."""
    served = [{n: torch.as_tensor(np.asarray(out[n])[0], device=device) for n in out}
              for _, out in samples]
    refs = reference_maps([f for f, _ in samples], weights, cfg, device)
    box, score, missed, total = [], [], 0, 0
    for o, ref in zip(served, refs):
        b, s, m, t = frame_gaps(o, ref, cfg["stride"])
        box.append(b)
        score.append(s)
        missed, total = missed + m, total + t
    return {"pixel_box_gap_px": float(torch.cat(box).max()),
            "pixel_score_gap": float(torch.cat(score).max()),
            "peak_miss_share": missed / total if total else 0.0}


def compare(samples, weights, cfg: dict, device) -> Dict[str, float]:
    return {**readings(samples, weights, cfg, device),
            **peaks.compare(samples, weights, cfg, device)}

