"""The serving preprocess, plain: planar YUV420 frames letterboxed into the
model input, bilinear with half-pixel centres, in float32.

Written for the benchmark from the geometry the models serve with (OpenCV's
INTER_LINEAR convention, border-replicate clamping to each frame's valid
extent inside its padded buffer, JFIF full-range YCbCr):

  scale = min(out_h / h, out_w / w); new = round_half_even(size * scale);
  dst0 = floor((out - new) / 2);  src = (dst - dst0 + 0.5) * size / new - 0.5

Chroma (4:2:0, centred siting) samples the same window halved, with a valid
extent of ceil(size / 2). Outside the letterboxed window luma is 0 and chroma
128. The result is scaled to [-1, 1].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Letterbox(NamedTuple):
    """Per frame: the window the source fills in the model input."""

    y0: float
    x0: float
    new_h: float
    new_w: float
    h: float
    w: float


def letterbox(h: int, w: int, out_h: int, out_w: int) -> Letterbox:
    """The letterbox window of an (h, w) frame, in float32 arithmetic."""
    hf = torch.tensor(float(h), dtype=torch.float32)
    wf = torch.tensor(float(w), dtype=torch.float32)
    scale = torch.minimum(out_h / hf, out_w / wf)
    new_h, new_w = torch.round(hf * scale), torch.round(wf * scale)
    y0 = torch.floor((out_h - new_h) * 0.5)
    x0 = torch.floor((out_w - new_w) * 0.5)
    return Letterbox(float(y0), float(x0), float(new_h), float(new_w), float(h), float(w))


def _axis(n_out: int, dst0: float, dst_len: float, src_len: float, valid: int, device):
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    src = (i - dst0 + 0.5) / dst_len * src_len - 0.5
    lo = torch.floor(src)
    frac = src - lo
    lo = lo.long()
    i0 = lo.clamp(0, valid - 1)
    i1 = (lo + 1).clamp(0, valid - 1)
    inside = (i >= dst0) & (i < dst0 + dst_len)
    return i0, i1, frac, inside


def resample(plane: torch.Tensor, lb: Letterbox, half: bool, out_hw, pad: float):
    """One (H, W) uint8 plane through the letterbox -> (out_h, out_w) float32."""
    div = 2.0 if half else 1.0
    vh = int(-(-int(lb.h) // 2)) if half else int(lb.h)
    vw = int(-(-int(lb.w) // 2)) if half else int(lb.w)
    y0, y1, fy, iny = _axis(out_hw[0], lb.y0, lb.new_h, lb.h / div, vh, plane.device)
    x0, x1, fx, inx = _axis(out_hw[1], lb.x0, lb.new_w, lb.w / div, vw, plane.device)
    p = plane.float()
    rows = p[y0] + (p[y1] - p[y0]) * fy[:, None]
    out = rows[:, x0] + (rows[:, x1] - rows[:, x0]) * fx[None, :]
    inside = iny[:, None] & inx[None, :]
    return torch.where(inside, out, torch.full_like(out, pad))


def preprocess_yuv420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, h: int, w: int,
                      out_hw) -> torch.Tensor:
    """One frame's planes (y (Hm, Wm), u/v (Hm/2, Wm/2) uint8) of valid size
    (h, w) -> the (3, out_h, out_w) model input in [-1, 1], float32."""
    lb = letterbox(h, w, *out_hw)
    yy = resample(y, lb, False, out_hw, 0.0)
    cb = resample(u, lb, True, out_hw, 128.0) - 128.0
    cr = resample(v, lb, True, out_hw, 128.0) - 128.0
    rgb = torch.stack([yy + 1.402 * cr, yy - 0.344136 * cb - 0.714136 * cr, yy + 1.772 * cb])
    return rgb.clamp(0.0, 255.0) / 127.5 - 1.0
