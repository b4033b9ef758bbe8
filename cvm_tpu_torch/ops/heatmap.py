"""CenterNet ground-truth rendering: Gaussian heatmap, offset, size, mask.

Mirrors ``cvm_tpu/ops/heatmap.py`` (``gaussian_radius``, ``prepare_centers``,
``CenternetTargets``, ``render_centernet_targets`` and its batch form) with
the batch axis written out. The heatmap comes from a ``splat`` function
with the signature of ``ops.cuda.gaussian_splat.render_heatmap``: its plain
version (the reference's lattice and per-class max) by default, or the
device-dispatching wrapper of kernel K1. Offset, size and mask are plain
scatters at the integer centres.

``extra_values`` (the 3D heads' per-object regressands: depth3d, dims3d,
rot) are scattered densely at the same centres into ``targets.extras``;
K1 renders only the heatmap, as the reference's Pallas splat does.

Where two valid objects share a centre, which one's offset, size and
extras land there is unspecified, as with the reference's ``.at[].set``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from cvm_tpu_torch.ops.cuda.gaussian_splat import render_heatmap_reference


def gaussian_radius(height, width, min_overlap: float = 0.7) -> torch.Tensor:
    """Minimum Gaussian radius keeping IoU >= min_overlap (the three-case
    quadratic bound of CornerNet / Objects as Points), elementwise."""
    h = torch.as_tensor(height, dtype=torch.float32)
    w = torch.as_tensor(width, dtype=torch.float32, device=h.device)

    b1 = h + w
    c1 = w * h * (1.0 - min_overlap) / (1.0 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp_min(b1 * b1 - 4.0 * c1, 0.0))) / 2.0

    b2 = 2.0 * (h + w)
    c2 = (1.0 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp_min(b2 * b2 - 4.0 * 4.0 * c2, 0.0))) / (2.0 * 4.0)

    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (h + w)
    c3 = (min_overlap - 1.0) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3 * b3 - 4.0 * a3 * c3, 0.0))) / (2.0 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


class CenternetTargets(NamedTuple):
    """Batched GT maps (per-image fields without the B axis from
    ``render_centernet_targets``)."""

    heatmap: torch.Tensor  # (B, Hs, Ws, C) in [0, 1]
    offset: torch.Tensor   # (B, Hs, Ws, 2) sub-pixel centre offset at GT centres
    size: torch.Tensor     # (B, Hs, Ws, 2) box (w, h) in output-stride units
    mask: torch.Tensor     # (B, Hs, Ws) 1.0 at GT centres
    indices: torch.Tensor  # (B, K) flat centre index y*Ws+x (0 where invalid)
    valid: torch.Tensor    # (B, K) bool
    # {name: (B, Hs, Ws, C)} per-object regressands scattered at the centres
    # (the 3D targets), None without them.
    extras: Optional[Dict[str, torch.Tensor]] = None


def prepare_centers(boxes: torch.Tensor, valid: torch.Tensor, map_hw: Tuple[int, int],
                    min_overlap: float):
    """boxes (..., K, 4) in output-map coords -> (cx, cy, bw, bh,
    valid & in_bounds, ix, iy, radius, sigma), all (..., K); ix, iy int32."""
    hs, ws = map_hw
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    bw = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0.0)
    bh = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0.0)
    in_bounds = (cx >= 0) & (cx < ws) & (cy >= 0) & (cy < hs) & (bw > 0) & (bh > 0)
    valid = valid & in_bounds
    # NaN (padding) boxes: zero before the int cast, which is undefined on NaN.
    ix = torch.clamp(torch.floor(torch.nan_to_num(cx)), 0, ws - 1).to(torch.int32)
    iy = torch.clamp(torch.floor(torch.nan_to_num(cy)), 0, hs - 1).to(torch.int32)
    radius = torch.floor(torch.clamp_min(gaussian_radius(bh, bw, min_overlap), 0.0))
    sigma = (2.0 * radius + 1.0) / 6.0
    return cx, cy, bw, bh, valid, ix, iy, radius, sigma


Splat = Callable[..., torch.Tensor]


def render_centernet_targets_batch(boxes: torch.Tensor, classes: torch.Tensor,
                                   valid: torch.Tensor, map_hw: Tuple[int, int],
                                   num_classes: int, min_overlap: float = 0.7,
                                   splat: Splat = render_heatmap_reference,
                                   extra_values: Optional[Dict[str, torch.Tensor]] = None
                                   ) -> CenternetTargets:
    """CenterNet GT for a batch.

    boxes   : (B, K, 4) [x0, y0, x1, y1] in output-map (stride-divided) coords.
    classes : (B, K) int class ids in [0, num_classes).
    valid   : (B, K) bool padding mask.
    splat   : the heatmap renderer (``render_heatmap_reference`` or the
              kernel wrapper ``render_heatmap``).
    extra_values : optional {name: (B, K, C)} regressands scattered at the
              integer centres into ``extras`` {name: (B, Hs, Ws, C)}.
    """
    hs, ws = map_hw
    B, K = valid.shape
    cx, cy, bw, bh, valid, ix, iy, radius, sigma = prepare_centers(
        boxes, valid, map_hw, min_overlap)
    heatmap = splat(iy, ix, sigma, radius, classes.to(torch.int32), valid, map_hw,
                    num_classes)

    flat = iy.long() * ws + ix.long()
    flat_or_oob = torch.where(valid, flat, hs * ws)  # row hs*ws is dropped
    bidx = torch.arange(B, device=boxes.device)[:, None].expand(B, K)
    off = torch.stack([cx - ix.float(), cy - iy.float()], -1)
    sz = torch.stack([bw, bh], -1)

    def scatter(values, width):
        out = torch.zeros(B, hs * ws + 1, width, device=boxes.device)
        out[bidx, flat_or_oob] = values
        return out[:, :hs * ws].reshape(B, hs, ws, width)

    offset = scatter(off, 2)
    size = scatter(sz, 2)
    mask = scatter(torch.ones_like(cx)[..., None], 1)[..., 0]
    indices = torch.where(valid, flat, 0)
    extras = None
    if extra_values:
        extras = {k: scatter(v.to(torch.float32), v.shape[-1]) for k, v in extra_values.items()}
    return CenternetTargets(heatmap, offset, size, mask, indices, valid, extras)


def render_centernet_targets(boxes, classes, valid, map_hw, num_classes,
                             min_overlap: float = 0.7,
                             splat: Splat = render_heatmap_reference,
                             extra_values: Optional[Dict[str, torch.Tensor]] = None
                             ) -> CenternetTargets:
    """One image: boxes (K, 4), classes (K,), valid (K,), extra_values
    {name: (K, C)}; fields without the batch axis."""
    t = render_centernet_targets_batch(
        boxes[None], classes[None], valid[None], map_hw, num_classes, min_overlap, splat,
        None if extra_values is None else {k: v[None] for k, v in extra_values.items()})
    extras = None if t.extras is None else {k: v[0] for k, v in t.extras.items()}
    return CenternetTargets(*(f[0] for f in t[:6]), extras)
