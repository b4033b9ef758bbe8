"""Differentiable projective warping for depth from motion (DMDS).

Mirrors ``cvm_tpu/ops/warp.py`` (``WarpResult``, ``euler_to_matrix``,
``scale_intrinsics``, ``bilinear_sample``, ``warp_frame``): back-project
each pixel with its depth and the camera intrinsics, move it rigidly by the
predicted ego-motion plus an optional per-pixel residual translation,
re-project, and sample the other frame bilinearly. The sampler is the
reference's 4-tap gather on the flattened image, so it agrees with the
reference's ``method="gather"`` to float rounding (``F.grid_sample``
normalises coordinates to [-1, 1] and back, which rounds differently).

The reference's TPU sampler, ``bilinear_sample_mxu`` (the gather recast as
two dense matrix products, because per-element gathers lower badly on the
TPU), is not ported: a GPU gathers natively. ``method`` takes ``"auto"``
and ``"gather"``; ``"mxu"`` raises.

Intrinsics travel as (fx, fy, cx, cy) and must be rescaled through the
image's ROI (``scale_intrinsics``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class WarpResult(NamedTuple):
    warped: torch.Tensor        # (B, H, W, C) frame sampled at projected coords
    valid: torch.Tensor         # (B, H, W, 1) 1.0 where the projection lands in frame
    warped_depth: torch.Tensor  # (B, H, W, 1) z-depth of the transformed points
    coords: torch.Tensor        # (B, H, W, 2) projected (x, y) pixel coords


def euler_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) euler angles (rx, ry, rz) -> (..., 3, 3) rotation Rz Ry Rx."""
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    o, z = torch.ones_like(rx), torch.zeros_like(rx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat([(o, z, z), (z, cx, -sx), (z, sx, cx)])
    Ry = mat([(cy, z, sy), (z, o, z), (-sy, z, cy)])
    Rz = mat([(cz, -sz, z), (sz, cz, z), (z, z, o)])
    return Rz @ Ry @ Rx


def scale_intrinsics(intrinsics: torch.Tensor, roi) -> torch.Tensor:
    """Map (..., 4) [fx, fy, cx, cy] through a resampling ``Roi`` (fields
    broadcast against the leading axes): x' = (x - src_x0) sx + dst_x0, so
    fx' = fx sx and cx' = (cx - src_x0) sx + dst_x0. A flipped ROI is not
    supported (DMDS never flips; 3D serving letterboxes)."""
    fx, fy, cx, cy = (intrinsics[..., i] for i in range(4))
    sx, sy = roi.scale_x, roi.scale_y
    return torch.stack([fx * sx, fy * sy, (cx - roi.src_x0) * sx + roi.dst_x0,
                        (cy - roi.src_y0) * sy + roi.dst_y0], dim=-1)


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (B, H, W, C) ``image`` at (B, ..., 2) float (x, y) ``coords``
    -> (samples (B, ..., C), in_bounds (B, ..., 1) float). Out-of-frame
    samples are clamped to the border and flagged 0: the reference's
    ``bilinear_sample`` vmapped over the batch."""
    B, H, W, C = image.shape
    x, y = coords[..., 0], coords[..., 1]
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    x0i, y0i = torch.clamp(x0i, 0, W - 1), torch.clamp(y0i, 0, H - 1)
    flat = image.reshape(B, H * W, C)
    lead = x.shape[1:]

    def g(yi, xi):
        idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, *lead, C)

    tl, tr, bl, br = g(y0i, x0i), g(y0i, x1i), g(y1i, x0i), g(y1i, x1i)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    return top + (bot - top) * fy, inb[..., None].to(torch.float32)


def warp_frame(source: torch.Tensor, depth: torch.Tensor, rotation: torch.Tensor,
               translation: torch.Tensor, intrinsics: torch.Tensor,
               residual_translation: Optional[torch.Tensor] = None,
               method: str = "auto") -> WarpResult:
    """Warp ``source`` (frame t+1) into frame t's geometry.

    source (B, H, W, C); depth (B, H, W, 1) of frame t; rotation (B, 3)
    euler angles and translation (B, 3), the camera motion t -> t+1;
    intrinsics (B, 4) [fx, fy, cx, cy] in resized-frame pixels;
    residual_translation optional (B, H, W, 3) per-pixel object motion.
    """
    if method not in ("auto", "gather"):
        raise ValueError(f"warp method must be auto|gather, got {method!r} (the TPU's "
                         "matrix-product sampler 'mxu' is not ported)")
    B, H, W, _ = depth.shape
    fx, fy, cx, cy = (intrinsics[:, i].reshape(B, 1, 1) for i in range(4))
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)[None, :, None]
    d = depth[..., 0]
    P = torch.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d], dim=-1)  # (B, H, W, 3)
    R = euler_to_matrix(rotation)
    Pt = torch.einsum("bij,bhwj->bhwi", R, P) + translation[:, None, None, :]
    if residual_translation is not None:
        Pt = Pt + residual_translation
    z = torch.clamp_min(Pt[..., 2], 1e-3)
    u = Pt[..., 0] / z * fx + cx
    v = Pt[..., 1] / z * fy + cy
    coords = torch.stack([u, v], dim=-1)
    warped, inb = bilinear_sample(source, coords)
    front = (Pt[..., 2:3] > 1e-3).to(torch.float32)
    return WarpResult(warped, inb * front, z[..., None], coords)
