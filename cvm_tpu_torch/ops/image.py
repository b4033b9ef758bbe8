"""Device-side image resampling: letterbox, training jitter, YUV->RGB, box
mapping, photometric augmentation.

Mirrors ``cvm_tpu/ops/image.py`` (``Roi``, ``full_roi``, ``letterbox_roi``,
``jittered_roi``, ``_axis_coords``, ``sample_bilinear``, ``sample_nearest``,
``letterbox``, ``yuv_to_rgb``, ``chroma_roi``, ``normalize_pm1``,
``resample_yuv420_frame`` (from ``cvm_tpu/pipeline/preprocess.py``),
``normalize_imagenet``, ``map_points_to_input``, ``map_boxes_to_input``,
``map_points_to_output``, ``map_boxes_to_output``, ``clip_boxes``,
``rotate_points``, ``rotate_boxes``, ``rotate_image``,
``photometric_augment``) with the same geometry: cv2
INTER_LINEAR half-pixel centres,

    src = (dst + 0.5) * (src_extent / dst_extent) - 0.5 + src_origin,

and border-replicate clamping to the valid extent of a host-padded buffer.

The reference writes each function for one image and ``vmap``s it; here the
batch axis is written out. ``Roi`` fields are float32 tensors of one shape
(``()`` for one image, ``(B,)`` for a batch) and images are (B, H, W, C).

Each random augmentation is split into its *draws* (``draw_roi``,
``draw_photometric``: every random number it uses, drawn from an explicit
``torch.Generator`` on the batch's device) and a deterministic core
(``jittered_roi``, ``photometric_augment``) that takes them. JAX's random
streams cannot be reproduced in torch; the split lets a test feed the core
the numbers ``jax.random`` drew.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Roi(NamedTuple):
    """A source-image region mapped onto an output-canvas region (see the
    reference for the field meanings). ``flip_x`` mirrors horizontally."""

    src_y0: torch.Tensor
    src_x0: torch.Tensor
    src_h: torch.Tensor
    src_w: torch.Tensor
    dst_y0: torch.Tensor
    dst_x0: torch.Tensor
    dst_h: torch.Tensor
    dst_w: torch.Tensor
    flip_x: torch.Tensor

    @property
    def scale_y(self):
        return self.dst_h / self.src_h

    @property
    def scale_x(self):
        return self.dst_w / self.src_w


def _scalar(value, dtype: torch.dtype):
    """``value`` as a Python number of ``dtype``'s values (a pad value for
    ``torch.where``, which then keeps ``dtype``): no device tensor, so no
    host-to-device copy."""
    return torch.tensor(value, dtype=dtype).item()


def _f(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def full_roi(h, w, out_h: int, out_w: int) -> Roi:
    """ROI for a plain (aspect-distorting) resize of the whole image."""
    h = _f(h, h)
    w = _f(w, h)
    z = torch.zeros_like(h)
    return Roi(z, z, h, w, z, z, torch.full_like(h, out_h),
               torch.full_like(h, out_w), torch.zeros_like(h, dtype=torch.bool))


def letterbox_roi(h, w, out_h: int, out_w: int, flip_x=False) -> Roi:
    """Aspect-preserving fit of an (h, w) image into an (out_h, out_w)
    canvas: scale = min(out/in), centred, with pad bars."""
    h = _f(h, h)
    w = _f(w, h)
    scale = torch.minimum(out_h / h, out_w / w)
    new_h = torch.round(h * scale)  # half to even, as jnp.round
    new_w = torch.round(w * scale)
    dst_y0 = torch.floor((out_h - new_h) * 0.5)
    dst_x0 = torch.floor((out_w - new_w) * 0.5)
    z = torch.zeros_like(h)
    flip = torch.full_like(h, bool(flip_x), dtype=torch.bool)
    return Roi(z, z, h, w, dst_y0, dst_x0, new_h, new_w, flip)


class RoiDraws(NamedTuple):
    """The random numbers of ``jittered_roi``, each (B,): ``zoom`` in
    ``scale_range``, ``shift_y``/``shift_x`` in [-shift_frac, shift_frac]
    (fractions of the image size), ``flip`` bool."""

    zoom: torch.Tensor
    shift_y: torch.Tensor
    shift_x: torch.Tensor
    flip: torch.Tensor


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_roi(generator: torch.Generator, batch_size: int,
             scale_range: Tuple[float, float] = (0.6, 1.4), shift_frac: float = 0.1,
             flip_prob: float = 0.5) -> RoiDraws:
    """Draw ``jittered_roi``'s zoom, shifts and flip for a batch."""
    zoom = _uniform(generator, batch_size, scale_range[0], scale_range[1])
    sy = _uniform(generator, batch_size, -shift_frac, shift_frac)
    sx = _uniform(generator, batch_size, -shift_frac, shift_frac)
    flip = torch.rand(batch_size, generator=generator, device=generator.device) < flip_prob
    return RoiDraws(zoom, sy, sx, flip)


def jittered_roi(h, w, out_h: int, out_w: int, draws: RoiDraws) -> Roi:
    """Zoom/shift/flip ROI for training augmentation (the deterministic core
    of the reference's ``jittered_roi``): a window of the output's aspect
    ratio, ``1/zoom`` times the fit size, centred at the image centre
    shifted by ``shift * size``."""
    h = _f(h, h)
    w = _f(w, h)
    base = torch.minimum(h / out_h, w / out_w)  # src px per dst px at fit
    src_h = out_h * base / draws.zoom
    src_w = out_w * base / draws.zoom
    cy = h * 0.5 + draws.shift_y * h
    cx = w * 0.5 + draws.shift_x * w
    z = torch.zeros_like(h)
    return Roi(cy - src_h * 0.5, cx - src_w * 0.5, src_h, src_w, z, z,
               torch.full_like(h, out_h), torch.full_like(h, out_w), draws.flip)


def _axis_coords(out_size: int, dst0, dst_len, src0, src_len, valid_hi, flip=None):
    """Per-axis bilinear gather plan (idx_lo, idx_hi, frac, in_dst_window),
    each of shape ``dst0.shape + (out_size,)``."""
    i = torch.arange(out_size, dtype=torch.float32, device=dst0.device)
    dst0, dst_len, src0, src_len = (v[..., None] for v in (dst0, dst_len, src0, src_len))
    t = (i - dst0 + 0.5) / dst_len  # 0..1 across the dst window
    if flip is not None:
        t = torch.where(flip[..., None], 1.0 - t, t)
    src = t * src_len - 0.5 + src0
    lo = torch.floor(src)
    frac = src - lo
    lo_i = lo.to(torch.int64)
    if torch.is_tensor(valid_hi):
        hi = torch.clamp_min(valid_hi.to(dst0.device) - 1, 0)[..., None]
    else:  # a Python extent: filled on the device, no host-to-device copy
        hi = torch.full((1,), max(int(valid_hi) - 1, 0), dtype=torch.int64, device=dst0.device)
    idx_lo = torch.minimum(torch.clamp_min(lo_i, 0), hi)
    idx_hi = torch.minimum(torch.clamp_min(lo_i + 1, 0), hi)
    inside = (i >= dst0) & (i < dst0 + dst_len)
    return idx_lo, idx_hi, frac, inside


def sample_bilinear(image: torch.Tensor, roi: Roi, out_hw: Tuple[int, int],
                    valid_hw=None, pad_value: float = 0.0) -> torch.Tensor:
    """Separable bilinear resample of a batch through per-image ROIs.

    image    : (B, H, W, C) any dtype; computed in float32.
    roi      : Roi with (B,) fields.
    valid_hw : (h, w), each a (B,) tensor, the valid extent of host-padded
               buffers (defaults to the full shape). Samples clamp to it, so
               pad garbage is never read.
    returns  : (B, out_h, out_w, C) float32.
    """
    out_h, out_w = out_hw
    B, H, W, C = image.shape
    vh, vw = (H, W) if valid_hw is None else valid_hw
    ylo, yhi, fy, in_y = _axis_coords(out_h, roi.dst_y0, roi.dst_h, roi.src_y0,
                                      roi.src_h, vh)
    xlo, xhi, fx, in_x = _axis_coords(out_w, roi.dst_x0, roi.dst_w, roi.src_x0,
                                      roi.src_w, vw, flip=roi.flip_x)
    # Rows first, gathered in the source dtype and converted afterwards
    # (indexing commutes with conversion; a uint8 source is read at 1 B/px).
    b = torch.arange(B, device=image.device)[:, None]
    rows_lo = image[b, ylo].to(torch.float32)  # (B, out_h, W, C)
    rows_hi = image[b, yhi].to(torch.float32)
    rows = rows_lo + (rows_hi - rows_lo) * fy[:, :, None, None]
    shape = (B, out_h, out_w, C)
    cols_lo = torch.gather(rows, 2, xlo[:, None, :, None].expand(shape))
    cols_hi = torch.gather(rows, 2, xhi[:, None, :, None].expand(shape))
    out = cols_lo + (cols_hi - cols_lo) * fx[:, None, :, None]
    inside = in_y[:, :, None] & in_x[:, None, :]
    return torch.where(inside[..., None], out, float(pad_value))


def sample_nearest(image: torch.Tensor, roi: Roi, out_hw: Tuple[int, int],
                   valid_hw=None, pad_value=0) -> torch.Tensor:
    """Nearest-neighbour resample of a batch through per-image ROIs (class
    masks, sparse depth): the bilinear plan's lower neighbour where its
    fraction is strictly below 0.5, else the upper one, so a mask's geometry
    matches the image's. Keeps ``image``'s dtype.

    image : (B, H, W) or (B, H, W, C); returns (B, out_h, out_w[, C]).
    """
    out_h, out_w = out_hw
    B, H, W = image.shape[:3]
    vh, vw = (H, W) if valid_hw is None else valid_hw
    ylo, yhi, fy, in_y = _axis_coords(out_h, roi.dst_y0, roi.dst_h, roi.src_y0,
                                      roi.src_h, vh)
    xlo, xhi, fx, in_x = _axis_coords(out_w, roi.dst_x0, roi.dst_w, roi.src_x0,
                                      roi.src_w, vw, flip=roi.flip_x)
    yi = torch.where(fy < 0.5, ylo, yhi)
    xi = torch.where(fx < 0.5, xlo, xhi)
    b = torch.arange(B, device=image.device)[:, None, None]
    out = image[b, yi[:, :, None], xi[:, None, :]]
    inside = in_y[:, :, None] & in_x[:, None, :]
    if out.dim() == 4:
        inside = inside[..., None]
    return torch.where(inside, out, _scalar(pad_value, image.dtype))


def letterbox(image: torch.Tensor, h, w, out_hw: Tuple[int, int],
              pad_value: float = 0.0) -> Tuple[torch.Tensor, Roi]:
    """Letterbox-resize padded buffers (B, H, W, C) whose valid extents are
    ``h``, ``w`` ((B,) each). Returns (image, roi)."""
    roi = letterbox_roi(h, w, out_hw[0], out_hw[1])
    return sample_bilinear(image, roi, out_hw, valid_hw=(h, w), pad_value=pad_value), roi


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-range JFIF YCbCr -> RGB (libjpeg's colour convert); y/u/v are
    (..., H, W) float planes on 0..255 with chroma at luma resolution."""
    cb = u - 128.0
    cr = v - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def chroma_roi(roi: Roi) -> Roi:
    """A luma-space Roi in 4:2:0 chroma-plane coordinates (JFIF centred
    siting: the half-pixel algebra reduces to halving the source window)."""
    return roi._replace(src_y0=roi.src_y0 * 0.5, src_x0=roi.src_x0 * 0.5,
                        src_h=roi.src_h * 0.5, src_w=roi.src_w * 0.5)


def resample_yuv420_frame(yp, up, vp, hw, roi: Roi, out_hw) -> torch.Tensor:
    """4:2:0 frames -> (B, H, W, 3) RGB floats on 0..255 through ``roi``.

    yp (B, Hm, Wm), up/vp (B, Hm/2, Wm/2) planes; hw (B, 2) valid luma
    sizes. Luma resamples through the ROI, chroma through the half-space
    ROI, so no full-resolution YUV is materialized.
    """
    h, w = hw[:, 0], hw[:, 1]
    croi = chroma_roi(roi)
    yr = sample_bilinear(yp[..., None], roi, out_hw, valid_hw=(h, w), pad_value=0.0)
    ch = (h + 1) // 2
    cw = (w + 1) // 2
    ur = sample_bilinear(up[..., None], croi, out_hw, valid_hw=(ch, cw), pad_value=128.0)
    vr = sample_bilinear(vp[..., None], croi, out_hw, valid_hw=(ch, cw), pad_value=128.0)
    return yuv_to_rgb(yr[..., 0], ur[..., 0], vr[..., 0])


IMAGENET_MEAN = (0.485 * 255.0, 0.456 * 255.0, 0.406 * 255.0)
IMAGENET_STD = (0.229 * 255.0, 0.224 * 255.0, 0.225 * 255.0)


def normalize_imagenet(image: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std with ImageNet statistics on the 0..255 scale."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=image.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=image.device)
    return (image.to(torch.float32) - mean) / std


def normalize_pm1(image: torch.Tensor) -> torch.Tensor:
    """Scale 0..255 -> [-1, 1]."""
    return image.to(torch.float32) / 127.5 - 1.0


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Give a Roi field trailing unit dims so it broadcasts against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def map_points_to_output(points: torch.Tensor, roi: Roi) -> torch.Tensor:
    """(..., 2) [x, y] source-image points through ``roi`` onto the output
    canvas, mirrored around the dst window where ``roi.flip_x``."""
    x, y = points[..., 0], points[..., 1]
    xo = (x - _bc(roi.src_x0, x)) * _bc(roi.scale_x, x) + _bc(roi.dst_x0, x)
    yo = (y - _bc(roi.src_y0, y)) * _bc(roi.scale_y, y) + _bc(roi.dst_y0, y)
    xflip = 2.0 * _bc(roi.dst_x0, x) + _bc(roi.dst_w, x) - xo
    xo = torch.where(_bc(roi.flip_x, x), xflip, xo)
    return torch.stack([xo, yo], dim=-1)


def map_boxes_to_output(boxes: torch.Tensor, roi: Roi) -> torch.Tensor:
    """(..., 4) [x0, y0, x1, y1] boxes through ``roi`` (handles flip)."""
    p0 = map_points_to_output(boxes[..., 0:2], roi)
    p1 = map_points_to_output(boxes[..., 2:4], roi)
    return torch.stack([torch.minimum(p0[..., 0], p1[..., 0]),
                        torch.minimum(p0[..., 1], p1[..., 1]),
                        torch.maximum(p0[..., 0], p1[..., 0]),
                        torch.maximum(p0[..., 1], p1[..., 1])], dim=-1)


def clip_boxes(boxes: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Clip (..., 4) [x0, y0, x1, y1] boxes to the canvas [0, W) x [0, H)."""
    h, w = out_hw
    x = torch.clamp(boxes[..., 0::2], 0.0, float(w - 1))
    y = torch.clamp(boxes[..., 1::2], 0.0, float(h - 1))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def rotate_points(points: torch.Tensor, angle, center_xy) -> torch.Tensor:
    """Rotate (..., 2) [x, y] points by ``angle`` (radians, counter-clockwise
    in image coordinates: p -> R(angle)(p - c) + c) about ``center_xy``.
    A tensor ``angle`` of shape (B,) rotates the points of row b by
    angle[b]."""
    angle = torch.as_tensor(angle, dtype=torch.float32, device=points.device)
    angle = angle.reshape(angle.shape + (1,) * (points.dim() - 1 - angle.dim()))
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[..., 0] - center_xy[0]
    y = points[..., 1] - center_xy[1]
    return torch.stack([c * x - s * y + center_xy[0], s * x + c * y + center_xy[1]], -1)


def rotate_boxes(boxes: torch.Tensor, angle, center_xy) -> torch.Tensor:
    """The axis-aligned box of the rotated corners of (..., 4) [x0, y0, x1,
    y1] boxes (the label transform of rotation augmentation)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    corners = torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
                           torch.stack([x0, y1], -1), torch.stack([x1, y1], -1)], -2)
    r = rotate_points(corners, angle, center_xy)
    return torch.cat([r.amin(-2), r.amax(-2)], -1)


def rotate_image(image: torch.Tensor, angle: torch.Tensor, pad_value=0.0,
                 method: str = "bilinear") -> torch.Tensor:
    """Rotate each image of (B, H, W[, C]) by its angle[b] ((B,) radians)
    about the image centre, as ``rotate_points`` maps points; pixels from
    outside the frame are ``pad_value``. ``method="nearest"`` keeps the
    input dtype (masks, class ids, sparse depth); bilinear returns the input
    dtype for floats, else float32."""
    B, H, W = image.shape[:3]
    dev = image.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    angle = angle.to(device=dev, dtype=torch.float32).reshape(B, 1, 1)
    c, s = torch.cos(angle), torch.sin(angle)
    dx, dy = xx - cx, yy - cy
    # The inverse map: output pixel dst shows the input at R(-angle)(dst - c) + c.
    sxf = c * dx + s * dy + cx
    syf = -s * dx + c * dy + cy
    inside = (sxf >= -0.5) & (sxf <= W - 0.5) & (syf >= -0.5) & (syf <= H - 0.5)
    b = torch.arange(B, device=dev)[:, None, None]
    if method == "nearest":
        si = torch.round(syf).to(torch.int64).clamp(0, H - 1)
        sj = torch.round(sxf).to(torch.int64).clamp(0, W - 1)
        out = image[b, si, sj]
        mask = inside if out.dim() == 3 else inside[..., None]
        return torch.where(mask, out, _scalar(pad_value, image.dtype))
    img = image.to(torch.float32)
    ylo, xlo = torch.floor(syf), torch.floor(sxf)
    fy, fx = syf - ylo, sxf - xlo
    y0 = ylo.to(torch.int64).clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x0 = xlo.to(torch.int64).clamp(0, W - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    a, bb = img[b, y0, x0], img[b, y0, x1]
    cc, d = img[b, y1, x0], img[b, y1, x1]
    if img.dim() == 4:
        fy, fx, inside = fy[..., None], fx[..., None], inside[..., None]
    top = a + (bb - a) * fx
    bot = cc + (d - cc) * fx
    out = torch.where(inside, top + (bot - top) * fy, float(pad_value))
    return out.to(image.dtype) if image.is_floating_point() else out


def map_points_to_input(points: torch.Tensor, roi: Roi) -> torch.Tensor:
    """(..., 2) [x, y] output-canvas points -> source-image coords (no flip:
    inference ROIs do not flip). Roi fields broadcast over the leading axes."""
    x, y = points[..., 0], points[..., 1]
    xi = (x - _bc(roi.dst_x0, x)) / _bc(roi.scale_x, x) + _bc(roi.src_x0, x)
    yi = (y - _bc(roi.dst_y0, y)) / _bc(roi.scale_y, y) + _bc(roi.src_y0, y)
    return torch.stack([xi, yi], dim=-1)


def map_boxes_to_input(boxes: torch.Tensor, roi: Roi) -> torch.Tensor:
    """(..., 4) [x0, y0, x1, y1] boxes from the output canvas to the source."""
    p0 = map_points_to_input(boxes[..., 0:2], roi)
    p1 = map_points_to_input(boxes[..., 2:4], roi)
    return torch.cat([p0, p1], dim=-1)


class PhotoDraws(NamedTuple):
    """The random numbers of ``photometric_augment``, each (B,) unless
    noted: ``brightness`` in [-brightness, brightness] (a fraction of 255),
    ``contrast``, ``saturation``, ``hue`` in their +- ranges; ``noise_sigma``
    in [0, noise_std * 255] and ``noise`` (B, H, W, 3) standard normal, or
    both None when noise is off; ``blur`` bool, or None when blur is off."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    noise_sigma: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    blur: Optional[torch.Tensor] = None


def draw_photometric(generator: torch.Generator, image_shape: Tuple[int, int, int, int],
                     brightness: float = 0.2, contrast: float = 0.2,
                     saturation: float = 0.2, hue: float = 0.05, noise_std: float = 0.0,
                     blur_prob: float = 0.0) -> PhotoDraws:
    """Draw ``photometric_augment``'s numbers for a (B, H, W, 3) batch."""
    B = image_shape[0]
    d = PhotoDraws(_uniform(generator, B, -brightness, brightness),
                   _uniform(generator, B, -contrast, contrast),
                   _uniform(generator, B, -saturation, saturation),
                   _uniform(generator, B, -hue, hue))
    if noise_std > 0.0:
        d = d._replace(noise_sigma=_uniform(generator, B, 0.0, noise_std * 255.0),
                       noise=torch.randn(image_shape, generator=generator,
                                         device=generator.device))
    if blur_prob > 0.0:
        d = d._replace(blur=torch.rand(B, generator=generator,
                                       device=generator.device) < blur_prob)
    return d


def photometric_augment(image: torch.Tensor, draws: PhotoDraws) -> torch.Tensor:
    """Brightness, contrast, saturation and hue jitter (hue as an RGB
    channel-rotation blend), then optional gaussian noise and 3x3 binomial
    blur, on a (B, H, W, 3) 0..255 float batch; clipped to [0, 255]."""
    def per_image(v):
        return v.reshape(-1, 1, 1, 1)

    img = image.to(torch.float32)
    img = img + per_image(draws.brightness * 255.0)
    img = (img - 127.5) * per_image(1.0 + draws.contrast) + 127.5
    gray = 0.299 * img[..., 0:1] + 0.587 * img[..., 1:2] + 0.114 * img[..., 2:3]
    img = gray + (img - gray) * per_image(1.0 + draws.saturation)
    h = per_image(torch.abs(draws.hue))
    img = img * (1.0 - h) + torch.roll(img, 1, dims=-1) * h
    if draws.noise is not None:
        img = img + per_image(draws.noise_sigma) * draws.noise
    if draws.blur is not None:
        x = torch.cat([img[:, :1], img, img[:, -1:]], dim=1)   # edge pad
        x = x[:, :-2] * 0.25 + x[:, 1:-1] * 0.5 + x[:, 2:] * 0.25
        x = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
        x = x[:, :, :-2] * 0.25 + x[:, :, 1:-1] * 0.5 + x[:, :, 2:] * 0.25
        img = torch.where(per_image(draws.blur), x, img)
    return torch.clamp(img, 0.0, 255.0)
