"""Device-side batch preprocess: padded RGB buffers or planar YUV420 ->
letterboxed (eval) or jittered and photometrically augmented (training),
normalized NHWC batch.

Mirrors ``cvm_tpu/pipeline/preprocess.py`` (``AugConfig``,
``aug_from_params``, ``sample_rotation``, ``make_rois``,
``rotate_image_batch``, ``preprocess_image_batch``, ``preprocess_batch``,
``preprocess_yuv420_batch``; ``resample_yuv420_frame`` is in
``ops/image.py``, which the eval kernel's plain version shares). Where the
reference takes a JAX key and a
``train`` flag, these functions take ``draws``: ``None`` for the eval path,
or the ``AugDraws`` of a training batch (``draw_augmentation``), so the
deterministic part can be tested with numbers drawn by ``jax.random``.
The reference's ``_materialize`` (an XLA ``optimization_barrier`` that stops
a fusion on the TPU) has no counterpart: PyTorch runs eagerly and
materializes every result. ``preprocess_with_rois`` and ``resample_labels``
are what the models' processors share: the images through the ROIs (and,
with ``aug_rotate_deg > 0`` in training, rotated by the batch's roll
angles), then each per-pixel label map (class mask, sparse depth) through
the same ROIs, nearest-neighbour, and through the same roll.

Under data parallelism each process holds ``rows`` (a ``BatchRows``) of
the global batch: it draws the numbers of the whole global batch from the
step's generator, which every rank seeds alike, and keeps its rows
(``take_rows``), so that N processes use exactly the draws of one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from cvm_tpu_torch.ops.cuda.yuv_letterbox import yuv_letterbox
from cvm_tpu_torch.ops.image import (PhotoDraws, Roi, RoiDraws, draw_photometric, draw_roi,
                                     jittered_roi, letterbox_roi, normalize_pm1,
                                     photometric_augment, resample_yuv420_frame, rotate_image,
                                     sample_bilinear, sample_nearest)


class AugConfig(NamedTuple):
    scale_range: Tuple[float, float] = (0.6, 1.4)
    shift_frac: float = 0.1
    flip_prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.05
    noise_std: float = 0.0   # max gaussian noise sigma (fraction of 255)
    blur_prob: float = 0.0   # probability of a 3x3 binomial blur
    rotate_deg: float = 0.0  # max |roll| in degrees (0 = rotation pass off)


def aug_from_params(params, flip_prob=None) -> AugConfig:
    """The AugConfig of a model Params object."""
    return AugConfig(
        params.aug_scale_range,
        params.aug_shift_frac,
        params.aug_flip_prob if flip_prob is None else flip_prob,
        noise_std=getattr(params, "aug_noise_std", 0.0),
        blur_prob=getattr(params, "aug_blur_prob", 0.0),
        rotate_deg=getattr(params, "aug_rotate_deg", 0.0),
    )


def sample_rotation(generator: Optional[torch.Generator], batch_size: int,
                    aug: AugConfig) -> Optional[torch.Tensor]:
    """Per-sample roll angles (radians) in [-rotate_deg, rotate_deg], or None
    when rotation is off or there is no generator (eval)."""
    if generator is None or aug.rotate_deg <= 0.0:
        return None
    r = aug.rotate_deg * math.pi / 180.0
    return torch.rand(batch_size, generator=generator, device=generator.device) * (2 * r) - r


def rotate_image_batch(images: torch.Tensor, angles: torch.Tensor, pad_value=0.0,
                       method: str = "bilinear") -> torch.Tensor:
    """``ops.image.rotate_image`` over the batch: image b by angles[b]."""
    return rotate_image(images, angles, pad_value, method)


class BatchRows(NamedTuple):
    """Rows ``start:stop`` of a global batch of ``total`` rows."""

    start: int
    stop: int
    total: int


def take_rows(draws, rows: Optional[BatchRows]):
    """The ``rows`` of a batch's draws (a NamedTuple of (B, ...) tensors,
    None or NamedTuples of them); all of them when ``rows`` is None."""
    if rows is None or draws is None:
        return draws
    if torch.is_tensor(draws):
        return draws[rows.start:rows.stop]
    return type(draws)(*(take_rows(d, rows) for d in draws))


class AugDraws(NamedTuple):
    """Every random number of one training batch's preprocess: the ROI
    jitter, the photometric numbers and the roll angles (radians, (B,);
    None when rotation is off)."""

    roi: RoiDraws
    photo: PhotoDraws
    angle: Optional[torch.Tensor] = None


def draw_rows(draw: Callable[[int], Any], batch_size: int, rows: Optional[BatchRows] = None):
    """``draw(n)``'s numbers for a batch of ``batch_size`` rows: drawn for
    n = ``batch_size``, or, given ``rows``, for the global batch and cut to
    its ``rows``."""
    if rows is None:
        return draw(batch_size)
    if rows.stop - rows.start != batch_size:
        raise ValueError(f"a batch of {batch_size} rows is given as rows "
                         f"{rows.start}:{rows.stop} of {rows.total}")
    return take_rows(draw(rows.total), rows)


def draw_augmentation(generator: torch.Generator, batch_size: int,
                      out_hw: Tuple[int, int], aug: AugConfig,
                      rows: Optional[BatchRows] = None) -> AugDraws:
    """Draw a training batch's ROI jitter, photometric numbers and roll
    angles from ``generator`` (on the device the batch is on); with
    ``rows``, those of the global batch's ``rows``."""
    return draw_rows(lambda n: AugDraws(
        draw_roi(generator, n, aug.scale_range, aug.shift_frac, aug.flip_prob),
        draw_photometric(generator, (n, out_hw[0], out_hw[1], 3), aug.brightness,
                         aug.contrast, aug.saturation, aug.hue, aug.noise_std,
                         aug.blur_prob),
        sample_rotation(generator, n, aug)), batch_size, rows)


def make_rois(image_hw: torch.Tensor, out_hw: Tuple[int, int],
              draws: Optional[RoiDraws] = None) -> Roi:
    """(B, 2) valid sizes -> Roi with (B,) fields: the eval letterbox fit, or
    the training jitter when ``draws`` is given."""
    if draws is None:
        return letterbox_roi(image_hw[:, 0], image_hw[:, 1], out_hw[0], out_hw[1])
    return jittered_roi(image_hw[:, 0], image_hw[:, 1], out_hw[0], out_hw[1], draws)


def _finish(out: torch.Tensor, draws: Optional[AugDraws], out_dtype) -> torch.Tensor:
    if draws is not None:
        out = photometric_augment(out, draws.photo)
    return normalize_pm1(out).to(out_dtype)


def preprocess_image_batch(images: torch.Tensor, image_hw: torch.Tensor,
                           out_hw: Tuple[int, int], out_dtype: torch.dtype = torch.float32,
                           draws: Optional[AugDraws] = None) -> Tuple[torch.Tensor, Roi]:
    """(B, Hmax, Wmax, 3) uint8 + (B, 2) valid sizes -> ((B, H, W, 3) pm1
    values in ``out_dtype``, rois)."""
    rois = make_rois(image_hw, out_hw, None if draws is None else draws.roi)
    out = sample_bilinear(images, rois, out_hw, valid_hw=(image_hw[:, 0], image_hw[:, 1]),
                          pad_value=0.0)
    return _finish(out, draws, out_dtype), rois


def preprocess_batch(batch, out_hw: Tuple[int, int], out_dtype: torch.dtype = torch.float32,
                     draws: Optional[AugDraws] = None) -> Tuple[torch.Tensor, Roi]:
    """Dispatch on the wire format: ``{"image", "image_hw"}`` RGB buffers or
    ``{"y", "u", "v", "image_hw"}`` YUV420 planes."""
    if "y" in batch:
        return preprocess_yuv420_batch(batch["y"], batch["u"], batch["v"], batch["image_hw"],
                                       out_hw, out_dtype, draws)
    return preprocess_image_batch(batch["image"], batch["image_hw"], out_hw, out_dtype, draws)


def preprocess_yuv420_batch(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                            image_hw: torch.Tensor, out_hw: Tuple[int, int],
                            out_dtype: torch.dtype = torch.float32,
                            draws: Optional[AugDraws] = None) -> Tuple[torch.Tensor, Roi]:
    """Planar YUV420 batch -> ((B, H, W, 3) pm1 values in ``out_dtype``,
    rois). Runs on the device the planes are on. The eval letterbox (no
    ``draws``) is the op ``yuv_letterbox`` (``ops/cuda/yuv_letterbox.py``):
    one kernel on the card, the eager ops on the CPU; training draws take
    the eager ops."""
    if draws is None:
        return yuv_letterbox(y, u, v, image_hw, out_hw, out_dtype)
    rois = make_rois(image_hw, out_hw, draws.roi)
    out = resample_yuv420_frame(y, u, v, image_hw, rois, out_hw)
    return _finish(out, draws, out_dtype), rois


def preprocess_with_rois(params, train: bool, generator: Optional[torch.Generator], batch,
                         draws: Optional[AugDraws], rows: Optional[BatchRows] = None):
    """The image half of every model's processor: (inputs, rois, angles)
    through the eval letterbox or, with ``train``, the training jitter,
    photometric augmentation and (``aug_rotate_deg > 0``) the roll by
    ``angles`` (None when there is none), its numbers ``draws`` when given,
    else drawn from ``generator`` (for the global batch's ``rows`` when
    given). The caller rolls its labels with the same angles."""
    if train and draws is None:
        draws = draw_augmentation(generator, batch["image_hw"].shape[0], params.input_hw,
                                  aug_from_params(params), rows)
    images, rois = preprocess_batch(batch, params.input_hw, draws=draws if train else None)
    angles = draws.angle if train else None
    if angles is not None:
        images = rotate_image_batch(images, angles)
    return images, rois, angles


def rotate_labels(labels: torch.Tensor, angles: Optional[torch.Tensor], pad_value):
    """A per-pixel label map rolled with the image (nearest, ``pad_value``
    where it rotates in from outside); as it is when ``angles`` is None."""
    if angles is None:
        return labels
    return rotate_image_batch(labels, angles, pad_value=pad_value, method="nearest")


def resample_labels(batch, key: str, rois, out_hw, pad_value) -> torch.Tensor:
    """A per-pixel label map of ``batch`` (mask or depth) through the
    image's ROIs, nearest-neighbour, clamped to each image's valid extent."""
    hw = batch["image_hw"]
    src = batch[key].to(torch.int32) if key == "mask" else batch[key]
    return sample_nearest(src, rois, out_hw, valid_hw=(hw[:, 0], hw[:, 1]),
                          pad_value=pad_value)
