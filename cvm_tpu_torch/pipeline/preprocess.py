"""Device-side serving preprocess: planar YUV420 -> letterboxed, normalized
NHWC batch.

Mirrors the eval path of ``cvm_tpu/pipeline/preprocess.py`` (``make_rois``,
``resample_yuv420_frame``, ``preprocess_yuv420_batch``). The training path
(jittered ROIs, photometric jitter) comes with the training slice, so these
functions take no RNG key and no ``train`` flag. The reference's
``_materialize`` (an XLA ``optimization_barrier`` that stops a fusion on the
TPU) has no counterpart: PyTorch runs eagerly and materializes every result.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cvm_tpu_torch.ops.image import (Roi, chroma_roi, letterbox_roi, normalize_pm1,
                                     sample_bilinear, yuv_to_rgb)


def make_rois(image_hw: torch.Tensor, out_hw: Tuple[int, int]) -> Roi:
    """(B, 2) valid sizes -> Roi with (B,) fields: the eval letterbox fit."""
    return letterbox_roi(image_hw[:, 0], image_hw[:, 1], out_hw[0], out_hw[1])


def resample_yuv420_frame(yp, up, vp, hw, roi: Roi, out_hw) -> torch.Tensor:
    """4:2:0 frames -> (B, H, W, 3) RGB floats on 0..255 through ``roi``.

    yp (B, Hm, Wm), up/vp (B, Hm/2, Wm/2) planes; hw (B, 2) valid luma
    sizes. Luma resamples through the ROI, chroma through the half-space ROI,
    so no full-resolution YUV is materialized.
    """
    h, w = hw[:, 0], hw[:, 1]
    croi = chroma_roi(roi)
    yr = sample_bilinear(yp[..., None], roi, out_hw, valid_hw=(h, w), pad_value=0.0)
    ch = (h + 1) // 2
    cw = (w + 1) // 2
    ur = sample_bilinear(up[..., None], croi, out_hw, valid_hw=(ch, cw), pad_value=128.0)
    vr = sample_bilinear(vp[..., None], croi, out_hw, valid_hw=(ch, cw), pad_value=128.0)
    return yuv_to_rgb(yr[..., 0], ur[..., 0], vr[..., 0])


def preprocess_yuv420_batch(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                            image_hw: torch.Tensor, out_hw: Tuple[int, int],
                            out_dtype: torch.dtype = torch.float32
                            ) -> Tuple[torch.Tensor, Roi]:
    """Planar YUV420 batch -> ((B, H, W, 3) pm1 values in ``out_dtype``,
    rois). Runs on the device the planes are on."""
    rois = make_rois(image_hw, out_hw)
    out = resample_yuv420_frame(y, u, v, image_hw, rois, out_hw)
    return normalize_pm1(out).to(out_dtype), rois
