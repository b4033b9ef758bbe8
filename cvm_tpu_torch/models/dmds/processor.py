"""DMDS processor: two frames + intrinsics -> stacked input + loss targets.

Mirrors ``cvm_tpu/models/dmds/processor.py::make_processor``: both frames
(RGB buffers ``image`` / ``image_t1``, or 4:2:0 planes ``y/u/v`` /
``y_t1/u_t1/v_t1``) resample through one shared ROI (the eval letterbox,
or the training zoom and shift; never a flip, which would mirror the
motion field, and no photometric jitter), and the intrinsics go through
the same ROI (``ops/warp.py::scale_intrinsics``). The model input is the
[0, 1] frame pair mapped to [-1, 1]; the targets are the [0, 1] pair and
the scaled intrinsics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cvm_tpu_torch.models.dmds.params import DmdsParams
from cvm_tpu_torch.ops.image import RoiDraws, draw_roi, sample_bilinear
from cvm_tpu_torch.ops.warp import scale_intrinsics
from cvm_tpu_torch.pipeline.preprocess import (BatchRows, draw_rows, make_rois,
                                               resample_yuv420_frame)


def make_processor(params: DmdsParams, train: bool) -> Callable[..., Tuple]:
    """Returns ``process(generator, batch, draws=None, rows=None) -> (inputs
    (B, H, W, 6), {"frames": (B, H, W, 6) in [0, 1], "intrinsics": (B,
    4)})``. In
    training the ROI jitter is ``draws`` (a ``RoiDraws``) when given, else
    drawn from ``generator`` (for the global batch's ``rows`` when given);
    eval takes neither."""
    out_hw = params.input_hw

    def process(generator: Optional[torch.Generator], batch,
                draws: Optional[RoiDraws] = None, rows: Optional[BatchRows] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        hw = batch["image_hw"]
        if train and draws is None:
            draws = draw_rows(lambda n: draw_roi(generator, n, params.aug_scale_range,
                                                 params.aug_shift_frac, flip_prob=0.0),
                              hw.shape[0], rows)
        rois = make_rois(hw, out_hw, draws if train else None)
        if "y" in batch:
            a = resample_yuv420_frame(batch["y"], batch["u"], batch["v"], hw, rois, out_hw)
            b = resample_yuv420_frame(batch["y_t1"], batch["u_t1"], batch["v_t1"], hw, rois,
                                      out_hw)
        else:
            valid = (hw[:, 0], hw[:, 1])
            a = sample_bilinear(batch["image"], rois, out_hw, valid_hw=valid)
            b = sample_bilinear(batch["image_t1"], rois, out_hw, valid_hw=valid)
        frames01 = torch.cat([a, b], dim=-1) / 255.0
        intr = scale_intrinsics(batch["intrinsics"], rois)
        return frames01 * 2.0 - 1.0, {"frames": frames01, "intrinsics": intr}

    return process
