"""Semseg processor: padded image + class-id mask -> model input + GT.

Mirrors ``cvm_tpu/models/semseg/processor.py::make_processor``: the image
is letterboxed (eval) or jittered and photometrically augmented
(training), and the mask is resampled nearest-neighbour through the same
ROI, padded with ``ignore_index``; with ``aug_rotate_deg > 0`` both roll
by the same angle (the mask nearest, ``ignore_index`` where it rotates in).
As in the CenterNet processor, the random numbers are ``draws`` when given,
else drawn from the generator.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cvm_tpu_torch.models.semseg.params import SemsegParams
from cvm_tpu_torch.pipeline.preprocess import (AugDraws, BatchRows, preprocess_with_rois,
                                               resample_labels, rotate_labels)


def make_processor(params: SemsegParams, train: bool) -> Callable[..., Tuple]:
    """Returns ``process(generator, batch, draws=None, rows=None) -> (inputs,
    {"classes": (B, H, W) int32})``; batch holds image (or y/u/v),
    image_hw and mask (B, Hmax, Wmax) class ids."""

    def process(generator, batch, draws: Optional[AugDraws] = None,
                rows: Optional[BatchRows] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        images, rois, angles = preprocess_with_rois(params, train, generator, batch, draws,
                                                     rows)
        classes = rotate_labels(
            resample_labels(batch, "mask", rois, params.input_hw, params.ignore_index),
            angles, params.ignore_index)
        return images, {"classes": classes}

    return process
