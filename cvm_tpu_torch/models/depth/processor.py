"""Depth processor: padded image + sparse depth map -> model input + GT.

Mirrors ``cvm_tpu/models/depth/processor.py::make_processor``: the depth
map is resampled nearest-neighbour through the image's ROI (bilinear
would smear isolated valid points into the zeros), padded with 0
(invalid); with ``aug_rotate_deg > 0`` it rolls with the image (nearest,
0 where it rotates in).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cvm_tpu_torch.models.depth.params import DepthParams
from cvm_tpu_torch.pipeline.preprocess import (AugDraws, BatchRows, preprocess_with_rois,
                                               resample_labels, rotate_labels)


def make_processor(params: DepthParams, train: bool) -> Callable[..., Tuple]:
    """Returns ``process(generator, batch, draws=None, rows=None) -> (inputs,
    {"depth": (B, H, W, 1) float32})``; batch holds image (or y/u/v),
    image_hw and depth (B, Hmax, Wmax) metres, 0 where invalid."""

    def process(generator, batch, draws: Optional[AugDraws] = None,
                rows: Optional[BatchRows] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        images, rois, angles = preprocess_with_rois(params, train, generator, batch, draws,
                                                     rows)
        depth = rotate_labels(resample_labels(batch, "depth", rois, params.input_hw, 0.0),
                              angles, 0.0)
        return images, {"depth": depth[..., None]}

    return process
