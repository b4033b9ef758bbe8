"""CenterNet serving hyperparameters; mirrors
``cvm_tpu/models/centernet/params.py`` (same field names and defaults).

Only the fields the serving slice reads are carried; the loss, training and
augmentation fields come with the training slice. ``BaseParams`` is shared
with the reference: ``cvm_tpu.utils.config`` imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from cvm_tpu.utils.config import BaseParams


@dataclasses.dataclass
class CenternetParams(BaseParams):
    """2D CenterNet: heatmap + offset + size heads at output stride R."""

    name: str = "centernet"
    input_hw: Tuple[int, int] = (512, 512)  # config B: COCO 512x512
    batch_size: int = 8
    num_classes: int = 80
    stride: int = 4
    backbone: str = "small"
    neck_features: int = 128
    head_features: int = 64
    top_k: int = 100
    score_threshold: float = 0.3

    @property
    def map_hw(self) -> Tuple[int, int]:
        return (self.input_hw[0] // self.stride, self.input_hw[1] // self.stride)
