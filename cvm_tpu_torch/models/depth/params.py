"""Dense monocular depth hyperparameters; mirrors
``cvm_tpu/models/depth/params.py`` (same field names and defaults; BASELINE
config C)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from cvm_tpu_torch.utils.config import BaseParams


@dataclasses.dataclass
class DepthParams(BaseParams):
    name: str = "depth"
    input_hw: Tuple[int, int] = (256, 640)  # KITTI-ish aspect (BASELINE config C)
    batch_size: int = 8
    backbone: str = "small"
    decoder_features: int = 64
    num_scales: int = 4          # multi-scale supervision pyramid
    max_depth: float = 80.0      # meters (KITTI)
    min_depth: float = 0.5
    loss_type: str = "berhu"     # "l1" | "berhu" | "silog"
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 60_000
    aug_scale_range: Tuple[float, float] = (1.0, 1.2)
    aug_shift_frac: float = 0.03
    aug_flip_prob: float = 0.5
