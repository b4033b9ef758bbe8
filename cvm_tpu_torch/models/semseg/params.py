"""Semseg hyperparameters; mirrors ``cvm_tpu/models/semseg/params.py``
(same field names and defaults; BASELINE config A at ``batch_size=1``).

Default classes follow the comma10k road-scene split.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from cvm_tpu_torch.utils.config import BaseParams

# comma10k-style classes and display palette (RGB).
SEMSEG_CLASSES = ("road", "lane_markings", "undrivable", "movable", "ego_car")
SEMSEG_PALETTE = (
    (64, 32, 32),    # road #402020
    (255, 0, 0),     # lane_markings #ff0000
    (128, 128, 96),  # undrivable #808060
    (0, 255, 102),   # movable #00ff66
    (204, 0, 255),   # ego_car #cc00ff
)


@dataclasses.dataclass
class SemsegParams(BaseParams):
    name: str = "semseg"
    input_hw: Tuple[int, int] = (256, 640)  # BASELINE config A: 640x256
    batch_size: int = 8
    num_classes: int = len(SEMSEG_CLASSES)
    backbone: str = "small"
    decoder_features: int = 64
    class_weights: Tuple[float, ...] = (1.0, 2.0, 1.0, 2.0, 1.0)
    ignore_index: int = 255
    # Uniform label smoothing for the CE loss (0 = off).
    label_smoothing: float = 0.0
    # Run the head conv H-sharded over the mesh "model" axis (halo-exchange
    # spatial sharding, parallel/spatial.py): execution layout only.
    spatial_shard: bool = False
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 60_000
    aug_scale_range: Tuple[float, float] = (0.8, 1.3)
    aug_shift_frac: float = 0.05
    aug_flip_prob: float = 0.5
