"""Multitask (detection + semseg + depth) hyperparameters; mirrors
``cvm_tpu/models/multitask/params.py`` (same field names and defaults;
BASELINE config D)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from cvm_tpu_torch.models.semseg.params import SEMSEG_CLASSES
from cvm_tpu_torch.utils.config import BaseParams


@dataclasses.dataclass
class MultitaskParams(BaseParams):
    name: str = "multitask"
    input_hw: Tuple[int, int] = (256, 640)  # NuScenes-friendly wide aspect
    batch_size: int = 8
    backbone: str = "small"
    neck_features: int = 128
    head_features: int = 64
    # detection head (NuScenes 10-class by default)
    num_det_classes: int = 10
    det_stride: int = 4
    max_objects: int = 128
    top_k: int = 100
    focal_alpha: float = 2.0
    focal_beta: float = 4.0
    min_overlap: float = 0.7
    # semseg head
    num_seg_classes: int = len(SEMSEG_CLASSES)
    class_weights: Tuple[float, ...] = (1.0, 2.0, 1.0, 2.0, 1.0)
    ignore_index: int = 255
    label_smoothing: float = 0.0
    # depth head
    max_depth: float = 80.0
    min_depth: float = 0.5
    num_scales: int = 1
    depth_loss_type: str = "berhu"
    # joint loss weights
    weight_det: float = 1.0
    weight_seg: float = 1.0
    weight_depth: float = 0.5
    # Homoscedastic uncertainty weighting (Kendall et al. 2018): one learned
    # log-variance per task ([det, seg, depth], a (3,) model parameter)
    # replaces the static weight_det/seg/depth balance.
    uncertainty_weighting: bool = False
    weight_offset: float = 1.0
    weight_size: float = 0.1
    # training
    learning_rate: float = 5e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 120_000
    aug_scale_range: Tuple[float, float] = (0.8, 1.3)
    aug_shift_frac: float = 0.05
    aug_flip_prob: float = 0.5

    @property
    def det_map_hw(self) -> Tuple[int, int]:
        return (self.input_hw[0] // self.det_stride, self.input_hw[1] // self.det_stride)
