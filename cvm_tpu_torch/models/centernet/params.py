"""CenterNet hyperparameters; mirrors ``cvm_tpu/models/centernet/params.py``
(same field names and defaults).

``with_3d`` adds the monocular 3D heads (camera-frame depth, object
dimensions, yaw), their targets and their losses (``weight_depth3d``,
``weight_dims3d``, ``weight_rot``).
``BaseParams`` (which adds ``ema_decay``, ``grad_accum_steps``,
``lr_schedule``, ``optimizer``, ``aug_noise_std``, ``aug_blur_prob``,
``aug_rotate_deg`` and the rest) is the port's copy of the reference's
(``cvm_tpu_torch/utils/config.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from cvm_tpu_torch.utils.config import BaseParams


@dataclasses.dataclass
class CenternetParams(BaseParams):
    """2D CenterNet: heatmap + offset + size heads at output stride R."""

    name: str = "centernet"
    input_hw: Tuple[int, int] = (512, 512)  # config B: COCO 512x512
    batch_size: int = 8
    num_classes: int = 80
    stride: int = 4
    max_objects: int = 128
    backbone: str = "small"
    neck_features: int = 128
    head_features: int = 64
    top_k: int = 100
    score_threshold: float = 0.3
    # loss weights (Objects-as-Points defaults)
    focal_alpha: float = 2.0
    focal_beta: float = 4.0
    weight_heatmap: float = 1.0
    weight_offset: float = 1.0
    weight_size: float = 0.1
    min_overlap: float = 0.7
    # GT heatmap from the hand-written splat kernel K1
    # (ops/cuda/gaussian_splat.py); False = the plain lattice renderer.
    use_pallas_splat: bool = True
    # monocular 3D heads (KITTI / nuScenes style)
    with_3d: bool = False
    weight_depth3d: float = 1.0
    weight_dims3d: float = 1.0
    weight_rot: float = 1.0
    # training
    learning_rate: float = 5e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 100_000
    # augmentation
    aug_scale_range: Tuple[float, float] = (0.6, 1.4)
    aug_shift_frac: float = 0.1
    aug_flip_prob: float = 0.5

    @property
    def map_hw(self) -> Tuple[int, int]:
        return (self.input_hw[0] // self.stride, self.input_hw[1] // self.stride)
