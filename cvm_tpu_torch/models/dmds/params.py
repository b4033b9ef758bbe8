"""DMDS (depth and motion from video) hyperparameters; mirrors
``cvm_tpu/models/dmds/params.py`` (same field names and defaults; config
E)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from cvm_tpu_torch.utils.config import BaseParams


@dataclasses.dataclass
class DmdsParams(BaseParams):
    name: str = "dmds"
    input_hw: Tuple[int, int] = (192, 640)  # KITTI video crops
    batch_size: int = 8
    backbone: str = "small"
    decoder_features: int = 64
    num_scales: int = 1
    max_depth: float = 80.0
    min_depth: float = 0.1
    motion_features: int = 128
    predict_object_motion: bool = True
    # warp sampling: "auto" and "gather" are the 4-tap gather (ops/warp.py);
    # the reference's TPU matrix-product sampler "mxu" is not ported
    warp_method: str = "auto"
    # loss weights (depth-and-motion-learning style)
    ssim_weight: float = 0.85         # alpha in photometric = a*SSIM + (1-a)*L1
    weight_photometric: float = 1.0
    weight_smoothness: float = 1e-2
    weight_motion_smoothness: float = 1e-3
    weight_motion_sparsity: float = 1e-2
    weight_cycle: float = 1e-1
    # training
    learning_rate: float = 2e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 120_000
    aug_scale_range: Tuple[float, float] = (1.0, 1.15)
    aug_shift_frac: float = 0.02
    aug_flip_prob: float = 0.0  # flips would mirror the motion field
