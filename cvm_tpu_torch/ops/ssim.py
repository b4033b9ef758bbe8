"""SSIM for the photometric consistency loss (DMDS).

Mirrors ``cvm_tpu/ops/ssim.py``: the 3x3 stride-1 VALID average pool over
NHWC is ``F.avg_pool2d`` on the channels-last NCHW view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID average pool over (B, H, W, C)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1).permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Structural similarity of [0, 1] images -> the per-pixel (1 - SSIM) / 2
    map, (B, H-2, W-2, C) (VALID window), clipped to [0, 1]."""
    mu_a, mu_b = _avg_pool3(a), _avg_pool3(b)
    var_a = _avg_pool3(a * a) - mu_a * mu_a
    var_b = _avg_pool3(b * b) - mu_b * mu_b
    cov = _avg_pool3(a * b) - mu_a * mu_b
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return torch.clamp((1.0 - num / den) * 0.5, 0.0, 1.0)
