"""Masked sparse-GT depth regression losses: L1, berHu and scale-invariant
log, summed over the decoder's scales.

Mirrors ``cvm_tpu/models/depth/loss.py`` (``berhu``, ``silog``,
``depth_loss``). Every loss masks to the valid pixels (depth > 0). Each
scale is upsampled bilinearly to the GT's resolution (downsampling sparse
GT would destroy isolated points) and weighted 1/2^i. BerHu's threshold
c = 0.2 max|err| carries a gradient through the max; ``torch.amax`` shares
it among tied maxima, as JAX's max does. Each batch-wide sum and max goes
through ``red`` (``parallel/reduce.py``): the scale-invariant term is not a
sum of per-process losses, so under data parallelism it needs the global
sums of d and d^2 and the global count.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cvm_tpu_torch.models.depth.params import DepthParams
from cvm_tpu_torch.ops.decode import upsample_bilinear
from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, red: BatchReducer = LOCAL
                 ) -> torch.Tensor:
    return red.sum(x * mask) / torch.clamp_min(red.sum(mask), 1.0)


def berhu(err: torch.Tensor, mask: torch.Tensor, red: BatchReducer = LOCAL) -> torch.Tensor:
    """Reverse Huber with the adaptive threshold c = 0.2 max|err| over the
    valid pixels."""
    abs_err = torch.abs(err) * mask
    c = 0.2 * red.max(abs_err) + 1e-6
    quad = (err ** 2 + c ** 2) / (2.0 * c)
    return _masked_mean(torch.where(abs_err <= c, abs_err, quad), mask, red)


def silog(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
          lam: float = 0.85, red: BatchReducer = LOCAL) -> torch.Tensor:
    """Scale-invariant log error (Eigen et al.)."""
    d = (torch.log(torch.clamp_min(pred, 1e-3)) - torch.log(torch.clamp_min(gt, 1e-3))) * mask
    n = torch.clamp_min(red.sum(mask), 1.0)
    return red.sum(d ** 2) / n - lam * (red.sum(d) / n) ** 2


def depth_loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
               params: DepthParams, red: BatchReducer = LOCAL
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """targets["depth"]: (B, H, W, 1) metric, 0 where invalid -> (loss,
    {"loss", "abs_rel", "rmse"})."""
    gt = targets["depth"]
    mask = (gt > 0).to(torch.float32)
    total = 0.0
    for i, d in enumerate(outputs["depth_scales"]):
        pred = upsample_bilinear(d, tuple(gt.shape[1:3])) if d.shape[1:3] != gt.shape[1:3] else d
        if params.loss_type == "berhu":
            loss = berhu(pred - gt, mask, red)
        elif params.loss_type == "silog":
            loss = silog(pred, gt, mask, red=red)
        else:
            loss = _masked_mean(torch.abs(pred - gt), mask, red)
        total = total + loss / (2.0 ** i)
    pred0 = outputs["depth"]
    abs_rel = _masked_mean(torch.abs(pred0 - gt) / torch.clamp_min(gt, 1e-3), mask, red)
    rmse = torch.sqrt(_masked_mean((pred0 - gt) ** 2, mask, red))
    return total, {"loss": total, "abs_rel": abs_rel, "rmse": rmse}
