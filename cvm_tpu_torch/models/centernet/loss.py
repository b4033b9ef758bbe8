"""CenterNet losses: penalty-reduced focal loss on the heatmap and masked L1
on offset and size at the GT centres ("Objects as Points").

Mirrors ``cvm_tpu/models/centernet/loss.py`` (``penalty_reduced_focal_loss``,
``masked_l1_loss``, ``centernet_loss``). With ``with_3d`` and 3D targets,
the depth head's 1/sigmoid - 1 depth and the dims and yaw (sin, cos) heads
add masked L1 terms at the centres. Every value is a 0-dim device tensor,
so a training step never waits on the host. Each batch-wide sum (the
positives, the masked pixels) goes through ``red`` (``parallel/reduce.py``):
over the global batch under data parallelism, as the reference's are.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops.heatmap import CenternetTargets
from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer


def penalty_reduced_focal_loss(logits: torch.Tensor, target: torch.Tensor,
                               alpha: float = 2.0, beta: float = 4.0,
                               red: BatchReducer = LOCAL) -> torch.Tensor:
    """Focal loss of heatmap logits against the rendered Gaussian target:
    positive where target == 1, elsewhere penalty-reduced by
    (1 - target)^beta; normalized by the number of positives."""
    prob = torch.clamp(torch.sigmoid(logits), 1e-6, 1.0 - 1e-6)
    pos = (target >= 1.0 - 1e-6).to(torch.float32)
    neg = 1.0 - pos
    pos_loss = -torch.log(prob) * (1.0 - prob) ** alpha * pos
    neg_loss = -torch.log(1.0 - prob) * prob ** alpha * (1.0 - target) ** beta * neg
    num_pos = torch.clamp_min(red.sum(pos), 1.0)
    return (red.sum(pos_loss) + red.sum(neg_loss)) / num_pos


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                   red: BatchReducer = LOCAL) -> torch.Tensor:
    """Mean |pred - target| over the pixels where mask == 1 (GT centres)."""
    m = mask[..., None]
    num = torch.clamp_min(red.sum(m), 1.0)
    return red.sum(torch.abs(pred - target) * m) / num


def centernet_loss(outputs: Dict[str, torch.Tensor], targets: CenternetTargets,
                   params: CenternetParams, red: BatchReducer = LOCAL
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the losses, and the metrics dict ``{"loss",
    "loss_hm", "loss_off", "loss_size"}`` (+ ``loss_dep3d``, ``loss_dim3d``,
    ``loss_rot`` with 3D targets)."""
    l_hm = penalty_reduced_focal_loss(outputs["heatmap"], targets.heatmap,
                                      params.focal_alpha, params.focal_beta, red)
    l_off = masked_l1_loss(outputs["offset"], targets.offset, targets.mask, red)
    l_size = masked_l1_loss(outputs["size"], targets.size, targets.mask, red)
    total = (params.weight_heatmap * l_hm + params.weight_offset * l_off
             + params.weight_size * l_size)
    metrics = {"loss": total, "loss_hm": l_hm, "loss_off": l_off, "loss_size": l_size}
    if params.with_3d and targets.extras:
        ex = targets.extras
        pred_depth = 1.0 / torch.sigmoid(outputs["depth3d"]) - 1.0
        l_dep = masked_l1_loss(pred_depth, ex["depth3d"], targets.mask, red)
        l_dim = masked_l1_loss(outputs["dims3d"], ex["dims3d"], targets.mask, red)
        l_rot = masked_l1_loss(outputs["rot"], ex["rot"], targets.mask, red)
        total = (total + params.weight_depth3d * l_dep + params.weight_dims3d * l_dim
                 + params.weight_rot * l_rot)
        metrics.update(loss=total, loss_dep3d=l_dep, loss_dim3d=l_dim, loss_rot=l_rot)
    return total, metrics
