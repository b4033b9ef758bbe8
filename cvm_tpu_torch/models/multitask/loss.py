"""Joint multitask loss: CenterNet detection + weighted CE + depth, with
static task weights or learned Kendall uncertainty weighting.

Mirrors ``cvm_tpu/models/multitask/loss.py`` (``multitask_loss``). With
``uncertainty_weighting`` the total is sum_i exp(-s_i) L_i + 0.5 sum_i s_i
over s = ``task_log_vars`` ([det, seg, depth]); the optimizer's weight
decay reaches s as it does every parameter, as in the reference. ``red``
(``parallel/reduce.py``) reaches every part's batch-wide sums.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from cvm_tpu_torch.models.centernet.loss import masked_l1_loss, penalty_reduced_focal_loss
from cvm_tpu_torch.models.depth.loss import depth_loss
from cvm_tpu_torch.models.depth.params import DepthParams
from cvm_tpu_torch.models.multitask.params import MultitaskParams
from cvm_tpu_torch.models.semseg.loss import semseg_loss
from cvm_tpu_torch.models.semseg.params import SemsegParams
from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer


def multitask_loss(outputs: Dict[str, Any], targets: Dict[str, Any],
                   params: MultitaskParams, red: BatchReducer = LOCAL
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """targets: ``det`` (CenternetTargets), ``classes`` (B, H, W), ``depth``
    (B, H, W, 1)."""
    det = targets["det"]
    l_hm = penalty_reduced_focal_loss(outputs["heatmap"], det.heatmap, params.focal_alpha,
                                      params.focal_beta, red)
    l_off = masked_l1_loss(outputs["offset"], det.offset, det.mask, red)
    l_size = masked_l1_loss(outputs["size"], det.size, det.mask, red)
    l_det = l_hm + params.weight_offset * l_off + params.weight_size * l_size

    seg_p = SemsegParams(num_classes=params.num_seg_classes,
                         class_weights=params.class_weights,
                         ignore_index=params.ignore_index,
                         label_smoothing=params.label_smoothing)
    l_seg, seg_m = semseg_loss({"logits": outputs["logits"]}, targets, seg_p, red)
    dep_p = DepthParams(max_depth=params.max_depth, min_depth=params.min_depth,
                        loss_type=params.depth_loss_type, num_scales=params.num_scales)
    l_dep, dep_m = depth_loss(outputs, targets, dep_p, red)

    metrics = {"loss_det": l_det, "loss_hm": l_hm, "loss_seg": l_seg, "loss_depth": l_dep,
               "pixel_acc": seg_m["pixel_acc"], "abs_rel": dep_m["abs_rel"]}
    if params.uncertainty_weighting:
        s = outputs["task_log_vars"]
        total = (torch.exp(-s[0]) * l_det + torch.exp(-s[1]) * l_seg
                 + torch.exp(-s[2]) * l_dep + 0.5 * s.sum())
        # A copy: s is the parameter itself, which the optimizer updates
        # in place after the metrics are taken.
        logs = s.detach().clone()
        metrics.update(logvar_det=logs[0], logvar_seg=logs[1], logvar_depth=logs[2])
    else:
        total = (params.weight_det * l_det + params.weight_seg * l_seg
                 + params.weight_depth * l_dep)
    metrics["loss"] = total
    return total, metrics
