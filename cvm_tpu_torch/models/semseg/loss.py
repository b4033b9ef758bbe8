"""Weighted cross-entropy with an ignore label, and the confusion-matrix
mIoU.

Mirrors ``cvm_tpu/models/semseg/loss.py`` (``semseg_loss``,
``miou_metric``) term for term: the per-pixel NLL, with uniform label
smoothing taken against the unweighted class mean of -log p, is weighted
by its label's class weight and divided by max(sum of the valid pixels'
weights, 1). ``F.cross_entropy(weight=, label_smoothing=)`` weights the
smoothing term per class and normalises otherwise, so it is not used.
The batch-wide sums go through ``red`` (``parallel/reduce.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cvm_tpu_torch.models.semseg.params import SemsegParams
from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer


def semseg_loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                params: SemsegParams, red: BatchReducer = LOCAL
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs["logits"] (B, H, W, C); targets["classes"] (B, H, W) int with
    ``ignore_index`` for void pixels -> (loss, {"loss", "pixel_acc"})."""
    logits = outputs["logits"]
    labels = targets["classes"]
    C = params.num_classes
    if len(params.class_weights) != C:
        raise ValueError(f"class_weights has {len(params.class_weights)} entries but "
                         f"num_classes={C}; they must match")
    valid = (labels != params.ignore_index) & (labels >= 0) & (labels < C)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    eps = float(getattr(params, "label_smoothing", 0.0))
    if eps > 0.0:
        nll = (1.0 - eps) * nll + eps * (-logp.mean(dim=-1))
    w = torch.tensor(params.class_weights, dtype=torch.float32, device=logits.device)[safe]
    vf = valid.to(torch.float32)
    denom = torch.clamp_min(red.sum(w * vf), 1.0)
    loss = red.sum(nll * w * vf) / denom
    pred = torch.argmax(logits, dim=-1)
    acc = red.sum((pred == labels) & valid) / torch.clamp_min(red.sum(valid), 1)
    return loss, {"loss": loss, "pixel_acc": acc}


def miou_metric(pred: torch.Tensor, labels: torch.Tensor, num_classes: int,
                ignore_index: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """Confusion-matrix mIoU on the device: (iou per class, miou) over the
    classes present in prediction or label."""
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    p = torch.where(valid, pred, num_classes).long()
    lab = torch.where(valid, labels, num_classes).long()
    n = num_classes + 1
    cm = torch.bincount((lab * n + p).reshape(-1), minlength=n * n).reshape(n, n)
    cm = cm[:num_classes, :num_classes]
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = inter / torch.clamp_min(union, 1)
    present = union > 0
    miou = torch.where(present, iou, 0.0).sum() / torch.clamp_min(present.sum(), 1)
    return iou, miou
