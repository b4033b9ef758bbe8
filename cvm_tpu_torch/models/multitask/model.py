"""Shared-backbone multitask model: detection, segmentation and depth.

Mirrors ``cvm_tpu/models/multitask/model.py`` (``MultitaskNet``,
``create_model``): a shared decoder trunk (``up16``, ``up8``, ``up4``)
feeds the CenterNet heads ``hm`` (with the focal prior bias), ``off`` and
``size`` at stride 4; ``up2`` feeds the ``seg`` and ``disp`` heads at
stride 2, whose logits go to full resolution (nearest 2x, and bilinear
depth). With ``uncertainty_weighting`` the model carries the (3,)
parameter ``task_log_vars`` that the loss reads. Returns NHWC fp32
``{"heatmap", "offset", "size", "logits", "depth", "depth_scales"[,
"task_log_vars"]}``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from cvm_tpu_torch.models.backbones import make_backbone, validate_input_hw
from cvm_tpu_torch.models.depth.model import sigmoid_to_depth
from cvm_tpu_torch.models.layers import Head, UpBlock, init_weights, upsample2x
from cvm_tpu_torch.models.multitask.params import MultitaskParams
from cvm_tpu_torch.ops.decode import upsample_bilinear
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device

_HM_BIAS = -math.log((1.0 - 0.1) / 0.1)


class MultitaskNet(nn.Module):
    def __init__(self, params: MultitaskParams):
        super().__init__()
        p = self.params = params
        self.backbone = make_backbone(p.backbone, p.space_to_depth_stem,
                                      remat=getattr(p, "remat", False))
        w, f, hf = self.backbone.widths, p.neck_features, p.head_features
        self.up16 = UpBlock(w[4], w[3], f * 2)
        self.up8 = UpBlock(f * 2, w[2], f * 2)
        self.up4 = UpBlock(f * 2, w[1], f)
        self.hm = Head(f, hf, p.num_det_classes, _HM_BIAS)
        self.off = Head(f, hf, 2)
        self.size = Head(f, hf, 2)
        self.up2 = UpBlock(f, w[0], f // 2)
        self.seg = Head(f // 2, hf, p.num_seg_classes)
        self.disp = Head(f // 2, hf, 1)
        self.task_log_vars = (nn.Parameter(torch.zeros(3)) if p.uncertainty_weighting
                              else None)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.params
        feats = self.backbone(x)
        h = self.up16(feats["c5"], feats["c4"])
        h = self.up8(h, feats["c3"])
        trunk4 = self.up4(h, feats["c2"])
        out = {"heatmap": self.hm(trunk4), "offset": self.off(trunk4),
               "size": self.size(trunk4)}
        dense2 = self.up2(trunk4, feats["c1"])
        out["logits"] = upsample2x(self.seg(dense2))
        depth2 = sigmoid_to_depth(self.disp(dense2), p.min_depth, p.max_depth)
        out["depth"] = upsample_bilinear(depth2, tuple(x.shape[1:3]))
        out["depth_scales"] = [depth2]
        if self.task_log_vars is not None:
            out["task_log_vars"] = self.task_log_vars
        return out


def create_model(params: MultitaskParams, device: DeviceLike,
                 generator: Optional[torch.Generator] = None) -> MultitaskNet:
    """Build MultitaskNet on ``device`` in eval mode, its weights drawn from
    ``generator`` (seed 0 when None; ``task_log_vars`` start at 0)."""
    validate_input_hw(params.input_hw)
    model = MultitaskNet(params)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()
