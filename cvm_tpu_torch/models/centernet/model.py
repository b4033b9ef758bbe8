"""CenterNet: backbone + upsampling neck + heatmap/offset/size heads.

Mirrors ``cvm_tpu/models/centernet/model.py`` (``CenterNet``,
``create_model``). Takes an NHWC (B, H, W, 3) input and returns NHWC fp32
heads ``{"heatmap", "offset", "size"}``; ``with_3d`` adds the monocular 3D
heads ``{"depth3d" (1, the 1/sigmoid - 1 depth's logit), "dims3d" (3,
metres), "rot" (2, yaw sin/cos)}``. Module names follow the reference's
flax names (``backbone`` for ``Backbone_0``, ``up{i}``, ``hm``, ``off``,
``size``, ``dep3d``, ``dim3d``, ``rot``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from cvm_tpu_torch.models.backbones import make_backbone, validate_input_hw
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.models.layers import Head, UpBlock, init_weights
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device

# Focal-loss prior: initial heatmap prob ~0.1 everywhere.
_HM_BIAS = -math.log((1.0 - 0.1) / 0.1)


class CenterNet(nn.Module):
    def __init__(self, params: CenternetParams):
        super().__init__()
        p = self.params = params
        self.backbone = make_backbone(p.backbone, p.space_to_depth_stem,
                                      remat=getattr(p, "remat", False))
        w = self.backbone.widths
        skip_ch = {16: w[3], 8: w[2], 4: w[1], 2: w[0]}
        ch, s, i = w[4], 32, 0
        while s > p.stride:
            s //= 2
            setattr(self, f"up{i}", UpBlock(ch, skip_ch[s], p.neck_features))
            ch, i = p.neck_features, i + 1
        self.n_up = i
        self.hm = Head(ch, p.head_features, p.num_classes, _HM_BIAS)
        self.off = Head(ch, p.head_features, 2)
        self.size = Head(ch, p.head_features, 2)
        if p.with_3d:
            self.dep3d = Head(ch, p.head_features, 1)
            self.dim3d = Head(ch, p.head_features, 3)
            self.rot = Head(ch, p.head_features, 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x)
        skips = {16: feats["c4"], 8: feats["c3"], 4: feats["c2"], 2: feats["c1"]}
        h, s = feats["c5"], 32
        for i in range(self.n_up):
            s //= 2
            h = getattr(self, f"up{i}")(h, skips[s])
        out = {"heatmap": self.hm(h), "offset": self.off(h), "size": self.size(h)}
        if self.params.with_3d:
            out.update(depth3d=self.dep3d(h), dims3d=self.dim3d(h), rot=self.rot(h))
        return out


def create_model(params: CenternetParams, device: DeviceLike,
                 generator: Optional[torch.Generator] = None) -> CenterNet:
    """Build CenterNet on ``device`` in eval mode, its weights drawn from
    ``generator`` (seed 0 when None)."""
    validate_input_hw(params.input_hw)
    model = CenterNet(params)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()
