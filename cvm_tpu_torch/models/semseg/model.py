"""Encoder-decoder semantic segmentation model.

Mirrors ``cvm_tpu/models/semseg/model.py`` (``SemsegNet``,
``create_model``): the pyramid backbone down to stride 32, four decoder
``UpBlock``s with skips back to stride 2 (``up16``, ``up8``, ``up4``,
``up2``), the ``seg`` head, then a nearest 2x upsample to full resolution.
Takes NHWC (B, H, W, 3) and returns ``{"logits": (B, H, W, C) fp32}``.
Each block's input width, which flax infers, is derived from
``BACKBONE_SPECS``. With ``spatial_shard`` and a ``mesh``, the head's 3x3
conv (the decoder's widest in H and W) runs with H split over the mesh's
model axis (``layers.SpatialConv3x3``): the same parameters and outputs, in
another layout; without a mesh it is the plain conv, as the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from cvm_tpu_torch.models.backbones import make_backbone, validate_input_hw
from cvm_tpu_torch.models.layers import Head, UpBlock, init_weights, upsample2x
from cvm_tpu_torch.models.semseg.params import SemsegParams
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


class SemsegNet(nn.Module):
    def __init__(self, params: SemsegParams, mesh=None):
        super().__init__()
        p = self.params = params
        self.backbone = make_backbone(p.backbone, p.space_to_depth_stem,
                                      remat=getattr(p, "remat", False))
        w, f = self.backbone.widths, p.decoder_features
        self.up16 = UpBlock(w[4], w[3], f * 4)
        self.up8 = UpBlock(f * 4, w[2], f * 2)
        self.up4 = UpBlock(f * 2, w[1], f * 2)
        self.up2 = UpBlock(f * 2, w[0], f)
        self.seg = Head(f, f, p.num_classes,
                        spatial_mesh=mesh if getattr(p, "spatial_shard", False) else None)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x)
        h = self.up16(feats["c5"], feats["c4"])
        h = self.up8(h, feats["c3"])
        h = self.up4(h, feats["c2"])
        h = self.up2(h, feats["c1"])
        return {"logits": upsample2x(self.seg(h))}


def create_model(params: SemsegParams, device: DeviceLike,
                 generator: Optional[torch.Generator] = None, mesh=None) -> SemsegNet:
    """Build SemsegNet on ``device`` in eval mode, its weights drawn from
    ``generator`` (seed 0 when None); ``mesh`` for ``spatial_shard``."""
    validate_input_hw(params.input_hw)
    model = SemsegNet(params, mesh)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()
