"""Dense monocular depth net with a multi-scale decoder.

Mirrors ``cvm_tpu/models/depth/model.py`` (``sigmoid_to_depth``,
``DepthNet``, ``create_model``): four decoder ``UpBlock``s (``up0`` ..
``up3``, strides 16 to 2), each with a one-channel ``disp{i}`` head; the
finest ``num_scales`` logits map through ``sigmoid_to_depth`` and the
finest depth is upsampled bilinearly to full resolution. Returns
``{"depth": (B, H, W, 1), "depth_scales": [finest first],
"disp_logits": [finest first]}``, all fp32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from cvm_tpu_torch.models.backbones import make_backbone, validate_input_hw
from cvm_tpu_torch.models.depth.params import DepthParams
from cvm_tpu_torch.models.layers import Head, UpBlock, init_weights
from cvm_tpu_torch.ops.decode import upsample_bilinear
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


def sigmoid_to_depth(x: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor:
    """Sigmoid output -> metric depth by interpolating inverse depth."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * torch.sigmoid(x))


class DepthNet(nn.Module):
    def __init__(self, params: DepthParams):
        super().__init__()
        p = self.params = params
        self.backbone = make_backbone(p.backbone, p.space_to_depth_stem,
                                      remat=getattr(p, "remat", False))
        w, f = self.backbone.widths, p.decoder_features
        ch = w[4]
        for i, (skip, width) in enumerate(((w[3], f * 4), (w[2], f * 2), (w[1], f * 2),
                                           (w[0], f))):
            setattr(self, f"up{i}", UpBlock(ch, skip, width))
            setattr(self, f"disp{i}", Head(width, f, 1))
            ch = width

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.params
        feats = self.backbone(x)
        h, outs = feats["c5"], []
        for i, skip in enumerate((feats["c4"], feats["c3"], feats["c2"], feats["c1"])):
            h = getattr(self, f"up{i}")(h, skip)
            outs.append(getattr(self, f"disp{i}")(h))
        scales = outs[-p.num_scales:][::-1]  # finest first
        depths = [sigmoid_to_depth(s, p.min_depth, p.max_depth) for s in scales]
        full = upsample_bilinear(depths[0], tuple(x.shape[1:3]))
        return {"depth": full, "depth_scales": depths, "disp_logits": scales}

    def params_unread_by_loss(self) -> List[nn.Parameter]:
        """The disp heads coarser than the ``num_scales`` the forward
        returns: computed, read by no loss (the train step gives them a
        zero gradient, as JAX does)."""
        return [q for i in range(4 - self.params.num_scales)
                for q in getattr(self, f"disp{i}").parameters()]


def create_model(params: DepthParams, device: DeviceLike,
                 generator: Optional[torch.Generator] = None) -> DepthNet:
    """Build DepthNet on ``device`` in eval mode, its weights drawn from
    ``generator`` (seed 0 when None)."""
    validate_input_hw(params.input_hw)
    model = DepthNet(params)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()
