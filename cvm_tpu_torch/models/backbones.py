"""Residual pyramid backbone with the space-to-depth stem.

Mirrors ``cvm_tpu/models/backbones.py`` (``BACKBONE_SPECS``,
``space_to_depth``, ``Backbone``, ``validate_input_hw``). Module names match
the reference's flax names (``stem``, ``down{i}``, ``s{i}b{j}``) so that
``convert.py`` maps parameters by path. Returns NHWC features at strides
{2, 4, 8, 16, 32} as ``{"c1".."c5"}``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from cvm_tpu_torch.models.layers import ConvBN, ResBlock

# name -> (stage widths c1..c5, blocks per stage c2..c5)
BACKBONE_SPECS: Dict[str, Tuple[Sequence[int], Sequence[int]]] = {
    "tiny": ((16, 32, 64, 128, 256), (1, 1, 2, 2)),
    "small": ((32, 64, 128, 256, 512), (1, 2, 2, 2)),
    "base": ((32, 64, 128, 256, 512), (2, 3, 4, 2)),
}


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b), channels in (dy, dx, c) order —
    the order the stem's converted weights assume."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // block, block, W // block, block, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // block, W // block, C * block * block)


class Backbone(nn.Module):
    def __init__(self, widths: Sequence[int] = BACKBONE_SPECS["small"][0],
                 depths: Sequence[int] = BACKBONE_SPECS["small"][1],
                 space_to_depth_stem: bool = True, in_ch: int = 3):
        super().__init__()
        self.widths, self.depths = tuple(widths), tuple(depths)
        self.space_to_depth_stem = space_to_depth_stem
        if space_to_depth_stem:
            self.stem = ConvBN(in_ch * 4, widths[0], 3, stride=1)
        else:
            self.stem = ConvBN(in_ch, widths[0], 3, stride=2)
        prev = widths[0]
        for i, (w, d) in enumerate(zip(widths[1:], depths)):
            setattr(self, f"down{i + 2}", ConvBN(prev, w, 3, stride=2))
            for j in range(d):
                setattr(self, f"s{i + 2}b{j}", ResBlock(w, w))
            prev = w

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(space_to_depth(x, 2) if self.space_to_depth_stem else x)
        feats = {"c1": x}
        for i, d in enumerate(self.depths):
            x = getattr(self, f"down{i + 2}")(x)
            for j in range(d):
                x = getattr(self, f"s{i + 2}b{j}")(x)
            feats[f"c{i + 2}"] = x
        return feats


def validate_input_hw(hw, divisor: int = 32) -> None:
    """Fail fast on input sizes the pyramid cannot halve cleanly."""
    h, w = int(hw[0]), int(hw[1])
    if h % divisor or w % divisor:
        raise ValueError(
            f"input_hw must be multiples of {divisor} (stem + downsampling "
            f"pyramid + decoder skip alignment need even intermediate "
            f"resolutions); got {(h, w)}")


def make_backbone(name: str, space_to_depth_stem: bool = True) -> Backbone:
    widths, depths = BACKBONE_SPECS[name]
    return Backbone(widths, depths, space_to_depth_stem)
