"""Residual pyramid backbone with the space-to-depth stem.

Mirrors ``cvm_tpu/models/backbones.py`` (``BACKBONE_SPECS``,
``space_to_depth``, ``Backbone``, ``validate_input_hw``). Module names match
the reference's flax names (``stem``, ``down{i}``, ``s{i}b{j}``) so that
``convert.py`` maps parameters by path. Returns NHWC features at strides
{2, 4, 8, 16, 32} as ``{"c1".."c5"}``.

``remat`` is the reference's gradient checkpointing (``nn.remat`` on each
residual block): in training with gradients on, each ``ResBlock`` runs under
``torch.utils.checkpoint`` (non-reentrant), so its inner activations are
dropped after the forward and recomputed in the backward; parameters,
outputs and gradients do not change, so the flag can be flipped on an
existing checkpoint. The recompute runs the block's BatchNorms in training
mode a second time; their running statistics are put back after it, so
they move once per step, as without remat.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from cvm_tpu_torch.models.layers import Conv, ConvBN, ResBlock

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


@contextlib.contextmanager
def _recompute(module: nn.Module, fake_quant):
    """The context of a checkpointed block's recompute in the backward: the
    forward's fake-quant hook (QAT) in force again, and ``module``'s buffers
    (BatchNorm running statistics) put back on exit."""
    saved = [(b, b.clone()) for b in module.buffers()]
    hook, Conv.fake_quant = Conv.fake_quant, fake_quant
    try:
        yield
    finally:
        Conv.fake_quant = hook
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def _checkpointed(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    fake_quant = Conv.fake_quant
    return torch.utils.checkpoint.checkpoint(
        block, x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute(block, fake_quant)))


class Backbone(nn.Module):
    def __init__(self, widths: Sequence[int] = BACKBONE_SPECS["small"][0],
                 depths: Sequence[int] = BACKBONE_SPECS["small"][1],
                 space_to_depth_stem: bool = True, in_ch: int = 3, remat: bool = False):
        super().__init__()
        self.widths, self.depths = tuple(widths), tuple(depths)
        self.space_to_depth_stem = space_to_depth_stem
        self.remat = remat
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
                block = getattr(self, f"s{i + 2}b{j}")
                if self.remat and self.training and torch.is_grad_enabled():
                    x = _checkpointed(block, x)
                else:
                    x = block(x)
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


def make_backbone(name: str, space_to_depth_stem: bool = True, remat: bool = False) -> Backbone:
    widths, depths = BACKBONE_SPECS[name]
    return Backbone(widths, depths, space_to_depth_stem, remat=remat)
