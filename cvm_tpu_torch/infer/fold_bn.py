"""Deploy-time BatchNorm folding: the fp serving posture.

Mirrors ``cvm_tpu/infer/fold_bn.py``. At inference a BatchNorm is a fixed
per-channel affine whose scale folds into the conv kernel:

    y = (conv(x, W) - mean) * gamma / sqrt(var + eps) + beta
      =  conv(x, W * s) + (beta - mean * s)        with s = gamma/sqrt(var+eps)

The reference needs a flax interceptor to replace each BatchNorm by the
residual bias add; here the weight transform swaps the module itself
(``BatchNorm`` -> ``BiasAdd``), so no interceptor exists.

A folded model's weights never change, so ``swap_folded`` then prepares
what each conv needs per call once: every eligible conv becomes a
``FoldedConv`` holding its weight in bf16, in the KRSC layout cuDNN's NHWC
conv reads, and its bias in bf16, and its forward is two kernels: cuDNN's
conv, then one ``conv_epilogue`` (``ops/cuda/conv_epilogue.py``) that adds
the bias, a ResBlock's residual (``FoldedResBlock``) and the activation,
and widens a head's projection to float32 (``FoldedHead``). The outputs
equal the ``BiasAdd`` model's bit for bit. ``InferencePipeline`` swaps in
the fp ``fold_bn`` posture only: the W8A8 postures and a QAT model's fake
quant need the ``Conv`` modules, and a ``SpatialConv3x3`` or a
tensor-parallel ``ColumnConv`` / ``RowConv`` (a mesh's, run eagerly) keeps
its module, folded as above.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn as nn

from cvm_tpu_torch.models.layers import (BatchNorm, BiasAdd, Conv, ConvBN, Head, ResBlock,
                                         SpatialConv3x3, conv_nhwc)
from cvm_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue


@torch.no_grad()
def fold_batchnorm(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every ConvBN's BatchNorm folded into its conv
    kernel (in float64, as the reference) and replaced by a bias add in the
    conv's output dtype. Each BatchNorm's own ``eps`` is used."""
    folded = copy.deepcopy(model)
    for mod in folded.modules():
        if isinstance(mod, ConvBN) and isinstance(mod.bn, BatchNorm):
            bn, conv = mod.bn, mod.conv
            if conv.bias is not None or bn.weight.shape[0] != conv.weight.shape[0]:
                raise ValueError("fold_batchnorm: a ConvBN whose conv has a bias "
                                 "or whose BN width differs is not foldable")
            s = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
            conv.weight.copy_((conv.weight.double() * s[:, None, None, None]).float())
            bias = (bn.bias.double() - bn.running_mean.double() * s).float()
            mod.bn = BiasAdd(bias)
    return folded


class FoldedConv(nn.Module):
    """A folded conv as it serves: ``weight`` bf16 (Cout, kh, kw, Cin) (KRSC;
    its (0, 3, 1, 2) permutation is the channels-last OIHW tensor cuDNN's
    NHWC conv takes without a copy), ``bias`` bf16 (Cout,), both the values
    the ``Conv``'s per-call casts give. ``forward(x, residual=None)``: the
    SAME conv of NHWC ``x`` in bf16, then ``conv_epilogue`` with ``act`` into
    ``out_dtype``."""

    def __init__(self, conv: Conv, bias: torch.Tensor, act: Optional[str],
                 out_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.act, self.out_dtype = conv.stride[0], act, out_dtype
        w = conv.weight.detach().to(torch.bfloat16)
        self.register_buffer("weight", w.permute(0, 2, 3, 1).contiguous())
        self.register_buffer("bias", bias.detach().to(torch.bfloat16))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = conv_nhwc(x.to(torch.bfloat16), self.weight.permute(0, 3, 1, 2), self.stride)
        return conv_epilogue(y, self.bias, residual, act=self.act, out_dtype=self.out_dtype)


class FoldedResBlock(nn.Module):
    """A folded ``ResBlock``: ``c2``'s epilogue adds the block's input (after
    ``proj``, where there is one) and applies the block's ``act``."""

    def __init__(self, block: ResBlock):
        super().__init__()
        self.c1 = _folded_convbn(block.c1)
        self.c2 = _folded_convbn(block.c2, act=block.act)
        self.proj = _folded_convbn(block.proj) if block.proj is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x if self.proj is None else self.proj(x)
        return self.c2(self.c1(x), residual=r)


class FoldedHead(nn.Module):
    """A folded ``Head`` at inference: ``c1`` bias + silu, then ``out``'s
    bias with a float32 output."""

    def __init__(self, head: Head):
        super().__init__()
        self.c1 = _folded_convbn(head.c1)
        self.out = FoldedConv(head.out, head.out.bias, None, out_dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.c1(x))


def _plain_conv(conv: nn.Module) -> bool:
    return type(conv) is Conv and conv.dtype == torch.bfloat16


def _eligible(mod: Optional[nn.Module]) -> bool:
    """A ConvBN whose conv is a bf16 ``Conv`` (not a spatial or
    tensor-parallel one) and whose bias is its folded BatchNorm's or its
    own."""
    if not isinstance(mod, ConvBN) or not _plain_conv(mod.conv):
        return False
    return isinstance(mod.bn, BiasAdd) or (mod.bn is None and mod.conv.bias is not None)


def _folded_convbn(mod: ConvBN, act: Optional[str] = None) -> FoldedConv:
    bias = mod.bn.bias if mod.bn is not None else mod.conv.bias
    return FoldedConv(mod.conv, bias, act if act is not None else mod.act)


def _swap(mod: nn.Module) -> Optional[nn.Module]:
    if type(mod) is ResBlock and mod.c2.act is None and all(
            _eligible(p) for p in (mod.c1, mod.c2, mod.proj) if p is not None):
        return FoldedResBlock(mod)
    if type(mod) is Head and _eligible(mod.c1) and _plain_conv(mod.out) \
            and mod.out.bias is not None:
        return FoldedHead(mod)
    if type(mod) is ConvBN and _eligible(mod):
        return _folded_convbn(mod)
    return None


@torch.no_grad()
def swap_folded(model: nn.Module) -> Dict[str, int]:
    """Swap, in place, the modules of a ``fold_batchnorm`` model whose convs
    can all run as ``FoldedConv``: each eligible ResBlock for a
    ``FoldedResBlock``, Head for a ``FoldedHead`` and ConvBN for a
    ``FoldedConv``. Returns ``{"fused": FoldedConvs (one epilogue launch
    each per call), "kept": convs left as they were}``."""

    def visit(parent: nn.Module) -> None:
        for name, child in list(parent.named_children()):
            new = _swap(child)
            if new is None:
                visit(child)
            else:
                setattr(parent, name, new)

    visit(model)
    mods = list(model.modules())
    return {"fused": sum(isinstance(m, FoldedConv) for m in mods),
            "kept": sum(isinstance(m, (Conv, SpatialConv3x3)) for m in mods)}


@torch.no_grad()
def folded_float_weights(model: nn.Module, served: nn.Module) -> Dict[str, torch.Tensor]:
    """``{name: weight}`` for each ``FoldedConv`` weight of ``served`` (a
    ``swap_folded`` model of ``model``), under its name there and in its
    KRSC layout, in float32: the values ``fold_batchnorm(model)`` holds
    before the bf16 cast. Weight-only int8 (``cli/export.py``) quantizes
    these, as the reference quantizes its float32 folded kernels."""
    source = dict(fold_batchnorm(model).named_modules())
    out = {}
    for name, m in served.named_modules():
        if isinstance(m, FoldedConv):
            conv = source[name]
            conv = conv.conv if isinstance(conv, ConvBN) else conv
            w = conv.weight.detach().permute(0, 2, 3, 1).contiguous()
            if not torch.equal(w.to(m.weight.dtype), m.weight):
                raise ValueError(f"folded_float_weights: {name} is not the fold of the "
                                 "given model")
            out[f"{name}.weight"] = w
    return out
