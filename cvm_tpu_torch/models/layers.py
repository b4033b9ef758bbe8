"""Shared NN building blocks, NHWC at every forward, bf16 compute / fp32
parameters.

Mirrors ``cvm_tpu/models/layers.py`` (``ConvBN``, ``ResBlock``,
``upsample2x``, ``UpBlock``, ``Head``) with its numerics: convs run in bf16
on fp32 parameters cast per call (flax ``promote_dtype``), a conv bias is
added in bf16 after the conv, BatchNorm runs in fp32 and casts back to bf16.
Each forward takes and returns NHWC tensors; the convs run on the
channels-last NCHW view of the same memory, so no copy is made.

``module.training`` plays the part of flax's ``train`` argument: BatchNorm
normalizes with the batch statistics and updates its running ones, and each
Head projects in fp32.

Convolutions use TensorFlow/flax ``SAME`` padding, which is asymmetric for a
stride-2 conv on an even input (0 before, 1 after), unlike ``padding=1``.

``SpatialConv3x3`` (``ConvBN(spatial_mesh=)``, ``Head(spatial_mesh=)``)
runs a 3x3 stride-1 conv with H split over a mesh's model axis
(``parallel/spatial.py``); its parameters are those of the ``Conv`` it
replaces.

These modules are what training, the W8A8 postures and QAT run. A BN-folded
serving model (``infer/fold_bn.py``) swaps its ``ConvBN``s, ``ResBlock``s and
``Head``s for serving-only modules that hold bf16 weights prepared once and
run one epilogue kernel after each conv, with the same numerics.
"""

from __future__ import annotations

from typing import Optional

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer
from cvm_tpu_torch.parallel.spatial import gather_rows, spatial_conv3x3, split_rows

ACTS = {None: lambda x: x, "silu": F.silu, "relu": F.relu}


def same_pads(size: int, k: int, s: int):
    """(before, after) SAME padding of one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """The SAME conv of NHWC ``x`` with square OIHW ``weight`` (same dtype),
    no bias, NHWC out."""
    k = weight.shape[2]
    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view
    (pt, pb), (pl, pr) = same_pads(xc.shape[2], k, stride), same_pads(xc.shape[3], k, stride)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, weight, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), weight, stride=stride)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` with SAME padding on NHWC tensors: computes in
    ``dtype`` (the fp32 weight is cast per call), bias added after the conv
    in ``dtype``, output in ``dtype``.

    ``Conv.fake_quant``, when set (``train/qat.py::fake_quant_training``), is
    a function ``(conv, x, dtype) -> y`` that every Conv's forward runs
    instead: the reference swaps the conv at apply time with a flax method
    interceptor, and a module swap would rename the checkpoint's keys."""

    fake_quant = None

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if Conv.fake_quant is not None:
            return Conv.fake_quant(self, x, dtype)
        dt = dtype or self.dtype
        y = conv_nhwc(x.to(dt), self.weight.to(dt), self.stride[0])
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class SpatialConv3x3(nn.Conv2d):
    """A 3x3 stride-1 SAME ``Conv`` (same parameters, same numerics) whose
    conv runs with H split over ``mesh``'s model axis: this rank's H-slab
    of the whole input every rank of the model group holds, the halo
    exchange and a conv VALID on H (``parallel/spatial.py``), then the
    slabs gathered whole again. The bias is added to the whole output.
    ``mesh`` None or a model axis of one rank runs the plain conv.

    It is not a ``Conv``, as the reference's ``SpatialConv3x3`` is no
    ``nn.Conv``: the int8 postures, calibration and QAT's fake quantization
    leave it in floating point, as the reference's interceptors do. The
    pipeline and the trainer set ``mesh`` to their own."""

    def __init__(self, in_ch: int, out_ch: int, mesh=None, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, 3, bias=bias)
        self.mesh, self.dtype = mesh, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, mesh = self.dtype, self.mesh
        x, w = x.to(dt), self.weight.to(dt)
        if mesh is None or mesh.model == 1:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
        else:
            y = gather_rows(spatial_conv3x3(split_rows(x, mesh), w, mesh), mesh)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def bind_spatial_mesh(model: nn.Module, mesh) -> None:
    """Run every ``SpatialConv3x3`` of ``model`` over ``mesh`` (None: the
    plain conv)."""
    for mod in model.modules():
        if isinstance(mod, SpatialConv3x3):
            mod.mesh = mesh


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the channel (last) axis of an NHWC tensor, computed in
    fp32 and cast back to the input dtype; eps 1e-5 as flax's default.

    Training follows flax's ``nn.BatchNorm(momentum=0.9)``: normalize with
    the batch mean and the *biased* batch variance, and move the running
    statistics 10% of the way to them (torch's own train mode would store
    the unbiased variance, n/(n-1) times larger). Inference reads the
    running statistics only.

    ``reducer`` (``parallel/reduce.py``; ``LOCAL`` on one process) makes the
    training statistics those of the global batch, as GSPMD makes the
    reference's: the mean from an all-reduced sum, then the biased
    variance from an all-reduced sum of squared deviations, in fp32 over
    the global count. (``nn.SyncBatchNorm`` would swap this NHWC module for
    an NCHW one with torch's unbiased running variance.)"""

    reducer: BatchReducer = LOCAL

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = super().forward(x.to(torch.float32).permute(0, 3, 1, 2))
            return y.permute(0, 2, 3, 1).to(x.dtype)
        x32 = x.to(torch.float32)
        red = self.reducer
        if red.size == 1:
            var, mean = torch.var_mean(x32, dim=(0, 1, 2), correction=0)
        else:
            n = x32[..., 0].numel() * red.size
            mean = red.all_sum(x32.sum(dim=(0, 1, 2))) / n
            var = red.all_sum(((x32 - mean) ** 2).sum(dim=(0, 1, 2))) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class BiasAdd(nn.Module):
    """What a BatchNorm becomes after ``infer.fold_bn.fold_batchnorm``: its
    residual bias, added in the conv's output dtype (until
    ``infer.fold_bn.swap_folded`` moves it into the conv's epilogue)."""

    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias.to(x.dtype)


class ConvBN(nn.Module):
    """Conv -> BatchNorm -> activation (``act`` in None/"silu"/"relu").
    ``spatial_mesh`` (3x3 stride-1 only) makes the conv a
    ``SpatialConv3x3`` over that mesh."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 act: Optional[str] = "silu", use_bn: bool = True,
                 dtype: torch.dtype = torch.bfloat16, spatial_mesh=None):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"act must be one of {list(ACTS)}, got {act!r}")
        self.kernel, self.stride, self.act, self.dtype = kernel, stride, act, dtype
        if spatial_mesh is not None:
            if (kernel, stride) != (3, 1):
                raise ValueError("spatial sharding supports 3x3 stride-1 convs only, got "
                                 f"{kernel}x{kernel} stride {stride}")
            self.conv = SpatialConv3x3(in_ch, features, spatial_mesh, bias=not use_bn,
                                       dtype=dtype)
        else:
            self.conv = Conv(in_ch, features, kernel, stride, bias=not use_bn, dtype=dtype)
        self.bn = BatchNorm(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return ACTS[self.act](x)


class ResBlock(nn.Module):
    """Basic residual block: two 3x3 ConvBNs, a 1x1 ``proj`` when the width
    changes, and ``act(x + h)``."""

    act = "silu"

    def __init__(self, in_ch: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.c1 = ConvBN(in_ch, features, 3, dtype=dtype)
        self.c2 = ConvBN(features, features, 3, act=None, dtype=dtype)
        self.proj = (ConvBN(in_ch, features, 1, act=None, dtype=dtype)
                     if in_ch != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c2(self.c1(x))
        if self.proj is not None:
            x = self.proj(x)
        return ACTS[self.act](x + h)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NHWC tensor."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


class UpBlock(nn.Module):
    """2x nearest upsample + skip concat + two 3x3 ConvBNs (decoder stage)."""

    def __init__(self, in_ch: int, skip_ch: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.c1 = ConvBN(in_ch + skip_ch, features, 3, dtype=dtype)
        self.c2 = ConvBN(features, features, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = upsample2x(x)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.c2(self.c1(x))


class Head(nn.Module):
    """Task head: 3x3 conv with bias + silu (no BN), then a 1x1 projection
    whose logits are returned as fp32. The projection computes in bf16 at
    inference and in fp32 in training, as the reference does (a bf16
    projection would round the logits the loss sees to an 8-bit mantissa).
    ``spatial_mesh`` runs ``c1``'s conv H-sharded (``SpatialConv3x3``)."""

    def __init__(self, in_ch: int, features: int, out_channels: int,
                 bias_init_value: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 spatial_mesh=None):
        super().__init__()
        self.bias_init_value = bias_init_value
        self.c1 = ConvBN(in_ch, features, 3, use_bn=False, dtype=dtype,
                         spatial_mesh=spatial_mesh)
        self.out = Conv(features, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.float32 if self.training else None
        return self.out(self.c1(x), dtype=dtype).to(torch.float32)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default init, drawn from ``generator`` (a CPU generator):
    conv and dense kernels lecun-normal (truncated normal, variance
    1/fan_in), biases zero except each head's projection (its
    ``bias_init_value``), BatchNorm scale 1, bias 0, mean 0, var 1."""
    # flax truncates at +-2 std and rescales so the variance stays 1/fan_in.
    std_fix = 0.87962566103423978
    for mod in model.modules():
        if isinstance(mod, (Conv, SpatialConv3x3, nn.Linear)):
            fan_in = mod.weight[0].numel()
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            mod.weight.copy_(w * (math.sqrt(1.0 / fan_in) / std_fix))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    for mod in model.modules():
        if isinstance(mod, Head):
            mod.out.bias.fill_(mod.bias_init_value)
