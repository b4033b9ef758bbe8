"""Weight-only int8, and W8A8 serving: dynamic and static-calibrated int8
convs (``_int_mm``), and static-calibrated W8A8 through the fused int8
ConvBN kernel.

Mirrors ``cvm_tpu/infer/quantize.py``: weight-only int8
(``quantize_params``, ``dequantize_params``, ``quantization_error``; plain
tensor arithmetic on the model's named parameters, no kernel), the
XLA-composed W8A8 paths (``conv_geometry``, ``_int8_conv`` /
``w8a8_inference``, ``_int8_conv_static`` / ``w8a8_static_inference``) and
the fused path (``calibrate_activation_scales``,
``prequantize_fused_weights``, ``_bn_affine``, ``_fused_convbn``,
``_fused_resblock``, ``w8a8_fused_inference``).

The reference swaps modules at apply time with flax method interceptors;
the PyTorch counterparts swap the modules themselves:
  * ``swap_int8`` puts an ``Int8Conv`` in place of every Conv (dynamic
    scales) or of every Conv with a calibrated input scale (static); a conv
    without a scale stays fp, as the reference documents, and is counted;
  * ``swap_fused`` puts a ``FusedConvBN`` in place of every eligible ConvBN
    (stride 1, 1x1 or 3x3, calibrated input scale) and, with
    ``chain=True``, a ``ChainedResBlock`` in place of every ResBlock whose
    convs are all calibrated, which keeps the c1 -> c2 buffer in int8.

``Int8Conv`` is exact where an fp32 conv of int8 values is not (9 * 512 *
127^2 > 2^24): on the card its product is ``torch._int_mm`` over an im2col
of the int8 input, summed in int32, as the reference's
``lax.conv_general_dilated(..., preferred_element_type=int32)``; its plain
version (CPU tensors) sums the same lattice products in float64, which is
exact too.

Differences from the reference, on purpose:
  * the activations and BN eps come from the modules (the reference
    hardcodes silu and eps 1e-5 in its chained block);
  * nothing falls back to fp silently: a conv or module the swaps select
    but cannot run in int8 raises, and each swap reports its counts.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

import torch.nn.functional as F

from cvm_tpu_torch.models.layers import ACTS, BatchNorm, Conv, ConvBN, ResBlock, same_pads
from cvm_tpu_torch.ops.cuda.fused_qconv import fused_qconv, pack_qconv_weights
from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer
from cvm_tpu_torch.utils.prof import launch_counter

WeightTable = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

# Weights eligible for weight-only int8: conv weights (the reference's flax
# "kernel" leaves), at least _MIN_SIZE elements.
_MIN_SIZE = 256


def _is_quantized(v: Any) -> bool:
    return isinstance(v, dict) and set(v) == {"int8", "scale"}


@torch.no_grad()
def quantize_params(params: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """``{name: tensor}`` (a model's named parameters) -> the same mapping
    where each eligible conv weight (``*.weight``, >= 2 dims, >= 256
    elements, float32/float16) becomes ``{"int8": int8 tensor of the same
    shape, "scale": (Cout,) float32}``: per-output-channel symmetric scales
    (axis 0 of the port's OIHW weights, the last axis of the reference's
    HWIO kernels), the reference's formula in the same float arithmetic.
    Also returns ``{"quantized": n, "total": number of tensors}``."""
    out: Dict[str, Any] = {}
    n_quant = 0
    for name, v in params.items():
        v = v.detach()
        if (name.endswith(".weight") and v.dim() >= 2 and v.numel() >= _MIN_SIZE
                and v.dtype in (torch.float32, torch.float16)):
            amax = v.abs().amax(dim=tuple(range(1, v.dim())))
            scale = (amax / 127.0 + 1e-12).to(torch.float32)
            per_row = scale.view(-1, *([1] * (v.dim() - 1)))
            q = torch.clamp(torch.round(v / per_row), -127, 127).to(torch.int8)
            out[name] = {"int8": q, "scale": scale}
            n_quant += 1
        else:
            out[name] = v
    return out, {"quantized": n_quant, "total": len(out)}


def dequantize_params(qparams: Mapping[str, Any],
                      dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_params``: ``{name: tensor}`` to load into the
    model (int8 value times its channel's scale, in ``dtype``)."""
    out = {}
    for name, v in qparams.items():
        if _is_quantized(v):
            q = v["int8"]
            v = q.to(dtype) * v["scale"].to(dtype).view(-1, *([1] * (q.dim() - 1)))
        out[name] = v
    return out


def quantization_error(params: Mapping[str, torch.Tensor], qparams: Mapping[str, Any]) -> float:
    """Max relative Frobenius error across the quantized tensors (a sanity
    metric; float32 numpy arithmetic, as the reference's)."""
    errs = []
    for name, v in qparams.items():
        if _is_quantized(v):
            orig = params[name].detach().cpu().numpy().astype(np.float32)
            deq = dequantize_params({name: v})[name].cpu().numpy()
            errs.append(float(np.linalg.norm(orig - deq) / (np.linalg.norm(orig) + 1e-12)))
    return max(errs) if errs else 0.0


@torch.no_grad()
def calibrate_activation_scales(model: nn.Module, inputs: Iterable[torch.Tensor],
                                percentile: float = 99.9) -> Dict[str, float]:
    """Run ``model`` over calibration inputs and record, per conv, the
    ``percentile`` of |input| -> ``{conv module name: max over inputs / 127
    + 1e-12}``. The percentile is numpy's (linear method) on the host:
    ``torch.quantile`` refuses inputs over 2^24 elements."""
    records: Dict[str, list] = {}

    def hook(name):
        def pre(mod, args):
            x = np.abs(args[0].detach().to(torch.float32).cpu().numpy())
            records.setdefault(name, []).append(float(np.percentile(x, percentile)))
        return pre

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in model.named_modules() if isinstance(m, Conv)]
    try:
        for x in inputs:
            model(x)
    finally:
        for h in handles:
            h.remove()
    if not records:
        raise RuntimeError("calibration recorded no conv activations")
    return {k: max(v) / 127.0 + 1e-12 for k, v in records.items()}


@torch.no_grad()
def prequantize_fused_weights(model: nn.Module) -> WeightTable:
    """``{ConvBN module name: (wq int8 (k, k, Cin, Cout), sw (Cout,) f32)}``
    for every ConvBN: per-output-channel symmetric int8 weights, the same
    formula (and float32 arithmetic) as the reference's host table."""
    table: WeightTable = {}
    for name, mod in model.named_modules():
        if isinstance(mod, ConvBN):
            kf = mod.conv.weight.detach().float().permute(2, 3, 1, 0)  # HWIO
            sw = kf.abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
            wq = torch.round(torch.clamp(kf / sw, -127.0, 127.0)).to(torch.int8)
            table[name] = (wq.contiguous(), sw)
    return table


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division, as XLA's (CUDA divides by a host
    scalar through its reciprocal, which can move the quotient by one ulp
    and a value across a rounding boundary of the int8 lattice)."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def conv_geometry(k: int, s: int, h: int, w: int) -> Dict[str, Any]:
    """``{"k", "stride", "pads": (top, bottom, left, right), "out_hw"}`` of
    a k x k stride-s SAME conv on an h x w input: the one place that maps
    the port's Conv onto an explicit conv (the int8 paths here;
    ``train/qat.py`` runs ``models/layers.py::conv_nhwc``, as the Conv)."""
    pads = (*same_pads(h, k, s), *same_pads(w, k, s))
    out_hw = ((h + pads[0] + pads[1] - k) // s + 1, (w + pads[2] + pads[3] - k) // s + 1)
    return {"k": k, "stride": s, "pads": pads, "out_hw": out_hw}


def im2col_int8(xq: torch.Tensor, geo: Dict[str, Any], kp: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B*Ho*Wo, kp) int8: the SAME-padded k x k
    windows, K index ``(dy*k + dx)*C + c``, zero padded to ``kp`` columns."""
    k, s, (pt, pb, pl, pr) = geo["k"], geo["stride"], geo["pads"]
    ho, wo = geo["out_hw"]
    if pt or pb or pl or pr:
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
    B, C = xq.shape[0], xq.shape[-1]
    taps = [xq[:, dy:dy + s * (ho - 1) + 1:s, dx:dx + s * (wo - 1) + 1:s, :]
            for dy in range(k) for dx in range(k)]
    if kp > k * k * C:
        taps.append(xq.new_zeros((B, ho, wo, kp - k * k * C)))
    cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    return cols.reshape(B * ho * wo, kp)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Int8Conv(nn.Module):
    """A Conv as W8A8 (``_int8_conv`` / ``_int8_conv_static``): the input
    quantized per tensor, ``round(clip(x / sx, +-127))``, with the dynamic
    ``sx = max|x| / 127 + 1e-8`` (``sx=None``) or a calibrated static
    ``sx``; per-output-channel int8 weights ``sw = max|w| / 127 + 1e-12``
    (quantized once, here: the reference's in-program formula); the int32
    sum times ``sx * sw``, plus the bias in float32, cast to the module's
    dtype. The scale stays a device tensor: no host sync per conv.

    CUDA tensors: ``int8_conv_mm``, ``torch._int_mm`` of the im2col and the
    (N, K) weight matrix, zero padded so that M > 16 and K, N are multiples
    of 8 (exact: zero rows and columns add nothing). CPU tensors: the plain
    version, ``int8_conv_reference``. ``Int8Conv.mm_launches`` counts the
    ``_int_mm`` calls made on the card (not those a ``torch.export`` trace
    records). ``reducer`` (``parallel/reduce.py``) takes the dynamic scale's
    max over the global batch of a data-parallel pipeline, as the
    reference's GSPMD does."""

    mm_launches = 0
    reducer: BatchReducer = LOCAL

    def __init__(self, conv: Conv, sx: Optional[float]):
        super().__init__()
        if conv.groups != 1 or conv.dilation != (1, 1):
            raise ValueError("Int8Conv: groups and dilation are not supported")
        w = conv.weight.detach().to(torch.float32)
        sw = div127(w.abs().amax(dim=(1, 2, 3))) + 1e-12
        wq = torch.round(torch.clamp(w / sw[:, None, None, None], -127, 127)).to(torch.int8)
        cout, cin, k, _ = wq.shape
        self.k, self.stride, self.dtype = k, conv.stride[0], conv.dtype
        self.cin, self.cout = cin, cout
        self.kp, self.npad = _round_up(k * k * cin, 8), _round_up(cout, 8)
        wmat = torch.zeros((self.npad, self.kp), dtype=torch.int8, device=w.device)
        wmat[:cout, :k * k * cin] = wq.permute(0, 2, 3, 1).reshape(cout, k * k * cin)
        self.register_buffer("wmat", wmat)
        self.register_buffer("sw", sw)
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().to(torch.float32).clone())
        self.register_buffer("sx", None if sx is None
                             else torch.tensor(float(sx), dtype=torch.float32, device=w.device))

    @property
    def weight_oihw(self) -> torch.Tensor:
        """The int8 weights (Cout, Cin, k, k)."""
        k = self.k
        return (self.wmat[:self.cout, :k * k * self.cin]
                .reshape(self.cout, k, k, self.cin).permute(0, 3, 1, 2))

    def quantize(self, x: torch.Tensor):
        """(xq int8, sx float32 tensor) of the input."""
        xf = x.to(torch.float32)
        sx = div127(self.reducer.max(xf.abs())) + 1e-8 if self.sx is None else self.sx
        return torch.round(torch.clamp(xf / sx, -127, 127)).to(torch.int8), sx

    def int8_conv(self, xq: torch.Tensor) -> torch.Tensor:
        """The int32 conv sums of an int8 NHWC input."""
        if xq.device.type == "cpu":
            return int8_conv_reference(self, xq)
        if xq.device.type != "cuda":
            raise ValueError(f"Int8Conv: no int8 product for device {xq.device}")
        acc = int8_conv_mm(self, xq)
        if not torch.compiler.is_compiling():  # a call, not a trace by cli.export
            Int8Conv.mm_launches += 1
        return acc

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        xq, sx = self.quantize(x)
        y = self.int8_conv(xq).to(torch.float32) * (sx * self.sw)
        if self.bias is not None:
            y = y + self.bias
        return y.to(dtype or self.dtype)


launch_counter(Int8Conv, "mm_launches")


def int8_conv_mm(conv: Int8Conv, xq: torch.Tensor) -> torch.Tensor:
    """``Int8Conv.int8_conv``'s product on the card: ``torch._int_mm`` of
    the im2col (rows padded to 32 when M <= 16) and the (Np, Kp) weight
    matrix, transposed (column-major, as cuBLASLt's int8 GEMM takes it)."""
    geo = conv_geometry(conv.k, conv.stride, xq.shape[1], xq.shape[2])
    cols = im2col_int8(xq, geo, conv.kp)
    m = cols.shape[0]
    if m <= 16:  # _int_mm takes M > 16
        cols = torch.cat([cols, cols.new_zeros((32 - m, conv.kp))])
    acc = torch._int_mm(cols, conv.wmat.t())
    ho, wo = geo["out_hw"]
    return acc[:m, :conv.cout].reshape(xq.shape[0], ho, wo, conv.cout)


def int8_conv_reference(conv: Int8Conv, xq: torch.Tensor) -> torch.Tensor:
    """Plain version of ``Int8Conv.int8_conv``: the SAME conv of the lattice
    values in float64 (exact: every partial sum is an integer below
    2^53), returned as int32."""
    geo = conv_geometry(conv.k, conv.stride, xq.shape[1], xq.shape[2])
    pt, pb, pl, pr = geo["pads"]
    xc = F.pad(xq.to(torch.float64).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    acc = F.conv2d(xc, conv.weight_oihw.to(torch.float64), stride=geo["stride"])
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def swap_int8(model: nn.Module, scales: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Swap, in place, every Conv for an ``Int8Conv``: with dynamic scales
    when ``scales`` is None (``w8a8_inference``), else with its calibrated
    ``scales[name]`` (``w8a8_static_inference``; ``{conv module name:
    sx}``), where a conv without a scale stays fp. A ``SpatialConv3x3`` is
    no ``Conv`` and stays fp, as the reference's interceptors leave it.
    Returns ``{"int8": n, "fp": m, "fp_convs": [names]}``. Raises when
    nothing was swapped."""
    counts: Dict[str, Any] = {"int8": 0, "fp": 0, "fp_convs": []}
    for pname, parent in list(model.named_modules()):
        for cname, child in list(parent.named_children()):
            if not isinstance(child, Conv):
                continue
            name = f"{pname}.{cname}" if pname else cname
            if scales is not None and name not in scales:
                counts["fp"] += 1
                counts["fp_convs"].append(name)
                continue
            setattr(parent, cname, Int8Conv(child, None if scales is None else scales[name]))
            counts["int8"] += 1
    if not counts["int8"]:
        raise ValueError("swap_int8: no conv matched the calibrated scales")
    return counts


def _bn_affine(bn: Optional[nn.Module], conv: Conv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm (with its own eps) as a per-channel f32 affine
    (a, b); without BN, a = 1 and b = the conv bias (or 0)."""
    cout = conv.weight.shape[0]
    if isinstance(bn, BatchNorm):
        a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        return a, bn.bias.float() - bn.running_mean.float() * a
    if bn is not None:
        raise ValueError(f"cannot run fused: BN module {type(bn).__name__} "
                         "(folded BN and the fused epilogue exclude each other)")
    ones = torch.ones(cout, device=conv.weight.device)
    b = conv.bias.float() if conv.bias is not None else torch.zeros_like(ones)
    return ones, b


class FusedConvBN(nn.Module):
    """A ConvBN body (conv + BN affine + activation) as one fused int8 kernel
    call: quantize with the calibrated ``sx``, int8 conv, epilogue
    ``acc * (sx * sw * a) + b`` and the module's activation. The kernel's
    packed weight image is made once, here, and moves with the module."""

    def __init__(self, mod: ConvBN, sx: float, wq_sw):
        super().__init__()
        if mod.stride != 1 or mod.kernel not in (1, 3) or mod.act not in ACTS:
            raise ValueError("cannot run fused: stride-1 1x1/3x3 ConvBN only")
        wq, sw = wq_sw
        a, b = _bn_affine(mod.bn, mod.conv)
        self.act, self.out_dtype, self.inv_sx = mod.act, mod.dtype, 1.0 / float(sx)
        self.register_buffer("wq", wq.contiguous())
        self.register_buffer("wpack", pack_qconv_weights(wq))
        self.register_buffer("scale", (float(sx) * sw * a).contiguous())
        self.register_buffer("bias", b.contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_qconv(x.contiguous(), self.wq, self.scale, self.bias,
                           inv_sx=self.inv_sx, act=self.act, out_dtype=self.out_dtype,
                           w_packed=self.wpack)


class ChainedResBlock(nn.Module):
    """An int8-resident ResBlock: c1's epilogue requantizes straight into
    c2's calibrated lattice, so the c1 -> c2 buffer is int8 and c2 skips its
    input quantize. The lattice values equal the unchained path's."""

    def __init__(self, block: ResBlock, sx: Dict[str, float], wtab: Dict[str, tuple]):
        super().__init__()
        self.c1 = FusedConvBN(block.c1, sx["c1"], wtab["c1"])
        self.c2 = FusedConvBN(block.c2, sx["c2"], wtab["c2"])
        self.proj = (FusedConvBN(block.proj, sx["proj"], wtab["proj"])
                     if block.proj is not None else None)
        self.act, self.dtype = block.act, block.dtype
        self.inv_s_mid = 1.0 / float(sx["c2"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        c1, c2 = self.c1, self.c2
        h_q = fused_qconv(x, c1.wq, c1.scale, c1.bias, inv_sx=c1.inv_sx, act=c1.act,
                          out_dtype=torch.int8, inv_s_out=self.inv_s_mid, w_packed=c1.wpack)
        h = fused_qconv(h_q, c2.wq, c2.scale, c2.bias, inv_sx=None, act=c2.act,
                        out_dtype=c2.out_dtype, w_packed=c2.wpack)
        if self.proj is not None:
            x = self.proj(x)
        return ACTS[self.act](x.to(self.dtype) + h)


def swap_fused(model: nn.Module, scales: Dict[str, float], weight_table: WeightTable,
               chain: bool = False) -> Dict[str, int]:
    """Swap, in place, every eligible ConvBN for a ``FusedConvBN`` and (with
    ``chain``) every fully calibrated ResBlock for a ``ChainedResBlock``.

    ``scales`` is ``{conv module name: sx}`` (``calibrate_activation_scales``
    or ``convert.convert_scales`` of a reference table); ``weight_table`` is
    ``prequantize_fused_weights(model)``. Returns ``{"convbn": n,
    "resblock": m, "calls": fused kernel calls per forward}``. Raises if a
    selected module cannot run fused (missing weights, unknown activation,
    a folded BN)."""
    counts = {"convbn": 0, "resblock": 0, "calls": 0}

    def visit(parent: nn.Module, prefix: str):
        for cname, child in list(parent.named_children()):
            name = f"{prefix}{cname}"
            pre = name + "."
            if chain and isinstance(child, ResBlock):
                parts = ["c1", "c2"] + (["proj"] if child.proj is not None else [])
                if all(f"{pre}{p}.conv" in scales for p in parts):
                    missing = [p for p in parts if f"{pre}{p}" not in weight_table]
                    if missing:
                        raise ValueError(f"swap_fused: {name} selected for chaining "
                                         f"but the weight table lacks {missing}")
                    setattr(parent, cname, ChainedResBlock(
                        child, {p: scales[f"{pre}{p}.conv"] for p in parts},
                        {p: weight_table[f"{pre}{p}"] for p in parts}))
                    counts["resblock"] += 1
                    counts["calls"] += len(parts)
                    continue
            # A SpatialConv3x3 stays in fp, as the reference's interceptor
            # leaves a ConvBN with a spatial mesh (quantize.py:483-488).
            if (isinstance(child, ConvBN) and f"{pre}conv" in scales
                    and isinstance(child.conv, Conv)
                    and child.stride == 1 and child.kernel in (1, 3)):
                if name not in weight_table:
                    raise ValueError(f"swap_fused: {name} selected but the weight "
                                     "table has no entry for it")
                setattr(parent, cname, FusedConvBN(child, scales[f"{pre}conv"],
                                                   weight_table[name]))
                counts["convbn"] += 1
                counts["calls"] += 1
                continue
            visit(child, pre)

    visit(model, "")
    return counts
