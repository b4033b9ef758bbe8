"""Fused W8A8 ConvBN: the Hopper kernel's wrapper and its plain version.

Mirrors ``cvm_tpu/ops/pallas/fused_qconv.py``: a stride-1 SAME NHWC conv,
1x1 or 3x3. The input is quantized as ``round(clip(x * inv_sx, +-127))`` (or
taken as int8 lattice points when ``inv_sx is None``), multiplied by int8
per-output-channel weights with int32 accumulation, then the f32 epilogue
``acc * scale + bias`` and silu / relu / nothing; optionally requantized into
the consumer's lattice (``inv_s_out``, int8 out).

``fused_qconv`` calls the PyTorch custom op ``cvm_tpu_torch::fused_qconv``
(registered when this module is imported), so ``torch.export`` records the
call in a serving program (``cli/export.py``). Its CUDA implementation
launches ``csrc/fused_qconv.cu``; its CPU implementation is the plain
version, ``fused_qconv_reference``, and only CPU tensors reach it. A CUDA
tensor never reaches the plain version through the op: a tensor the kernel
does not take raises, and so does a failed build or launch. The op's fake
implementation gives each mode's output shape and dtype.

The kernel reads its weights from a packed image (``pack_qconv_weights``):
per Cout tile, per 32-wide Cin chunk and per tap, a K-major int8 slab laid
out as the kernel's shared memory holds it, so one pipeline stage's weights
are one contiguous bulk copy. Modules pack once (``infer/quantize.py``
``FusedConvBN``) and pass the image as ``w_packed``; a call without it
packs on the spot and counts ``fused_qconv.weight_packs``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cvm_tpu_torch.utils.prof import launch_counter

_X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ACT = {None: 0, "silu": 1, "relu": 2}
CK = 32          # Cin chunk: one int8 wgmma k-step
FOLD_K = 128     # a 3x3 conv with 9*Cin <= FOLD_K folds its taps into K
# The kernel copies whole 16-B channel groups (4-B ones when folded): x's
# channels are zero padded to a multiple of this many bytes.
_CIN_BYTES = {False: 16, True: 4}


class QConvPlan(NamedTuple):
    """How the kernel tiles one conv: ``bn`` output channels per block (64 or
    128), ``ntiles`` Cout tiles, ``nch`` 32-wide Cin chunks; with ``fold``
    the 3x3 taps fold into one K of ``kf`` (= 9*Cin padded to 32)."""
    bn: int
    ntiles: int
    nch: int
    fold: bool
    kf: int


def qconv_plan(k: int, cin: int, cout: int) -> QConvPlan:
    bn = 64 if cout <= 64 else 128
    fold = k == 3 and 9 * cin <= FOLD_K and cout <= bn
    kf = -(-9 * cin // CK) * CK if fold else 0
    return QConvPlan(bn, -(-cout // bn), -(-cin // CK), fold, kf)


def pack_qconv_weights(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO int8 weights (k, k, Cin, Cout) -> the kernel's flat int8 image.

    Unfolded: ``[ntiles][nch][k*k taps][2 K halves][bn][16]`` -- for Cout
    tile t, Cin chunk c and tap (dy, dx), byte ``[h][n][e]`` is
    ``w[dy, dx, 32c + 16h + e, t*bn + n]``. Folded (3x3, 9*Cin <= 128, one
    Cout tile):
    ``[ntiles][kf/16][bn][16]`` with K index ``(3*dy + dx)*Cin + ci``. Zero
    beyond Cin, Cout and 9*Cin. A plain tensor function on w_q's device."""
    if w_q.dim() != 4 or w_q.dtype != torch.int8 or w_q.shape[0] != w_q.shape[1]:
        raise ValueError(f"pack_qconv_weights: int8 (k, k, Cin, Cout), got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    k, _, cin, cout = w_q.shape
    p = qconv_plan(k, cin, cout)
    if p.fold:
        w = torch.zeros((p.kf, p.ntiles * p.bn), dtype=torch.int8, device=w_q.device)
        w[:9 * cin, :cout] = w_q.reshape(9 * cin, cout)
        w = w.view(p.kf // 16, 16, p.ntiles, p.bn).permute(2, 0, 3, 1)
    else:
        w = torch.zeros((k * k, p.nch * CK, p.ntiles * p.bn), dtype=torch.int8,
                        device=w_q.device)
        w[:, :cin, :cout] = w_q.reshape(k * k, cin, cout)
        w = w.view(k * k, p.nch, 2, 16, p.ntiles, p.bn).permute(4, 1, 0, 2, 5, 3)
    return w.contiguous().reshape(-1)


def unpack_qconv_weights(image: torch.Tensor, k: int, cin: int, cout: int) -> torch.Tensor:
    """The inverse of ``pack_qconv_weights``: the HWIO int8 weights."""
    p = qconv_plan(k, cin, cout)
    if p.fold:
        w = image.view(p.ntiles, p.kf // 16, p.bn, 16).permute(1, 3, 0, 2)
        w = w.reshape(p.kf, p.ntiles * p.bn)[:9 * cin, :cout]
        return w.reshape(3, 3, cin, cout).contiguous()
    w = image.view(p.ntiles, p.nch, k * k, 2, p.bn, 16).permute(2, 1, 3, 5, 0, 4)
    w = w.reshape(k * k, p.nch * CK, p.ntiles * p.bn)[:, :cin, :cout]
    return w.reshape(k, k, cin, cout).contiguous()


def packed_numel(k: int, cin: int, cout: int) -> int:
    p = qconv_plan(k, cin, cout)
    if p.fold:
        return p.ntiles * p.kf * p.bn
    return p.ntiles * p.nch * k * k * 2 * p.bn * 16


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cin_split(plan: QConvPlan, B: int, H: int, W: int, sms: int) -> int:
    """Blocks of a cluster that share one tile's Cin chunks: 2-4 where the
    call has fewer 128-pixel tiles than SMs (the deep s5 and up0 convs);
    otherwise 1, and each block walks several tiles."""
    if plan.fold:
        return 1
    blocks = B * -(-H // 16) * -(-W // 8) * plan.ntiles
    return max(1, min(4, sms // blocks, plan.nch))


def _check(x, w_q, scale, bias, inv_sx, act, out_dtype, inv_s_out):
    if x.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"fused_qconv: x must be (B,H,W,Cin) and w_q "
                         f"(k,k,Cin,Cout); got {tuple(x.shape)}, {tuple(w_q.shape)}")
    kh, kw, wcin, cout = w_q.shape
    if (kh, kw) not in ((1, 1), (3, 3)):
        raise ValueError(f"fused_qconv: 1x1/3x3 only, got {kh}x{kw}")
    if wcin != x.shape[-1]:
        raise ValueError(f"fused_qconv: w_q Cin {wcin} != x Cin {x.shape[-1]}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"fused_qconv: w_q must be int8, got {w_q.dtype}")
    for name, v in (("scale", scale), ("bias", bias)):
        if v.shape != (cout,) or v.dtype != torch.float32:
            raise ValueError(f"fused_qconv: {name} must be ({cout},) float32, "
                             f"got {tuple(v.shape)} {v.dtype}")
    if x.dtype not in _X_KIND:
        raise TypeError(f"fused_qconv: x dtype {x.dtype} not in {list(_X_KIND)}")
    if (inv_sx is None) != (x.dtype == torch.int8):
        raise ValueError("fused_qconv: inv_sx=None takes an int8 lattice input, "
                         "and an int8 input needs inv_sx=None")
    if act not in _ACT:
        raise ValueError(f"fused_qconv: act must be one of {list(_ACT)}, got {act!r}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"fused_qconv: out_dtype {out_dtype} not in {list(_OUT_KIND)}")
    if (inv_s_out is None) == (out_dtype == torch.int8):
        raise ValueError("fused_qconv: inv_s_out (requant into the consumer's "
                         "lattice) goes with out_dtype=int8 and only with it")
    devs = {t.device for t in (x, w_q, scale, bias)}
    if len(devs) != 1:
        raise ValueError(f"fused_qconv: tensors on different devices {devs}")


def fused_qconv_reference(x, w_q, scale, bias, *, inv_sx: Optional[float],
                          act: Optional[str] = "silu",
                          out_dtype: torch.dtype = torch.bfloat16,
                          inv_s_out: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: explicit quantize, conv of the lattice values
    in f64, f32 epilogue. The f64 sum of lattice products is exact, as the
    kernel's int32 sum is (an f32 conv is not: cuDNN may take a Winograd or
    FFT algorithm that rounds); it is then rounded to f32 once, as the
    kernel converts its int32 sum."""
    _check(x, w_q, scale, bias, inv_sx, act, out_dtype, inv_s_out)
    if inv_sx is None:
        q = x.float()
    else:
        q = torch.round(torch.clamp(x.float() * inv_sx, -127.0, 127.0))
    k = w_q.shape[0]
    acc = F.conv2d(q.double().permute(0, 3, 1, 2), w_q.double().permute(3, 2, 0, 1),
                   padding=k // 2).permute(0, 2, 3, 1).float()
    y = acc * scale + bias
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act == "relu":
        y = torch.clamp_min(y, 0.0)
    if inv_s_out is not None:
        return torch.round(torch.clamp(y * inv_s_out, -127.0, 127.0)).to(torch.int8)
    return y.to(out_dtype).contiguous()


def _lib():
    from cvm_tpu_torch.ops.cuda._build import load_library

    lib = load_library("fused_qconv")
    fn = lib.fused_qconv_launch
    if fn.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, Fl, I, I, Fl, I, I, I, I, P]
        fn.restype = I
    return fn


def _launch(x, w_q, scale, bias, w_packed, inv_sx, act, out_dtype, inv_s_out):
    """The op's CUDA implementation: one launch of the kernel."""
    _check(x, w_q, scale, bias, inv_sx, act, out_dtype, inv_s_out)
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"fused_qconv: {name} must be contiguous")
    B, H, W, cin = x.shape
    k, cout = w_q.shape[0], w_q.shape[-1]
    if B * H * W * cin * cout == 0:
        raise ValueError(f"fused_qconv: empty shape x {tuple(x.shape)}, Cout {cout}")
    if w_packed is None:
        w_packed = pack_qconv_weights(w_q)
        fused_qconv.weight_packs += 1
    if (w_packed.dtype != torch.int8 or w_packed.device != x.device
            or not w_packed.is_contiguous() or w_packed.numel() != packed_numel(k, cin, cout)):
        raise ValueError(f"fused_qconv: w_packed is not pack_qconv_weights(w_q) for "
                         f"{tuple(w_q.shape)}")
    plan = qconv_plan(k, cin, cout)
    pad = -cin % (_CIN_BYTES[plan.fold] // x.element_size())
    if pad:  # zero channels are exact: they quantize to 0
        x = F.pad(x, (0, pad))
    if x.data_ptr() % 16:
        x = x.clone()
    split = cin_split(plan, B, H, W, _sm_count(x.device.index or 0))
    out = torch.empty((B, H, W, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), B, H, W, cin, x.shape[-1], cout, k,
                     _X_KIND[x.dtype], 0.0 if inv_sx is None else float(inv_sx), _ACT[act],
                     _OUT_KIND[out_dtype], 0.0 if inv_s_out is None else float(inv_s_out),
                     plan.bn, int(plan.fold), plan.kf, split, stream)
    if err != 0:
        raise RuntimeError(f"fused_qconv kernel launch failed: cudaError {err}")
    fused_qconv.launches += 1
    if out_dtype == torch.int8:
        fused_qconv.int8_out_launches += 1
    return out


@torch.library.custom_op("cvm_tpu_torch::fused_qconv", mutates_args=())
def fused_qconv_op(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   w_packed: Optional[torch.Tensor], inv_sx: Optional[float], act: Optional[str],
                   out_dtype: torch.dtype, inv_s_out: Optional[float]) -> torch.Tensor:
    """The custom op; ``fused_qconv`` (keyword arguments) is its front."""
    raise ValueError(f"fused_qconv: no kernel for device {x.device}")


@fused_qconv_op.register_kernel("cpu")
def _fused_qconv_cpu(x, w_q, scale, bias, w_packed, inv_sx, act, out_dtype, inv_s_out):
    return fused_qconv_reference(x, w_q, scale, bias, inv_sx=inv_sx, act=act,
                                 out_dtype=out_dtype, inv_s_out=inv_s_out)


@fused_qconv_op.register_kernel("cuda")
def _fused_qconv_cuda(x, w_q, scale, bias, w_packed, inv_sx, act, out_dtype, inv_s_out):
    return _launch(x, w_q, scale, bias, w_packed, inv_sx, act, out_dtype, inv_s_out)


@fused_qconv_op.register_fake
def _fused_qconv_fake(x, w_q, scale, bias, w_packed, inv_sx, act, out_dtype, inv_s_out):
    _check(x, w_q, scale, bias, inv_sx, act, out_dtype, inv_s_out)
    return x.new_empty((*x.shape[:3], w_q.shape[-1]), dtype=out_dtype)


def fused_qconv(x, w_q, scale, bias, *, inv_sx: Optional[float],
                act: Optional[str] = "silu",
                out_dtype: torch.dtype = torch.bfloat16,
                inv_s_out: Optional[float] = None,
                w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,H,W,Cin) f32/bf16, or int8 lattice points with inv_sx=None;
    w_q (k,k,Cin,Cout) int8; scale, bias (Cout,) f32 -> (B,H,W,Cout) of
    out_dtype. ``w_packed``: ``pack_qconv_weights(w_q)``, made once by the
    caller (the kernel reads only it). Through the custom op: CPU tensors
    take the plain version, CUDA tensors the kernel; any other device
    raises (a meta tensor would reach the op's fake implementation)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_qconv: no kernel for device {x.device}")
    return torch.ops.cvm_tpu_torch.fused_qconv(x, w_q, scale, bias, w_packed, inv_sx, act,
                                               out_dtype, inv_s_out)


fused_qconv.launches = 0           # kernel launches (CUDA tensors only)
fused_qconv.int8_out_launches = 0  # of which emitted int8 lattice points
fused_qconv.weight_packs = 0       # calls that had to pack w_q themselves
launch_counter(fused_qconv, "launches", "int8_out_launches", "weight_packs")


def reset_counts() -> None:
    fused_qconv.launches = 0
    fused_qconv.int8_out_launches = 0
    fused_qconv.weight_packs = 0
