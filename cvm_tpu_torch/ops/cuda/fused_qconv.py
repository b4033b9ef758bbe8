"""Fused W8A8 ConvBN: the Hopper kernel's wrapper and its plain version.

Mirrors ``cvm_tpu/ops/pallas/fused_qconv.py``: a stride-1 SAME NHWC conv,
1x1 or 3x3. The input is quantized as ``round(clip(x * inv_sx, +-127))`` (or
taken as int8 lattice points when ``inv_sx is None``), multiplied by int8
per-output-channel weights with int32 accumulation, then the f32 epilogue
``acc * scale + bias`` and silu / relu / nothing; optionally requantized into
the consumer's lattice (``inv_s_out``, int8 out).

``fused_qconv`` launches ``csrc/fused_qconv.cu`` for CUDA tensors and takes
the plain version, ``fused_qconv_reference``, only for CPU tensors. A CUDA
tensor never reaches the plain version through the wrapper: a tensor the
kernel does not take raises, and so does a failed build or launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ACT = {None: 0, "silu": 1, "relu": 2}


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
    in f32, f32 epilogue. Lattice values (|q| <= 127) are exact in f32 (and
    in TF32); the f32 sum is exact while partial sums stay below 2^24."""
    _check(x, w_q, scale, bias, inv_sx, act, out_dtype, inv_s_out)
    if inv_sx is None:
        q = x.float()
    else:
        q = torch.round(torch.clamp(x.float() * inv_sx, -127.0, 127.0))
    k = w_q.shape[0]
    acc = F.conv2d(q.permute(0, 3, 1, 2), w_q.float().permute(3, 2, 0, 1),
                   padding=k // 2).permute(0, 2, 3, 1)
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
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, Fl, I, I, Fl, P]
        fn.restype = I
    return fn


def fused_qconv(x, w_q, scale, bias, *, inv_sx: Optional[float],
                act: Optional[str] = "silu",
                out_dtype: torch.dtype = torch.bfloat16,
                inv_s_out: Optional[float] = None) -> torch.Tensor:
    """x (B,H,W,Cin) f32/bf16, or int8 lattice points with inv_sx=None;
    w_q (k,k,Cin,Cout) int8; scale, bias (Cout,) f32 -> (B,H,W,Cout) of
    out_dtype. CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return fused_qconv_reference(x, w_q, scale, bias, inv_sx=inv_sx, act=act,
                                     out_dtype=out_dtype, inv_s_out=inv_s_out)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qconv: no kernel for device {x.device}")
    _check(x, w_q, scale, bias, inv_sx, act, out_dtype, inv_s_out)
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"fused_qconv: {name} must be contiguous")
    B, H, W, cin = x.shape
    cout = w_q.shape[-1]
    if B * H * W * cin * cout == 0:
        raise ValueError(f"fused_qconv: empty shape x {tuple(x.shape)}, Cout {cout}")
    out = torch.empty((B, H, W, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), B, H, W, cin, cout,
                     w_q.shape[0], _X_KIND[x.dtype],
                     0.0 if inv_sx is None else float(inv_sx), _ACT[act],
                     _OUT_KIND[out_dtype],
                     0.0 if inv_s_out is None else float(inv_s_out), stream)
    if err != 0:
        raise RuntimeError(f"fused_qconv kernel launch failed: cudaError {err}")
    fused_qconv.launches += 1
    if out_dtype == torch.int8:
        fused_qconv.int8_out_launches += 1
    return out


fused_qconv.launches = 0           # kernel launches (CUDA tensors only)
fused_qconv.int8_out_launches = 0  # of which emitted int8 lattice points


def reset_counts() -> None:
    fused_qconv.launches = 0
    fused_qconv.int8_out_launches = 0
