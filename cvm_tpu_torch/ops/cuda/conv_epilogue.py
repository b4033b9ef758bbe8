"""The BN-folded conv's epilogue: the Hopper kernel's wrapper and its plain
version.

After cuDNN's bf16 conv, one pass over its NHWC output ``y`` computes
``act(bf16(bf16(y + bias) + residual))``: the folded BatchNorm's bias (or
the conv's own), optionally a residual, and silu / relu / nothing, in bf16
or, for a head's projection, widened to float32. It rounds where PyTorch's
eager sequence of those ops rounds, so the two agree bit for bit
(``csrc/conv_epilogue.cu`` says how). It replaces no TPU kernel: XLA fuses
the reference's bias, residual and silu into its conv.

``conv_epilogue`` calls the PyTorch custom op ``cvm_tpu_torch::conv_epilogue``
(registered when this module is imported), so ``torch.export`` records the
call in a serving program (``cli/export.py``). Its CUDA implementation
launches ``csrc/conv_epilogue.cu``; its CPU implementation is the plain
version, ``conv_epilogue_reference``, and only CPU tensors reach it. A CUDA
tensor never reaches the plain version through the op: a tensor the kernel
does not take raises, and so does a failed build or launch. The output is a
new tensor (a custom op's output may not alias its inputs).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from cvm_tpu_torch.utils.prof import launch_counter

_ACT = {None: 0, "silu": 1, "relu": 2}
_OUT = (torch.bfloat16, torch.float32)


def _check(y, bias, residual, act, out_dtype):
    if y.dim() < 1 or y.dtype != torch.bfloat16:
        raise TypeError(f"conv_epilogue: y must be bf16 (..., C), got {y.dtype} "
                        f"{tuple(y.shape)}")
    if bias.shape != (y.shape[-1],) or bias.dtype != torch.bfloat16:
        raise ValueError(f"conv_epilogue: bias must be ({y.shape[-1]},) bf16, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if residual is not None and (residual.shape != y.shape
                                 or residual.dtype != torch.bfloat16):
        raise ValueError(f"conv_epilogue: residual must be bf16 {tuple(y.shape)}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    if act not in _ACT:
        raise ValueError(f"conv_epilogue: act must be one of {list(_ACT)}, got {act!r}")
    if out_dtype not in _OUT:
        raise TypeError(f"conv_epilogue: out_dtype must be one of {_OUT}, got {out_dtype}")
    devs = {t.device for t in (y, bias, residual) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"conv_epilogue: tensors on different devices {devs}")


def conv_epilogue_reference(y: torch.Tensor, bias: torch.Tensor,
                            residual: Optional[torch.Tensor] = None,
                            act: Optional[str] = None,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: the eager ops a folded ConvBN, a ResBlock's
    sum and a head's widening run, in bf16."""
    _check(y, bias, residual, act, out_dtype)
    v = y + bias
    if residual is not None:
        v = residual + v
    if act == "silu":
        v = F.silu(v)
    elif act == "relu":
        v = F.relu(v)
    return v.to(out_dtype)


def _lib():
    from cvm_tpu_torch.ops.cuda._build import load_library

    fn = load_library("conv_epilogue").conv_epilogue_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, L, I, I, I, I, P]
        fn.restype = I
    return fn


def _launch(y, bias, residual, act, out_dtype):
    """The op's CUDA implementation: one launch of the kernel."""
    _check(y, bias, residual, act, out_dtype)
    y = y.contiguous()
    residual = None if residual is None else residual.contiguous()
    C = y.shape[-1]
    rows = y.numel() // C if C else 0
    if rows == 0 or rows * C >= 2 ** 31:
        raise ValueError(f"conv_epilogue: y {tuple(y.shape)} is empty or has 2^31 elements "
                         "or more")
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    ptrs = [t.data_ptr() for t in (y, bias, out) + ((residual,) if residual is not None else ())]
    vec = 8 if C % 8 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    if C // vec > 1024:
        raise ValueError(f"conv_epilogue: C={C} is wider than the kernel takes "
                         f"({8192 if vec == 8 else 1024} with this alignment)")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib()(y.data_ptr(), None if residual is None else residual.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), rows, C, vec, _ACT[act],
                     int(out_dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: cudaError {err}")
    conv_epilogue.launches += 1
    return out


def _fake(y, bias, residual, act, out_dtype):
    _check(y, bias, residual, act, out_dtype)
    return y.new_empty(y.shape, dtype=out_dtype)


# The op is defined on a ``torch.library.Library`` and not with
# ``torch.library.custom_op``, which wraps each device kernel so that its
# first call imports ``torch._dynamo``: seconds of a serving process's
# set-up on the H100's host, for a dispatch that needs none of it.
_LIB = torch.library.Library("cvm_tpu_torch", "FRAGMENT")
_LIB.define("conv_epilogue(Tensor y, Tensor bias, Tensor? residual, str? act, "
            "ScalarType out_dtype) -> Tensor")
_LIB.impl("conv_epilogue", conv_epilogue_reference, "CPU")
_LIB.impl("conv_epilogue", _launch, "CUDA")
torch.library.register_fake("cvm_tpu_torch::conv_epilogue", _fake, lib=_LIB)


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y (..., C) bf16, a conv's NHWC output; bias (C,) bf16; residual None
    or bf16 like y -> act(bf16(bf16(y + bias) + residual)) in ``out_dtype``
    (bf16 or float32). Through the custom op: CPU tensors take the plain
    version, CUDA tensors the kernel; any other device raises."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue: no kernel for device {y.device}")
    return torch.ops.cvm_tpu_torch.conv_epilogue(y, bias, residual, act, out_dtype)


conv_epilogue.launches = 0  # kernel launches (CUDA tensors only)
launch_counter(conv_epilogue, "launches")
