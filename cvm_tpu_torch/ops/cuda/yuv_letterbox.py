"""The eval preprocess of planar YUV420 as one kernel: the Hopper kernel's
wrapper and its plain version.

One pass over a batch's uint8 planes computes what
``pipeline/preprocess.py::preprocess_yuv420_batch`` computes without
training draws: each image's letterbox ROI from its valid size
(``letterbox_roi``), the three bilinear resamples through it
(``resample_yuv420_frame``), the colour convert, ``normalize_pm1`` and the
cast to bf16 or float32. It rounds where PyTorch's eager sequence of those
ops rounds on the card, so the two agree bit for bit there
(``csrc/yuv_letterbox.cu`` says how). It replaces no TPU kernel: XLA fuses
the reference's preprocess, while PyTorch runs it as ~222 kernels.

``yuv_letterbox`` calls the PyTorch custom op ``cvm_tpu_torch::yuv_letterbox``
(registered when this module is imported), so ``torch.export`` records the
call in a serving program (``cli/export.py``), whichever device it is
exported on. The op returns the image batch, a (B, 8) float32 table of the
ROI's fields and its (B,) ``flip_x`` (all false); ``yuv_letterbox`` turns the
table's columns into a ``Roi``. Its CUDA implementation launches
``csrc/yuv_letterbox.cu``; its CPU implementation is the plain version,
``yuv_letterbox_reference`` (the eager ops themselves), and only CPU tensors
reach it. A CUDA tensor never reaches the plain version through the op: a
tensor the kernel does not take raises, and so does a failed build or
launch. The sizes are read on the device as the kernel runs, so a captured
CUDA graph serves whatever sizes each replay brings.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from cvm_tpu_torch.ops.image import Roi, letterbox_roi, normalize_pm1, resample_yuv420_frame
from cvm_tpu_torch.utils.prof import launch_counter

OUT_DTYPES = (torch.bfloat16, torch.float32)
_MAX_ROWS = 8        # output rows per block, at most (csrc/yuv_letterbox.cu kMaxRows)
_COLS = 128          # output columns per block (kCols)
_BLOCKS_PER_SM = 4   # the grid the wrapper aims for
# csrc/yuv_letterbox.cu's yuv_letterbox_launch: seven pointers, nine ints, the stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _check(y, u, v, image_hw, out_hw, out_dtype):
    for name, t in (("y", y), ("u", u), ("v", v)):
        if t.dtype != torch.uint8 or t.dim() != 3:
            raise TypeError(f"yuv_letterbox: {name} must be a uint8 (B, H, W) plane, got "
                            f"{t.dtype} {tuple(t.shape)}")
    B = y.shape[0]
    if u.shape != v.shape or u.shape[0] != B:
        raise ValueError(f"yuv_letterbox: u and v must be (B, Hc, Wc) planes of y's batch "
                         f"{B}, got {tuple(u.shape)} and {tuple(v.shape)}")
    if image_hw.dtype != torch.int32 or image_hw.shape != (B, 2):
        raise TypeError(f"yuv_letterbox: image_hw must be int32 ({B}, 2), got "
                        f"{image_hw.dtype} {tuple(image_hw.shape)}")
    if len(out_hw) != 2 or min(out_hw) < 1:
        raise ValueError(f"yuv_letterbox: out_hw must be two positive sizes, got {out_hw}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"yuv_letterbox: out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    devs = {t.device for t in (y, u, v, image_hw)}
    if len(devs) != 1:
        raise ValueError(f"yuv_letterbox: tensors on different devices {devs}")


def yuv_letterbox_reference(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                            image_hw: torch.Tensor, out_hw: Sequence[int],
                            out_dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, Roi]:
    """Plain PyTorch version of ``yuv_letterbox``, with its arguments and
    results: the eager ops of the eval preprocess."""
    _check(y, u, v, image_hw, out_hw, out_dtype)
    roi = letterbox_roi(image_hw[:, 0], image_hw[:, 1], out_hw[0], out_hw[1])
    out = resample_yuv420_frame(y, u, v, image_hw, roi, tuple(out_hw))
    return normalize_pm1(out).to(out_dtype), roi


def _plain(y, u, v, image_hw, out_hw, out_dtype):
    """The op's CPU implementation: the plain version, its ROI as the op's
    (B, 8) table and ``flip_x``."""
    image, roi = yuv_letterbox_reference(y, u, v, image_hw, out_hw, out_dtype)
    return image, torch.stack(roi[:8], dim=1), roi.flip_x


def _lib():
    from cvm_tpu_torch.ops.cuda._build import load_library

    fn = load_library("yuv_letterbox").yuv_letterbox_launch
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows_per_block(batch: int, out_hw: Sequence[int], sms: int) -> int:
    """Output rows per block: the most, up to 8, that leave the grid about
    4 blocks per SM (csrc/yuv_letterbox.cu, Design)."""
    chunks = -(-out_hw[1] // _COLS)
    return max(1, min(_MAX_ROWS, batch * out_hw[0] * chunks // (_BLOCKS_PER_SM * sms)))


def _launch(y, u, v, image_hw, out_hw, out_dtype):
    """The op's CUDA implementation: one launch of the kernel."""
    _check(y, u, v, image_hw, out_hw, out_dtype)
    (B, Hm, Wm), (Hc, Wc) = y.shape, u.shape[1:]
    H, W = out_hw
    if B > 65535 or H > 65535 or Hm * Wm >= 2 ** 31 or Hc * Wc >= 2 ** 31:
        raise ValueError(f"yuv_letterbox: batch {B}, planes {Hm}x{Wm} or output height {H} "
                         "beyond what the kernel takes")
    out = torch.empty((B, H, W, 3), dtype=out_dtype, device=y.device)
    roi = torch.empty((B, 8), dtype=torch.float32, device=y.device)
    flip = torch.empty((B,), dtype=torch.bool, device=y.device)
    if B == 0:
        return out, roi, flip
    y, u, v, image_hw = (t.contiguous() for t in (y, u, v, image_hw))
    rows = _rows_per_block(B, out_hw, _sms(y.device.index if y.device.index is not None
                                          else torch.cuda.current_device()))
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib()(y.data_ptr(), u.data_ptr(), v.data_ptr(), image_hw.data_ptr(),
                     out.data_ptr(), roi.data_ptr(), flip.data_ptr(), B, Hm, Wm, Hc, Wc, H, W,
                     rows,
                     int(out_dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"yuv_letterbox kernel launch failed: cudaError {err}")
    yuv_letterbox.launches += 1
    return out, roi, flip


def _fake(y, u, v, image_hw, out_hw, out_dtype):
    _check(y, u, v, image_hw, out_hw, out_dtype)
    B = y.shape[0]
    return (y.new_empty((B, out_hw[0], out_hw[1], 3), dtype=out_dtype),
            y.new_empty((B, 8), dtype=torch.float32), y.new_empty((B,), dtype=torch.bool))


# On a ``torch.library.Library``, as ``conv_epilogue``: ``custom_op`` would
# import ``torch._dynamo`` at the first call.
_LIB = torch.library.Library("cvm_tpu_torch", "FRAGMENT")
_LIB.define("yuv_letterbox(Tensor y, Tensor u, Tensor v, Tensor image_hw, int[2] out_hw, "
            "ScalarType out_dtype) -> (Tensor, Tensor, Tensor)")
_LIB.impl("yuv_letterbox", _plain, "CPU")
_LIB.impl("yuv_letterbox", _launch, "CUDA")
torch.library.register_fake("cvm_tpu_torch::yuv_letterbox", _fake, lib=_LIB)


def yuv_letterbox(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, image_hw: torch.Tensor,
                  out_hw: Sequence[int], out_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, Roi]:
    """y (B, Hm, Wm), u and v (B, Hc, Wc) uint8 planes; image_hw (B, 2)
    valid luma sizes (int32, or converted to it) -> ((B, H, W, 3) letterboxed
    pm1 values in ``out_dtype`` (bf16 or float32), the letterbox ``Roi``).
    Through the custom op: CPU tensors take the plain version, CUDA tensors
    the kernel; any other device raises."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"yuv_letterbox: no kernel for device {y.device}")
    image, table, flip = torch.ops.cvm_tpu_torch.yuv_letterbox(
        y, u, v, image_hw.to(torch.int32), list(out_hw), out_dtype)
    return image, Roi(*table.unbind(1), flip)


yuv_letterbox.launches = 0  # kernel launches (CUDA tensors only)
launch_counter(yuv_letterbox, "launches")
