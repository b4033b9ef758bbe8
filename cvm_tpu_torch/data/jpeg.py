"""Batch JPEG decode into padded host buffers: RGB or planar YUV420.

Mirrors ``cvm_tpu/native/__init__.py`` (``decode_jpeg_batch``,
``decode_jpeg_batch_yuv420``, ``_choose_scale_num``, ``_rgb_to_yuv420_np``,
``_yuv420_to_rgb_np``). The decoder is the one the caller's device implies,
and there is no other:

* ``device="cpu"``: ``csrc/jpeg_feeder.cc``, the port's copy of the
  reference's libjpeg decoder, built with the host compiler at first use
  (``ops/cuda/_build.py::load_host_library``): the same bytes decode to the
  same pixels as the reference's native path;
* a CUDA device: ``csrc/jpeg_nvjpeg.cu``, nvJPEG with libjpeg's post-IDCT
  arithmetic (chroma upsampling, color tables, reduced-scale averaging),
  for a card's machine that has no libjpeg.

Both write the same padded buffers through the same C interface. A decoder
that cannot be built raises and names what is missing (compiler, header,
library); the reference's PIL fallback is not ported. A JPEG that does not
decode still gives a zero frame (Y 0, U/V 128) with ``hw = (1, 1)``: that
is the data contract, masked downstream, not a fallback. A decoder that
fails on the card (a CUDA or nvJPEG fault, not the image's) raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    head = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong)]
    tail = [ctypes.c_int] * 4 + [ip, ip, ctypes.c_int]
    lib.cvm_decode_batch.restype = ctypes.c_int
    lib.cvm_decode_batch.argtypes = head + [u8p] + tail
    lib.cvm_decode_batch_yuv420.restype = ctypes.c_int
    lib.cvm_decode_batch_yuv420.argtypes = head + [u8p, u8p, u8p] + tail
    lib.cvm_decode_planes.restype = ctypes.c_int
    lib.cvm_decode_planes.argtypes = [ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int, u8p,
                                      ctypes.c_ulong, ip]
    return lib


def _declare_nvjpeg(lib: ctypes.CDLL) -> ctypes.CDLL:
    _declare(lib)
    lib.cvm_decode_set_device.restype = ctypes.c_int
    lib.cvm_decode_set_device.argtypes = [ctypes.c_int]
    lib.cvm_decode_last_error.restype = ctypes.c_char_p
    lib.cvm_decode_last_error.argtypes = []
    lib.cvm_decode_info.restype = ctypes.c_int
    lib.cvm_decode_info.argtypes = [ctypes.c_char_p, ctypes.c_ulong,
                                    ctypes.POINTER(ctypes.c_int)]
    return lib


# Faults of the decoder itself (csrc/jpeg_nvjpeg.cu), not of an image: codes
# 1-3 are the image's (unreadable, bad header, too large even at 1/8).
_DECODER_FAULTS = {4: "a CUDA call failed", 5: "the decoder could not start on the card",
                   6: "nvJPEG failed"}


def _undecoded(lib, rc: np.ndarray, device: DeviceLike) -> np.ndarray:
    """The images that get the data contract's zero frame; raises, naming
    the fault, when the decoder itself failed."""
    faults = sorted({int(c) for c in rc if c in _DECODER_FAULTS})
    if faults:
        last = getattr(lib, "cvm_decode_last_error", None)
        detail = last().decode(errors="replace") if last is not None else ""
        raise RuntimeError(f"the JPEG decoder on {device} failed: "
                           f"{'; '.join(_DECODER_FAULTS[c] for c in faults)} ({detail})")
    return rc != 0


def get_lib(device: DeviceLike = "cpu") -> ctypes.CDLL:
    """The decoder for ``device``, built at first use; raises when it cannot
    be built or loaded."""
    from cvm_tpu_torch.ops.cuda import _build

    dev = resolve_device(device)
    if dev.type == "cpu":
        return _declare(_build.load_host_library("jpeg_feeder", ("jpeg", "pthread"),
                                                 ("jpeglib.h",)))
    lib = _declare_nvjpeg(_build.load_library("jpeg_nvjpeg", ("nvjpeg",), ("nvjpeg.h",)))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if lib.cvm_decode_set_device(index) != 0:
        raise RuntimeError(f"the nvJPEG decoder already runs on another card than {dev}")
    return lib


def _choose_scale_num(h: int, w: int, max_h: int, max_w: int,
                      target_h: int, target_w: int) -> Optional[int]:
    """The decoders' power-of-2 DCT scale choice (``jpeg_feeder.cc``'s
    ``choose_scale``): num of num/8, or None when even 1/8 exceeds the
    buffer. ``target_h/w > 0``: the smallest scale whose output still
    covers 7/8 of the target; else the largest that fits."""
    best = None
    for num in (8, 4, 2, 1):
        oh, ow = -(-h * num // 8), -(-w * num // 8)  # ceil, as libjpeg does
        if oh > max_h or ow > max_w:
            continue
        if best is None:
            best = num
        if target_h > 0 and 8 * oh >= 7 * target_h and 8 * ow >= 7 * target_w:
            best = num
    return best


def _pointers(jpegs: Sequence[bytes]):
    n = len(jpegs)
    bufs = [np.frombuffer(j, np.uint8) for j in jpegs]
    ptrs = (ctypes.c_char_p * n)(*[b.ctypes.data_as(ctypes.c_char_p) for b in bufs])
    lens = (ctypes.c_ulong * n)(*[len(j) for j in jpegs])
    return bufs, ptrs, lens  # bufs: keeps the bytes alive during the call


def _check_out(arr: np.ndarray, shape, what: str) -> None:
    # The decoder writes through raw pointers: a wrong shape, dtype or
    # layout would corrupt memory silently.
    if arr.shape != shape or arr.dtype != np.uint8 or not arr.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what} must be C-contiguous uint8 {shape}, got {arr.dtype} "
                         f"{arr.shape} contiguous={arr.flags['C_CONTIGUOUS']}")


def decode_jpeg_batch(jpegs: Sequence[bytes], max_h: int, max_w: int, num_threads: int = 4,
                      out: Optional[np.ndarray] = None, target_hw: Tuple[int, int] = (0, 0),
                      device: DeviceLike = "cpu") -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEGs into a padded (N, max_h, max_w, 3) uint8 host batch.

    Returns (batch, hw) where hw[i] = (h, w) is the valid extent. An image
    that does not decode yields a zero frame with hw = (1, 1); a fault of
    the decoder itself raises RuntimeError. ``target_hw`` > 0 decodes
    at the smallest power-of-2 DCT scale whose output still covers the
    model input (the loader rescales labels from the decoded extent).
    ``out`` reuses a caller's buffer."""
    n = len(jpegs)
    if out is None:
        out = np.zeros((n, max_h, max_w, 3), np.uint8)
    else:
        _check_out(out, (n, max_h, max_w, 3), "out")
        out[:] = 0
    out_hw = np.ones((n, 2), np.int32)
    if n == 0:
        return out, out_hw
    lib = get_lib(device)
    _bufs, ptrs, lens = _pointers(jpegs)
    rc = np.zeros(n, np.int32)
    lib.cvm_decode_batch(n, ptrs, lens, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         max_h, max_w, int(target_hw[0]), int(target_hw[1]),
                         out_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                         rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    bad = _undecoded(lib, rc, device)
    if bad.any():
        out[bad] = 0
        out_hw[bad] = 1
    return out, out_hw


def decode_jpeg_batch_yuv420(jpegs: Sequence[bytes], max_h: int, max_w: int,
                             num_threads: int = 4, target_hw: Tuple[int, int] = (0, 0),
                             out_yuv: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
                             device: DeviceLike = "cpu"
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode JPEGs to planar YUV420 padded host batches.

    Returns (Y (N, max_h, max_w), U (N, max_h/2, max_w/2), V, hw); padding
    is Y 0 and U/V 128. 4:2:0 sources at full scale hand over their raw
    planes; others are converted from RGB. max_h and max_w must be even.
    ``out_yuv=(Y, U, V)`` reuses a caller's buffers."""
    if max_h % 2 or max_w % 2:
        raise ValueError(f"pad size must be even for 4:2:0, got {(max_h, max_w)}")
    n = len(jpegs)
    shapes = ((n, max_h, max_w), (n, max_h // 2, max_w // 2), (n, max_h // 2, max_w // 2))
    if out_yuv is None:
        Y = np.zeros(shapes[0], np.uint8)
        U = np.full(shapes[1], 128, np.uint8)
        V = np.full(shapes[2], 128, np.uint8)
    else:
        Y, U, V = out_yuv
        for arr, shp in zip((Y, U, V), shapes):
            _check_out(arr, shp, "out_yuv buffer")
        Y[:] = 0
        U[:] = 128
        V[:] = 128
    out_hw = np.ones((n, 2), np.int32)
    if n == 0:
        return Y, U, V, out_hw
    lib = get_lib(device)
    _bufs, ptrs, lens = _pointers(jpegs)
    rc = np.zeros(n, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cvm_decode_batch_yuv420(n, ptrs, lens, Y.ctypes.data_as(u8p), U.ctypes.data_as(u8p),
                                V.ctypes.data_as(u8p), max_h, max_w, int(target_hw[0]),
                                int(target_hw[1]),
                                out_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                                rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    bad = _undecoded(lib, rc, device)
    if bad.any():
        Y[bad] = 0
        U[bad] = 128
        V[bad] = 128
        out_hw[bad] = 1
    return Y, U, V, out_hw


def decode_jpeg_planes(jpeg: bytes, num: int = 8, device: DeviceLike = "cpu"):
    """One JPEG's component planes before any upsampling: [Y] or [Y, Cb,
    Cr] uint8 arrays, each at its own size. On the CPU, libjpeg's at scale
    num/8 (what its IDCT hands to its upsampler); on a card, nvJPEG's, at
    full scale only. The tests hold each decoder's RGB to a model of
    libjpeg's upsampling and color conversion applied to these planes."""
    if num not in (1, 2, 4, 8):
        raise ValueError(f"num must be 1, 2, 4 or 8, got {num}")
    if resolve_device(device).type != "cpu" and num != 8:
        raise ValueError("the card's decoder hands out full-scale planes only (num=8)")
    from cvm_tpu_torch.data.images import jpeg_size

    lib = get_lib(device)
    h, w = jpeg_size(jpeg)
    cap = 3 * h * w  # the planes of a frame at full scale, 4:4:4, at most
    out = np.empty(cap, np.uint8)
    dims = np.zeros(7, np.int32)
    rc = lib.cvm_decode_planes(jpeg, len(jpeg), num,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                               dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        _undecoded(lib, np.asarray([rc]), device)
        raise ValueError(f"the JPEG's planes could not be decoded (code {rc})")
    planes, at = [], 0
    for c in range(int(dims[0])):
        ph, pw = int(dims[1 + 2 * c]), int(dims[2 + 2 * c])
        planes.append(out[at:at + ph * pw].reshape(ph, pw).copy())
        at += ph * pw
    return planes


def nvjpeg_verdict(jpeg: bytes, device: DeviceLike = "cuda") -> dict:
    """What nvJPEG itself makes of one JPEG on the card (``cvm_decode_info``):
    ``nvjpegGetImageInfo``'s status, component count, chroma subsampling
    (``nvjpegChromaSubsampling_t``) and component sizes, and the status of
    ``nvjpegDecode`` into planes of those sizes (-1 when not tried). For
    the layouts the card's decoder refuses."""
    if resolve_device(device).type == "cpu":
        raise ValueError("nvjpeg_verdict needs a CUDA device")
    lib = get_lib(device)
    info = np.zeros(10, np.int32)
    rc = lib.cvm_decode_info(jpeg, len(jpeg), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        _undecoded(lib, np.asarray([rc]), device)
    i = info.tolist()
    return {"info_status": i[0], "components": i[1], "subsampling": i[2],
            "sizes_wh": [i[3:5], i[5:7], i[7:9]], "decode_status": i[9]}


def _rgb_to_yuv420_np(rgb: np.ndarray):
    """Full-range JFIF RGB -> planar YUV420 (numpy), chroma averaged over
    each 2x2 block (JFIF centered siting, as libjpeg's raw 4:2:0 planes and
    the device upsampler assume). For pre-decoded ``image`` blobs."""
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    yq = np.clip(y + 0.5, 0, 255).astype(np.uint8)

    def _down2(p):
        return 0.25 * (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2])

    uq = np.clip(_down2(u) + 0.5, 0, 255).astype(np.uint8)
    vq = np.clip(_down2(v) + 0.5, 0, 255).astype(np.uint8)
    return yq, uq, vq


def _yuv420_to_rgb_np(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planar YUV420 -> full-range JFIF RGB uint8 (numpy), chroma repeated
    2x2; for raw-YUV shards read through the RGB loader format."""
    h, w = y.shape
    uu = np.repeat(np.repeat(u.astype(np.float32), 2, 0), 2, 1)[:h, :w] - 128.0
    vv = np.repeat(np.repeat(v.astype(np.float32), 2, 0), 2, 1)[:h, :w] - 128.0
    yf = y.astype(np.float32)
    r = yf + 1.402 * vv
    g = yf - 0.344136 * uu - 0.714136 * vv
    b = yf + 1.772 * uu
    return np.clip(np.stack([r, g, b], -1) + 0.5, 0, 255).astype(np.uint8)
