"""CenterNet Gaussian heatmap splat: the Hopper kernel's wrapper and its plain
version.

Mirrors ``cvm_tpu/ops/pallas/gaussian_splat.py`` (``_render_bk``): from a
zero map, every valid object whose class ``c`` lies in [0, C)
max-accumulates ``exp(-(dy^2 + dx^2) / (2 sigma^2 + 1e-12))``, truncated to
``dy^2, dx^2 <= r^2 + 1e-6``, into channel ``c``. The per-object ``iy``,
``ix``, ``sigma`` and ``radius`` come from ``ops.heatmap.prepare_centers``.
An object whose class lies outside [0, C) is dropped, as the reference's
lattice renderer drops it (its Pallas kernel would index out of bounds).

``render_heatmap`` launches ``csrc/gaussian_splat.cu`` for CUDA tensors and
takes the plain version, ``render_heatmap_reference`` (the reference's
(K, Hs, Ws) lattice and a per-class max), only for CPU tensors. A CUDA
tensor never reaches the plain version through the wrapper: a tensor the
kernel does not take raises, and so does a failed build or launch.

The kernel writes every element of the map once, from tiles zeroed and
splatted in shared memory, so the output comes from ``torch.empty``.
``splat_plan`` picks the tiles: bands of whole rows, or flat chunks where
one row is wider than a tile.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from cvm_tpu_torch.utils.prof import launch_counter


# Kernel constants (csrc/gaussian_splat.cu): objects culled per pass and the
# bytes of one culled object in shared memory (struct Obj).
_KERNEL_OBJS = 128
_OBJ_BYTES = 44
# Tiling: a tile of several rows holds at most TILE_BYTES; a row up to
# ROW_BYTES_MAX is one tile of its own (dynamic shared memory above 48 KB);
# a wider row is cut into flat chunks of TILE_BYTES. Bands stay thin enough
# that the grid has MIN_BLOCKS blocks (two per SM of an H100) where the map
# has that many rows.
TILE_BYTES = 24 * 1024
ROW_BYTES_MAX = 160 * 1024
MIN_BLOCKS = 2 * 132


class SplatPlan(NamedTuple):
    """How the kernel tiles a (B, Hs, Ws, C) map: ``chunk`` floats per tile
    (``rows`` whole rows, or a flat chunk when ``rows`` is 0), ``tiles`` per
    image (the last may be shorter), one block per tile, ``smem_bytes`` of
    dynamic shared memory per block."""
    rows: int
    chunk: int
    tiles: int
    blocks: int
    smem_bytes: int


def splat_plan(B: int, Hs: int, Ws: int, C: int) -> SplatPlan:
    """The kernel's tiles for a (B, Hs, Ws, C) map: the tallest band
    within TILE_BYTES that leaves MIN_BLOCKS blocks."""
    row = Ws * C
    if 4 * row <= ROW_BYTES_MAX:
        rows = 1
        for h in range(2, Hs + 1):
            if 4 * h * row > TILE_BYTES or B * -(-Hs // h) < MIN_BLOCKS:
                break
            rows = h
        chunk = rows * row
    else:
        rows, chunk = 0, TILE_BYTES // 4
    tiles = -(-Hs * row // chunk)
    # the tile with up to 3 floats of alignment offset, in whole float4s
    smem = 4 * ((chunk + 6) // 4 * 4) + _KERNEL_OBJS * _OBJ_BYTES
    return SplatPlan(rows, chunk, tiles, B * tiles, smem)


def _check(iy, ix, sigma, radius, classes, valid, map_hw, num_classes):
    if iy.dim() != 2:
        raise ValueError(f"render_heatmap: per-object inputs must be (B, K), got {tuple(iy.shape)}")
    for name, t, dt in (("iy", iy, torch.int32), ("ix", ix, torch.int32),
                        ("sigma", sigma, torch.float32), ("radius", radius, torch.float32),
                        ("classes", classes, torch.int32), ("valid", valid, torch.bool)):
        if t.shape != iy.shape or t.dtype != dt:
            raise ValueError(f"render_heatmap: {name} must be {tuple(iy.shape)} {dt}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != iy.device:
            raise ValueError(f"render_heatmap: {name} on {t.device}, iy on {iy.device}")
    hs, ws = map_hw
    if hs <= 0 or ws <= 0 or num_classes <= 0:
        raise ValueError(f"render_heatmap: empty map {map_hw} x {num_classes} classes")


def render_heatmap_reference(iy, ix, sigma, radius, classes, valid,
                             map_hw: Tuple[int, int], num_classes: int) -> torch.Tensor:
    """Plain PyTorch version: the (B, K, Hs, Ws) Gaussian lattice of
    ``cvm_tpu/ops/heatmap.py:117-134``, max-combined per class (invalid
    objects and classes outside [0, C) go to a dropped extra channel).
    Returns (B, Hs, Ws, C) float32."""
    _check(iy, ix, sigma, radius, classes, valid, map_hw, num_classes)
    hs, ws = map_hw
    B, K = iy.shape
    dev = iy.device
    ys = torch.arange(hs, dtype=torch.float32, device=dev)
    xs = torch.arange(ws, dtype=torch.float32, device=dev)
    dy2 = (ys - iy.float()[..., None]) ** 2                      # (B, K, Hs)
    dx2 = (xs - ix.float()[..., None]) ** 2                      # (B, K, Ws)
    d2 = dy2[..., :, None] + dx2[..., None, :]
    g = torch.exp(-d2 / (2.0 * sigma[..., None, None] ** 2 + 1e-12))
    r2 = radius[..., None, None] ** 2 + 1e-6
    in_win = (dy2[..., :, None] <= r2) & (dx2[..., None, :] <= r2)
    g = torch.where(in_win & valid[..., None, None], g, 0.0)
    keep = valid & (classes >= 0) & (classes < num_classes)
    seg = torch.where(keep, classes, num_classes).long()
    hm = torch.zeros(B, num_classes + 1, hs * ws, device=dev)
    hm.scatter_reduce_(1, seg[..., None].expand(B, K, hs * ws), g.reshape(B, K, hs * ws),
                       reduce="amax")
    return hm[:, :num_classes].reshape(B, num_classes, hs, ws).permute(0, 2, 3, 1).contiguous()


def _lib():
    from cvm_tpu_torch.ops.cuda._build import load_library

    fn = load_library("gaussian_splat").gaussian_splat_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
        fn.restype = I
    return fn


def render_heatmap(iy, ix, sigma, radius, classes, valid,
                   map_hw: Tuple[int, int], num_classes: int) -> torch.Tensor:
    """iy, ix, classes (B, K) int32; sigma, radius (B, K) float32; valid
    (B, K) bool -> (B, Hs, Ws, C) float32. CPU tensors take the plain
    version; CUDA tensors the kernel, which writes every element of the
    uninitialised output (an empty batch has none, and launches nothing)."""
    if iy.device.type == "cpu":
        return render_heatmap_reference(iy, ix, sigma, radius, classes, valid,
                                        map_hw, num_classes)
    if iy.device.type != "cuda":
        raise ValueError(f"render_heatmap: no kernel for device {iy.device}")
    _check(iy, ix, sigma, radius, classes, valid, map_hw, num_classes)
    args = [t.contiguous() for t in (iy, ix, sigma, radius, classes)]
    args.append(valid.contiguous().view(torch.uint8))
    B, K = iy.shape
    hs, ws = map_hw
    if B > 65535 or hs * ws * num_classes >= 2 ** 31:
        raise ValueError(f"render_heatmap: the kernel takes B <= 65535 and Hs*Ws*C < 2^31, "
                         f"got B={B}, {hs}x{ws}x{num_classes}")
    out = torch.empty((B, hs, ws, num_classes), dtype=torch.float32, device=iy.device)
    if B == 0:
        return out
    plan = splat_plan(B, hs, ws, num_classes)
    with torch.cuda.device(iy.device):
        stream = torch.cuda.current_stream(iy.device).cuda_stream
        err = _lib()(*(t.data_ptr() for t in args), out.data_ptr(), B, K, hs, ws,
                     num_classes, plan.chunk, plan.tiles, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"gaussian_splat kernel launch failed: cudaError {err}")
    render_heatmap.launches += 1
    return out


render_heatmap.launches = 0  # kernel launches (CUDA tensors only)
launch_counter(render_heatmap, "launches")


def reset_counts() -> None:
    render_heatmap.launches = 0
