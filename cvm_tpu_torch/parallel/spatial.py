"""Spatial sharding with halo exchange: the counterpart of
``cvm_tpu/parallel/spatial.py``, the conv-net analogue of context
parallelism.

An image's H axis is split over the mesh's model axis: each rank of a
model group holds one H-slab of the same rows. A 3x3 stride-1 conv then
needs one row from each neighbour: every rank sends its bottom row down
(the lower neighbour's top halo) and its top row up, a rank with no
neighbour gets zeros (exactly the SAME padding at the image border), and
the conv runs VALID on H and SAME on W, so the slabs put together equal the
unsharded SAME conv.

The reference swaps the rows with ``lax.ppermute``. Here one ``all_gather``
of each slab's two boundary rows over the model group carries them: gloo,
which two ranks sharing a card use, runs no ``send``/``recv`` on CUDA
tensors, and an all-gather runs on both backends. The backward sends the
halo rows' gradients back the same way, and sums the weight's gradient
over the group, as the reference's ``shard_map`` sums the gradient of its
replicated ``w``. A collective that fails raises; nothing falls back to the
unsharded conv.

``split_rows`` and ``gather_rows`` move between a tensor every rank of the
group holds whole and its slabs (the semseg head keeps everything outside
its 3x3 conv whole, so that no BatchNorm statistic is ever taken over a
slab).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvm_tpu_torch.parallel.mesh import Mesh, all_gather_rows
from cvm_tpu_torch.parallel.reduce import _reduce


def check_rows(h: int, mesh: Mesh) -> int:
    """The slab height of ``h`` rows over the model axis; raises when the
    axis does not divide them (the reference asserts as much)."""
    if h % mesh.model:
        raise ValueError(f"spatial sharding: H={h} rows do not divide over the model axis of "
                         f"{mesh.model} ranks (pad H upstream)")
    return h // mesh.model


def _conv_valid_h(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC ``xp`` (halos included) with OIHW ``w``: VALID on H, SAME on W."""
    return F.conv2d(xp.permute(0, 3, 1, 2), w, padding=(0, 1)).permute(0, 2, 3, 1)


def _exchange(top: torch.Tensor, bottom: torch.Tensor, mesh: Mesh):
    """Every rank's (top, bottom) rows over the model group: the lists of
    the ranks' tops and bottoms, in rank order."""
    both = torch.stack([top, bottom])
    parts = all_gather_rows(both[None], mesh.model_group, mesh.model)
    return parts[:, 0], parts[:, 1]


class _HaloConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh):
        i, n = mesh.model_index, mesh.model
        tops, bottoms = _exchange(x[:, :1], x[:, -1:], mesh)
        zero = torch.zeros_like(x[:, :1])
        above = bottoms[i - 1] if i > 0 else zero       # the upper neighbour's bottom row
        below = tops[i + 1] if i < n - 1 else zero      # the lower neighbour's top row
        xp = torch.cat([above, x, below], dim=1)
        ctx.mesh = mesh
        ctx.save_for_backward(xp, w)
        return _conv_valid_h(xp, w)

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        mesh = ctx.mesh
        i, n = mesh.model_index, mesh.model
        with torch.enable_grad():
            xp_ = xp.detach().requires_grad_(True)
            w_ = w.detach().requires_grad_(True)
            gxp, gw = torch.autograd.grad(_conv_valid_h(xp_, w_), (xp_, w_), g)
        # The halo rows' gradients go back to the ranks they came from: the
        # upper halo's to the upper neighbour's bottom row, the lower's to
        # the lower neighbour's top row.
        ups, downs = _exchange(gxp[:, :1], gxp[:, -1:], mesh)
        gx = gxp[:, 1:-1].clone()
        if i < n - 1:
            gx[:, -1:] += ups[i + 1]
        if i > 0:
            gx[:, :1] += downs[i - 1]
        return gx, _reduce(gw, mesh.model_group), None


def spatial_conv3x3(x: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """3x3 stride-1 SAME conv of this rank's NHWC H-slab ``x`` (B, H/n, W,
    C) with the OIHW ``w`` every rank holds, H split over ``mesh``'s model
    axis of n ranks in rank order: this rank's slab of the output, in
    ``x``'s dtype. Every rank of the model group calls this."""
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"spatial_conv3x3 takes a 3x3 kernel, got {tuple(w.shape)}")
    if mesh.model == 1:
        return _conv_valid_h(F.pad(x, (0, 0, 0, 0, 1, 1)), w)
    return _HaloConv3x3.apply(x, w, mesh)


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        h = check_rows(x.shape[1], mesh)
        ctx.mesh = mesh
        return x[:, mesh.model_index * h:(mesh.model_index + 1) * h]

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g, ctx.mesh.model_group, ctx.mesh.model, dim=1), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.h = mesh, x.shape[1]
        return all_gather_rows(x, mesh.model_group, mesh.model, dim=1)

    @staticmethod
    def backward(ctx, g):
        m, h = ctx.mesh.model_index, ctx.h
        return g[:, m * h:(m + 1) * h], None


def split_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's H-slab of an NHWC tensor every rank of the model group
    holds whole; backward gathers the slabs' gradients into the whole."""
    return _SplitRows.apply(x, mesh)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model group's H-slabs put together, whole on every rank;
    backward keeps this rank's slab of the gradient."""
    return _GatherRows.apply(x, mesh)

