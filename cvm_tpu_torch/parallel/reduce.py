"""Autograd-aware all-reduces, and the batch-wide reductions of a loss or a
BatchNorm over the global batch.

The reference gets these from GSPMD: its batch is one array sharded over
the mesh, so every ``sum``, ``mean`` and ``max`` over it is global. Here
each process holds its own rows, so each batch-wide reduction is a local
one followed by an all-reduce over the data-parallel group. A loss or a
BatchNorm takes a ``BatchReducer``: ``LOCAL`` (this process's batch is the
whole batch) or a ``GroupReducer`` over a process group; they never import
the group themselves.

Gradient scale. Under a group every rank computes the same global loss,
and ``all_reduce_sum``'s backward sums the gradient over the group, as
``torch.distributed.nn.functional.all_reduce`` does. So each rank's
gradient of a local value is ``size`` times its share of the true one, as
is each rank's gradient of a value all ranks compute alike (multitask's
``task_log_vars``). The gradients summed over the group and divided by
``size`` (``parallel/mesh.py::all_reduce_grads``) are the true gradient.
A loss that is a plain sum of per-rank terms (a test's) needs no division.

Every collective here is an all-reduce: the only two collectives gloo runs
on CUDA tensors are all-reduce and broadcast. Half-precision values are
reduced in float32 and cast back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    wide = x.dtype in (torch.bfloat16, torch.float16)
    y = x.to(torch.float32 if wide else x.dtype, memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype) if wide else y


class _SumSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _SumIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentitySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = _reduce(x, group, dist.ReduceOp.MAX)
        hit = (x == y).to(x.dtype)
        ctx.group = group
        ctx.save_for_backward(hit / _reduce(hit, group))  # ties share, as amax's do
        return y

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        return _reduce(g, ctx.group) * share, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group; backward sums the gradient over it."""
    return _SumSum.apply(x, group)


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group; backward is the identity (the output
    of a row-split conv: each rank holds a partial sum)."""
    return _SumIdentity.apply(x, group)


def sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; backward sums the gradient over the group (the input of
    a column-split conv: each rank's slice sends back a partial gradient)."""
    return _IdentitySum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group; the gradient goes to the
    ranks that hold the max (shared among ties), ``all_reduce_sum``'s scale."""
    return _Max.apply(x, group)


class BatchReducer:
    """Batch-wide reductions over this process's batch: the identity of a
    single process. ``size`` is the number of processes the batch is split
    over."""

    size = 1

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed elementwise over the processes' batches."""
        return x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the processes."""
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every element of ``x`` over the global batch."""
        return self.all_sum(x.sum())

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every element of ``x`` over the global batch."""
        return x.mean()

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The max of every element of ``x`` over the global batch."""
        return self.all_max(torch.amax(x))


LOCAL = BatchReducer()


class GroupReducer(BatchReducer):
    """Batch-wide reductions over the processes of ``group`` (``size`` of
    them), each holding its own rows of the batch."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(x, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum(x) / (x.numel() * self.size)  # every process holds as many rows

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(x, self.group)

    def __deepcopy__(self, memo):
        return self  # a process group is not copied (a model copy shares it)
