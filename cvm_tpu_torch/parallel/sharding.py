"""Tensor parallelism on the stage-5 blocks: the counterpart of
``cvm_tpu/parallel/sharding.py``.

The reference maps parameter paths to ``PartitionSpec``s by regex rules
(first match wins, else replicated) and lets GSPMD partition the convs.
Its default rules (``tp_rules_for``) split each stage-5 residual block
Megatron style: ``s5b*/c1`` on C_out (column), ``s5b*/c2`` on C_in (row),
so the activation between them stays split and each block needs one sum.
Here the rules are the same regexes on the port's parameter names
(``backbone.s5b0.c1.conv.weight``, ``convert.py``'s mapping), each with
the OIHW dimension it splits (0 = C_out, 1 = C_in), and
``shard_module`` swaps each matched ``Conv`` for one that holds only this
rank's slice:

* ``ColumnConv`` (C_out split) takes the full input through
  ``sum_backward``: the identity forward, its gradient summed over the
  model group. The BatchNorm after it holds the same channels' slice.
* ``RowConv`` (C_in split) sums its partial output over the model group
  (``sum_forward``: the identity backward).

Parameters, optimizer state and the EMA are split alike, as the
reference's ``loop.py`` shards all three. ``gather_state_dict`` rebuilds
the full tensors (an all-reduce of zero-padded slices), so a
tensor-parallel checkpoint has the layout of a replicated one and loads in
one process, and ``shard_state_dict`` cuts a full one to this rank's
slices: what Orbax does for the reference.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from cvm_tpu_torch.models.layers import BatchNorm, Conv
from cvm_tpu_torch.parallel.mesh import Mesh, all_gather_rows
from cvm_tpu_torch.parallel.reduce import GroupReducer, sum_backward, sum_forward

Rules = Sequence[Tuple[str, int]]

# The reference's _BACKBONE_TP_RULES, on the port's names: (regex, OIHW dim).
_BACKBONE_TP_RULES: Rules = (
    (r"s5b\d+\.c1\.conv\.weight$", 0),  # column: C_out
    (r"s5b\d+\.c2\.conv\.weight$", 1),  # row: C_in
)


def tp_rules_for(spec_name: str) -> Rules:
    """Default tensor-parallel rules of a zoo model (all share the pyramid
    backbone, so the widest convs live in the same stage-5 blocks)."""
    del spec_name
    return _BACKBONE_TP_RULES


def match_rules(names: Sequence[str], rules: Rules) -> Dict[str, int]:
    """``{name: split dim}`` of the names a rule matches (first match wins);
    the rest stay replicated."""
    compiled = [(re.compile(pat), dim) for pat, dim in rules]
    out = {}
    for name in names:
        for pat, dim in compiled:
            if pat.search(name):
                out[name] = dim
                break
    return out


def _part(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * n, n)


class ColumnConv(Conv):
    """This rank's C_out slice of a ``Conv``; the full input's gradient is
    summed over the model group."""

    def __init__(self, conv: Conv, mesh: Mesh):
        super().__init__(conv.in_channels, conv.out_channels // mesh.model, conv.kernel_size[0],
                         conv.stride[0], bias=conv.bias is not None, dtype=conv.dtype)
        self.mesh = mesh
        with torch.no_grad():
            self.weight = nn.Parameter(_part(conv.weight, 0, mesh).clone())
            if conv.bias is not None:
                self.bias = nn.Parameter(_part(conv.bias, 0, mesh).clone())

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        return super().forward(sum_backward(x, self.mesh.model_group), dtype)


class RowConv(Conv):
    """This rank's C_in slice of a bias-free ``Conv``; the partial outputs
    are summed over the model group. ``slices`` reduces over that group:
    QAT's fake quant takes its scales over the slices with it, so that they
    are the whole tensors' (``train/qat.py``)."""

    def __init__(self, conv: Conv, mesh: Mesh):
        if conv.bias is not None:
            raise ValueError("a row-split conv must have no bias (it would be added per rank)")
        super().__init__(conv.in_channels // mesh.model, conv.out_channels, conv.kernel_size[0],
                         conv.stride[0], bias=False, dtype=conv.dtype)
        self.mesh = mesh
        self.slices = GroupReducer(mesh.model_group, mesh.model)
        with torch.no_grad():
            self.weight = nn.Parameter(_part(conv.weight, 1, mesh).clone())

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        return sum_forward(super().forward(x, dtype), self.mesh.model_group)


def _slice_bn(bn: BatchNorm, mesh: Mesh) -> BatchNorm:
    out = BatchNorm(bn.num_features // mesh.model).to(bn.weight.device)
    out.reducer = bn.reducer
    with torch.no_grad():
        for name, t in list(out.named_parameters()) + list(out.named_buffers()):
            src = getattr(bn, name)
            t.copy_(src if src.dim() == 0 else _part(src, 0, mesh))
    return out


def shard_module(model: nn.Module, mesh: Mesh, rules: Rules) -> Dict[str, int]:
    """Swap each ``Conv`` whose weight a rule matches for its slice on this
    rank (with the BatchNorm after a column split), in place; returns the
    ``{state_dict name: split dim}`` of every tensor now held in slices.
    Nothing changes on a model axis of one rank."""
    if mesh.model == 1:
        return {}
    modules = dict(model.named_modules())
    split: Dict[str, int] = {}
    for name, dim in match_rules([n for n, _ in model.named_parameters()], rules).items():
        conv_name = name.rsplit(".", 1)[0]
        parent_name, attr = conv_name.rsplit(".", 1)
        conv, parent = modules[conv_name], modules[parent_name]
        if not isinstance(conv, Conv) or name != f"{conv_name}.weight" or dim not in (0, 1):
            raise ValueError(f"tensor-parallel rule matched {name}: only a Conv's weight "
                             "splits, on dim 0 (C_out) or 1 (C_in)")
        width = conv.weight.shape[dim]
        if width % mesh.model:
            raise ValueError(f"{name}: {width} channels not divisible by {mesh.model} ranks")
        if dim == 0:
            setattr(parent, attr, ColumnConv(conv, mesh))
            split[name] = 0
            if conv.bias is not None:
                split[f"{conv_name}.bias"] = 0
            bn = getattr(parent, "bn", None)
            if isinstance(bn, BatchNorm):
                parent.bn = _slice_bn(bn, mesh)
                for t in ("weight", "bias", "running_mean", "running_var"):
                    split[f"{parent_name}.bn.{t}"] = 0
        else:
            setattr(parent, attr, RowConv(conv, mesh))
            split[name] = 1
    return split


def _whole(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return all_gather_rows(t.detach(), mesh.model_group, mesh.model, dim=dim)


@torch.no_grad()
def unshard_module(model: nn.Module) -> None:
    """Undo ``shard_module`` in place: each ``ColumnConv`` / ``RowConv``
    becomes the whole ``Conv`` (and a column split's BatchNorm the whole
    BatchNorm), its slices gathered over its mesh's model group. Every rank
    of the group calls this."""
    for parent in list(model.modules()):
        for attr, conv in list(parent.named_children()):
            if not isinstance(conv, (ColumnConv, RowConv)):
                continue
            mesh, dim = conv.mesh, 0 if isinstance(conv, ColumnConv) else 1
            w = _whole(conv.weight, dim, mesh)
            whole = Conv(w.shape[1], w.shape[0], conv.kernel_size[0], conv.stride[0],
                         bias=conv.bias is not None, dtype=conv.dtype).to(w.device)
            whole.weight.copy_(w)
            if conv.bias is not None:
                whole.bias.copy_(_whole(conv.bias, 0, mesh))
            setattr(parent, attr, whole)
            bn = getattr(parent, "bn", None)
            if dim == 0 and isinstance(bn, BatchNorm):
                full = BatchNorm(bn.num_features * mesh.model).to(w.device)
                full.reducer = bn.reducer
                for name, t in list(full.named_parameters()) + list(full.named_buffers()):
                    src = getattr(bn, name)
                    t.copy_(src if src.dim() == 0 else _whole(src, 0, mesh))
                parent.bn = full


def gather_state_dict(sd: Mapping[str, torch.Tensor], split: Mapping[str, int],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``sd`` with each split tensor made whole: every rank of the model
    group places its slice in zeros, and an all-reduce sums them. Every
    rank of the group calls this."""
    out = dict(sd)
    for name, dim in split.items():
        if name not in sd:
            continue
        t = sd[name].detach()
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * mesh.model
        full = t.new_zeros(shape)
        full.narrow(dim, mesh.model_index * n, n).copy_(t)
        dist.all_reduce(full, group=mesh.model_group)
        out[name] = full
    return out


def shard_state_dict(sd: Mapping[str, torch.Tensor], split: Mapping[str, int],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A whole ``sd`` (a replicated run's, or ``gather_state_dict``'s) with
    each split tensor cut to this rank's slice."""
    return {k: (_part(v, split[k], mesh).clone() if k in split else v) for k, v in sd.items()}


def split_norm(sharded: Sequence[bool], mesh: Mesh) -> Callable[[List[torch.Tensor]],
                                                                torch.Tensor]:
    """The global norm of a list of tensors of which those marked
    ``sharded`` are this rank's slices: their squares summed over the model
    group (``optim.global_norm`` of the whole tensors)."""

    def sq(ts: List[torch.Tensor]) -> torch.Tensor:
        return torch.stack(torch._foreach_norm(ts)).square().sum()

    def norm(tensors: List[torch.Tensor]) -> torch.Tensor:
        rep = [t for t, s in zip(tensors, sharded) if not s]
        part = sq([t for t, s in zip(tensors, sharded) if s])
        dist.all_reduce(part, group=mesh.model_group)
        return torch.sqrt(sq(rep) + part if rep else part)

    return norm
