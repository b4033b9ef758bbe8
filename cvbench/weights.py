"""Weights from ``--seed``: the program's model built without values (meta
tensors), then every parameter and buffer filled on the device from one
seeded ``torch.Generator`` draw.

Conv kernels are lecun-normal (variance 1 / fan_in); biases small normals,
the heatmap head's around the focal prior log(0.1 / 0.9); BatchNorm scales
around 1 and its shifts and running statistics drawn too, so that folding
them into the kernels is real work. The same ``state_dict`` is what the
reference is handed.

A serving mix (or the configuration of a model that is only served) may
scale the heads' last projections (``"weights": {"gain": {...}, "shift":
{...}}``): behind a body whose random signal decays with depth, the heads
would otherwise give nearly flat maps, where a trained detector gives peaks
and a trained segmenter confident classes. A training cell starts from the
weights as drawn, as the recipe's own init does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn as nn

HM_PRIOR = -math.log((1.0 - 0.1) / 0.1)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


@torch.no_grad()
def seeded_model(build: Callable[[], nn.Module], seed: int, device,
                 gain: Dict[str, float] = None, shift: Dict[str, float] = None) -> nn.Module:
    """``build()`` on the meta device, materialized on ``device`` and filled
    from ``seed``, then each tensor named in ``gain`` scaled and each named
    in ``shift`` moved by its number; in eval mode."""
    with torch.device("meta"):
        model = build()
    model = model.to_empty(device=device)
    state = model.state_dict(keep_vars=True)
    fill(state, seed, device)
    for name, g in (gain or {}).items():
        state[name].mul_(g)
    for name, d in (shift or {}).items():
        state[name].add_(d)
    return model.eval()


@torch.no_grad()
def fill(state: Dict[str, torch.Tensor], seed: int, device) -> None:
    """Fill every floating tensor of ``state`` in place from one draw."""
    floats = [(k, t) for k, t in state.items() if t.is_floating_point()]
    z = torch.randn(sum(t.numel() for _, t in floats), generator=generator(seed, device),
                    device=device)
    at = 0
    for name, t in floats:
        n = z[at:at + t.numel()].view(t.shape)
        at += t.numel()
        if t.dim() == 4:                                   # conv kernel (O, I, kh, kw)
            t.copy_(n / math.sqrt(t[0].numel()))
        elif name.endswith("running_var"):
            t.copy_(torch.exp(0.2 * n))
        elif name.endswith("running_mean") or name.endswith("bn.bias"):
            t.copy_(0.1 * n)
        elif name.endswith("bn.weight"):
            t.copy_(1.0 + 0.1 * n)
        elif name == "hm.out.bias":
            t.copy_(HM_PRIOR + 0.05 * n)
        else:                                              # conv biases
            t.copy_(0.05 * n)
    for name, t in state.items():
        if not t.is_floating_point():
            t.zero_()                                      # num_batches_tracked
