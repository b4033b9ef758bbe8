"""FLOPs the plain reference needs per frame, as ``FlopCounterMode`` counts
them (convolutions and matrix products), on meta tensors: no memory, no
device time. Counted once per (model, input shape) in a process."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from cvbench.reference.model import forward

_CACHE: Dict[Tuple, float] = {}


def forward_flops(weights: Dict[str, torch.Tensor], cfg: dict, batch: int = 1) -> float:
    """Forward FLOPs of ``batch`` frames at ``cfg["input_hw"]``."""
    h, w = cfg["input_hw"]
    key = (cfg["model"], cfg["backbone"], h, w, batch, cfg.get("num_classes"))
    if key not in _CACHE:
        meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
                for k, v in weights.items()}
        x = torch.empty((batch, 3, h, w), dtype=torch.float32, device="meta")
        with FlopCounterMode(display=False) as counter:
            forward(meta, x, cfg)
        _CACHE[key] = float(counter.get_total_flops())
    return _CACHE[key]


def train_flops(weights: Dict[str, torch.Tensor], cfg: dict, batch: int = 1) -> float:
    """Forward and backward FLOPs of one training step on ``batch`` frames,
    per frame (the gradients of every parameter and of the activations)."""
    from cvbench.reference.train import train_forward

    h, w = cfg["input_hw"]
    key = ("train", cfg["model"], cfg["backbone"], h, w, batch, cfg.get("num_classes"))
    if key not in _CACHE:
        meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta",
                               requires_grad=v.is_floating_point() and not k.endswith(("running_mean", "running_var")))
                for k, v in weights.items()}
        x = torch.empty((batch, 3, h, w), dtype=torch.float32, device="meta")
        leaves = [v for v in meta.values() if v.requires_grad]
        with FlopCounterMode(display=False) as counter:
            out = train_forward(meta, x, cfg)
            total = sum(v.sum() for v in out.values())
            torch.autograd.grad(total, leaves)
        _CACHE[key] = float(counter.get_total_flops()) / batch
    return _CACHE[key]
