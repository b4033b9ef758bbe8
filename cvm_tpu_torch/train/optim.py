"""Optimizer: learning-rate schedules and the reference's optax chain, written
as plain tensor updates.

Mirrors ``cvm_tpu/train/optim.py`` (``make_schedule``, ``make_optimizer``)
with optax's semantics, which differ from ``torch.optim`` in places:

* the schedule is read at the update count *before* it is incremented, so
  the first update of every warmup schedule has learning rate 0;
* ``clip_by_global_norm`` scales by ``max / ||g||`` when ``||g|| >= max``
  (no epsilon), on the gradients the inner optimizer sees;
* AdamW (b1 0.9, b2 0.999, eps 1e-8) decays every parameter, BatchNorm
  scales and biases included, and the decay is multiplied by the scheduled
  learning rate: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
* SGD adds the decayed weights first, then Nesterov momentum 0.9:
  ``g += wd * p; t = g + 0.9 t; p -= lr * (g + 0.9 t)``;
* ``grad_accum_steps = k`` (optax ``MultiSteps``) keeps the running mean of
  k micro-step gradients and applies the chain to it every k-th step; the
  steps between leave the parameters and the inner state untouched.

The updates use ``torch._foreach_*`` ops, a few multi-tensor kernels per step
for all parameters, and never read a device value on the host.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    # optax.linear_schedule = polynomial_schedule(power=1)
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = out if count < boundary else s(count - boundary)
        return out
    return schedule


def make_schedule(kind: str, learning_rate: float, total_steps: int,
                  warmup_steps: int) -> Schedule:
    """LR schedule by name, a function of the update count: warmup_cosine
    (default; cosine to 1% of the peak at ``total_steps``), constant, step
    (x0.1 at 60% and 85% of total_steps) or poly ((1 - t)^0.9 to 0). All
    keep the linear warmup from 0."""
    warmup_steps = max(warmup_steps, 1)
    warm = _linear(0.0, learning_rate, warmup_steps)
    if kind == "warmup_cosine":
        decay = max(total_steps, warmup_steps + 1) - warmup_steps
        alpha = 0.0 if learning_rate == 0.0 else 0.01

        def cosine(count: int) -> float:
            c = min(count, decay)
            return learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                                    + alpha)
        return _join([warm, cosine], [warmup_steps])
    if kind == "constant":
        return _join([warm, lambda count: learning_rate], [warmup_steps])
    if kind == "step":
        b1, b2 = int(total_steps * 0.6), int(total_steps * 0.85)
        scales = {max(b1 - warmup_steps, 1): 0.1, max(b2 - warmup_steps, 2): 0.1}

        def body(count: int) -> float:
            v = learning_rate
            for threshold, scale in sorted(scales.items()):
                if count >= threshold:
                    v *= scale
            return v
        return _join([warm, body], [warmup_steps])
    if kind == "poly":
        steps = max(total_steps - warmup_steps, 1)

        def poly(count: int) -> float:
            return learning_rate * (1 - min(max(count, 0), steps) / steps) ** 0.9
        return _join([warm, poly], [warmup_steps])
    raise ValueError(f"unknown lr_schedule {kind!r} (warmup_cosine|constant|step|poly)")


class Optimizer:
    """``clip_by_global_norm(clip_norm)`` -> AdamW, or add-decayed-weights ->
    SGD Nesterov 0.9, over ``params``, optionally under ``MultiSteps``.

    ``step(grads)`` updates the parameters in place (no autograd) and
    returns True when it applied an update (every call unless
    ``grad_accum_steps > 1``). ``count`` is the number of applied updates,
    the count the schedule reads. ``norm`` is the global norm the clip
    reads (``parallel/sharding.py::split_norm`` when some parameters are
    tensor-parallel slices).
    """

    B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9

    def __init__(self, params: Sequence[torch.Tensor], schedule: Schedule, kind: str = "adamw",
                 weight_decay: float = 1e-5, clip_norm: float = 10.0,
                 grad_accum_steps: int = 1):
        if kind not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r} (adamw|sgd)")
        self.params: List[torch.Tensor] = list(params)
        self.schedule, self.kind = schedule, kind
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.k = max(int(grad_accum_steps), 1)
        self.count = 0       # applied updates
        self.mini_step = 0   # micro-steps accumulated towards the next update
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
                         for p in self.params]
        self.mu = zeros()                                   # Adam m, or SGD trace
        self.nu = zeros() if kind == "adamw" else []        # Adam v
        self.acc = zeros() if self.k > 1 else []            # MultiSteps running mean
        self.norm: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        src = list(grads)
        if self.k > 1:
            # acc += (g - acc) / (mini_step + 1): the mean of the micro-steps.
            d = torch._foreach_sub(src, self.acc)
            torch._foreach_div_(d, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, d)
            if self.mini_step < self.k - 1:
                self.mini_step += 1
                return False
            src = self.acc
        # clip_by_global_norm: g * (max / ||g||) where ||g|| >= max; the
        # product is a new list, so the caller's gradients stay as they are.
        norm = self.norm(src)
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        grads = torch._foreach_mul(src, factor)
        if self.k > 1:
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        lr = self.schedule(self.count)
        self.count += 1
        if self.kind == "adamw":
            updates = self._adam(grads)
            torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        else:
            torch._foreach_add_(grads, self.params, alpha=self.weight_decay)
            torch._foreach_mul_(self.mu, self.MOMENTUM)
            torch._foreach_add_(self.mu, grads)
            updates = torch._foreach_add(grads, self.mu, alpha=self.MOMENTUM)
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)
        return True

    def _adam(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        m_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        v_hat = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(v_hat)
        torch._foreach_add_(v_hat, self.EPS)
        return torch._foreach_div(m_hat, v_hat)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        for name in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, name), state[name]
            if len(mine) != len(theirs) or any(a.shape != b.shape
                                               for a, b in zip(mine, theirs)):
                raise ValueError(f"optimizer state {name!r} does not match the parameters")
            with torch.no_grad():
                for a, b in zip(mine, theirs):
                    a.copy_(b)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def make_optimizer(params: Sequence[torch.Tensor], learning_rate: float, total_steps: int,
                   warmup_steps: int = 500, weight_decay: float = 1e-5,
                   clip_norm: float = 10.0, grad_accum_steps: int = 1,
                   lr_schedule: str = "warmup_cosine", optimizer: str = "adamw") -> Optimizer:
    """The reference's optimizer over ``params``."""
    schedule = make_schedule(lr_schedule, learning_rate, total_steps, warmup_steps)
    return Optimizer(params, schedule, optimizer, weight_decay, clip_norm, grad_accum_steps)
