"""Learning-rate range finder (Smith, "Cyclical Learning Rates", 2015).

Mirrors ``cvm_tpu/train/lr_find.py`` (``exp_range_schedule``,
``suggest_from_curve``, ``run_lr_finder``): sweep the learning rate
log-linearly from ``lr_min`` to ``lr_max`` over a short run of a freshly
initialized model, record every step's loss, and suggest a peak LR from the
smoothed curve. The sweep runs the same train step as training
(``train/loop.py``: processor with kernel K1 for CenterNet and multitask on
the card, forward, loss, backward, update); only the optimizer differs: the
reference's ``clip_by_global_norm(10)`` then AdamW on the sweep's schedule,
with the config's weight decay. It never touches a checkpoint.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np
import torch

from cvm_tpu_torch.utils.device import DeviceLike


def exp_range_schedule(lr_min: float, lr_max: float, num_steps: int):
    """Log-linear LR ramp: lr(0) = lr_min, lr(num_steps - 1) = lr_max."""
    if not (0 < lr_min < lr_max):
        raise ValueError(f"need 0 < lr_min < lr_max, got {lr_min}, {lr_max}")
    ratio = lr_max / lr_min
    denom = max(num_steps - 1, 1)

    def sched(step):
        return lr_min * ratio ** (step / denom)

    return sched


def suggest_from_curve(lrs: List[float], losses: List[float],
                       beta: float = 0.9) -> Dict[str, float]:
    """A peak LR from an (lr, loss) sweep: bias-corrected EMA smoothing of
    the losses, then ``lr_steepest`` (the most negative d(smoothed
    loss)/d(log lr) before the minimum; the suggestion) and ``lr_min_loss``
    (the smoothed minimum)."""
    if len(lrs) != len(losses) or len(lrs) < 4:
        raise ValueError("need >= 4 (lr, loss) points")
    sm: List[float] = []
    avg = 0.0
    for i, loss in enumerate(losses):
        avg = beta * avg + (1 - beta) * float(loss)
        sm.append(avg / (1 - beta ** (i + 1)))
    sm_a = np.asarray(sm)
    i_min = int(np.argmin(sm_a))
    # Slope over log lr, ignoring the tail past the minimum (divergence).
    end = max(i_min + 1, 3)
    dlogs = np.diff(np.log(np.asarray(lrs[:end])))
    dloss = np.diff(sm_a[:end])
    slopes = dloss / np.maximum(dlogs, 1e-12)
    i_steep = int(np.argmin(slopes)) + 1 if len(slopes) else i_min
    return {"lr_steepest": float(lrs[i_steep]), "lr_min_loss": float(lrs[i_min]),
            "suggestion": float(lrs[i_steep]), "smoothed_min": float(sm_a[i_min])}


def run_lr_finder(cfg, it: Iterator, device: DeviceLike, num_steps: int = 200,
                  lr_min: float = 1e-6, lr_max: float = 1.0, diverge_factor: float = 4.0,
                  seed: int = 0) -> Dict:
    """Sweep the LR over ``num_steps`` host batches from ``it`` on
    ``device``; returns the curve and the picks. Stops early once the
    smoothed loss exceeds ``diverge_factor`` x its best (the later points
    carry no information)."""
    from cvm_tpu_torch.train.loop import Trainer, step_generator
    from cvm_tpu_torch.train.optim import Optimizer

    sched = exp_range_schedule(lr_min, lr_max, num_steps)
    trainer = Trainer(cfg, device, seed=seed, log_every=max(num_steps, 1),
                      tx=lambda params: Optimizer(
                          params, sched, "adamw",
                          weight_decay=getattr(cfg, "weight_decay", 0.0), clip_norm=10.0))
    batch = next(it)
    trainer.init_state()
    lrs: List[float] = []
    losses: List[float] = []
    best = math.inf
    avg = 0.0
    stopped_early = False
    for step in range(num_steps):
        raw = {k: torch.as_tensor(np.asarray(v)).to(trainer.device) for k, v in batch.items()}
        trainer.state, metrics = trainer.train_step(
            trainer.state, raw, step_generator(trainer.device, seed, step))
        # One host sync per step, on purpose: the finder needs every loss.
        loss = float(metrics["loss"])
        lrs.append(float(sched(step)))
        losses.append(loss)
        avg = 0.9 * avg + 0.1 * loss
        sm = avg / (1 - 0.9 ** (step + 1))
        if math.isfinite(sm):
            best = min(best, sm)
        if step > 10 and (not math.isfinite(loss) or sm > diverge_factor * best):
            stopped_early = True
            break
        batch = next(it)
    picks = suggest_from_curve(lrs, losses)
    picks.update(steps_run=len(lrs), stopped_early=stopped_early, lr_min=lr_min,
                 lr_max=lr_max)
    return {"curve": {"lr": lrs, "loss": losses}, **picks}
