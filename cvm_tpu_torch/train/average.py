"""Checkpoint averaging (stochastic weight averaging over retained saves).

Mirrors ``cvm_tpu/train/average.py::average_checkpoints`` over the port's
torch checkpoints (``Trainer.checkpoint_state``'s dicts):
- the float tensors of the model's ``state_dict`` (parameters and the
  BatchNorm running statistics, the reference's ``params`` and
  ``batch_stats``) and of the EMA shadow, when present, are the mean of the
  N restored checkpoints, summed in float64 and cast back;
- integer buffers (``num_batches_tracked``), the optimizer state, the step
  and the data stream's state stay the newest checkpoint's (averaging
  optimizer moments is meaningless).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _mean(parts, k: int, like: Optional[Dict[str, torch.Tensor]]):
    """The float64 running sums in ``parts`` divided by ``k`` and cast to
    ``like``'s dtypes; integer entries are ``like``'s (the newest's)."""
    if like is None:
        return None
    return {n: (parts[n] / k).to(v.dtype) if v.is_floating_point() else v
            for n, v in like.items()}


def average_checkpoints(trainer, last_n: int) -> Tuple[int, ...]:
    """Load into ``trainer.state`` the newest retained checkpoint with its
    model and EMA float tensors replaced by the mean over the last
    ``last_n`` retained checkpoints. Returns the steps averaged.

    Requires an initialized trainer with a checkpoint_dir; raises when fewer
    than two checkpoints are on disk (keep_checkpoints bounds availability).
    """
    if trainer.ckpt is None:
        raise ValueError("trainer has no checkpoint_dir to average from")
    if trainer.state is None:
        raise RuntimeError("call init_state() first")
    steps = trainer.ckpt.all_steps()
    use = steps[-int(last_n):]
    if len(use) < 2:
        raise ValueError(
            f"checkpoint averaging needs >= 2 retained checkpoints, found "
            f"{len(steps)} in {trainer.ckpt.directory} (keep_checkpoints "
            f"bounds how many survive)")

    sums: Dict[str, Dict[str, torch.Tensor]] = {"model": {}, "ema": {}}
    newest = None
    for s in use:
        ck = trainer.ckpt.restore_step(s, map_location="cpu")
        newest = ck  # ascending order: the last one is the newest step
        for part in sums:
            for n, v in (ck[part] or {}).items():
                if v.is_floating_point():
                    v = v.to(torch.float64)
                    sums[part][n] = sums[part][n] + v if n in sums[part] else v
    for part in sums:
        newest[part] = _mean(sums[part], len(use), newest[part])
    trainer.load_checkpoint(newest)
    return tuple(int(s) for s in use)
