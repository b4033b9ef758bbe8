"""Checkpoint manager: keep-N, self-describing, exact resume.

Mirrors ``cvm_tpu/train/checkpoints.py`` (``CheckpointManager``,
``BestCheckpoint``, ``load_params_cfg``) with ``torch.save``/``torch.load``
in place of Orbax. A checkpoint is one file ``<directory>/<step>.pt``,
written to a temporary name and moved into place with ``os.replace``, so a
reader sees a whole checkpoint or none. The model's hyperparameters are
stored beside them as ``params.json``. Saves are synchronous: ``wait`` has
nothing to wait for and is kept for the reference's interface.

Under multi-process training only rank 0 writes (Orbax coordinates one
write for the reference): the other ranks hold a manager with ``writer``
False, which creates nothing and whose ``save`` does nothing; the
``Trainer`` gathers the state first and waits for rank 0 after.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, params_cfg=None, writer: bool = True):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep, self.writer = keep, writer
        if not writer:
            return
        os.makedirs(self.directory, exist_ok=True)
        if params_cfg is not None:
            cfg_path = os.path.join(self.directory, "params.json")
            if not os.path.exists(cfg_path):
                with open(cfg_path, "w") as f:
                    f.write(params_cfg.to_json())

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` (tensors, numbers, strings, lists, dicts) as
        ``step``, then drop all but the newest ``keep`` steps (nothing when
        this is not the writer)."""
        if not self.writer:
            return
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.keep]:
            os.remove(self._path(old))

    def all_steps(self) -> list:
        """Steps on disk, ascending (bounded by keep-N)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_step(self, step: int, map_location=None) -> Any:
        """Load a specific retained step onto ``map_location``."""
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def restore_latest(self, map_location=None) -> Optional[Any]:
        """Load the newest checkpoint (or None when there is none)."""
        step = self.latest_step()
        return None if step is None else self.restore_step(step, map_location)

    def wait(self) -> None:
        """Saves complete before ``save`` returns."""


class BestCheckpoint:
    """Keep the single best-by-eval-metric checkpoint (``--keep_best``): a
    keep-1 manager under ``directory`` plus a ``best.json`` sidecar
    ({metric, mode, value, step}) so the bar survives restarts."""

    def __init__(self, directory: str, metric: str, mode: str = "max", params_cfg=None):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be max or min, got {mode!r}")
        self.metric, self.mode = metric, mode
        self._mngr = CheckpointManager(directory, keep=1, params_cfg=params_cfg)
        self._meta = os.path.join(self._mngr.directory, "best.json")
        self.best: Optional[float] = None
        if os.path.exists(self._meta):
            with open(self._meta) as f:
                d = json.load(f)
            # Honor a bar only when its checkpoint is on disk.
            if (d.get("metric") == metric and d.get("mode", "max") == mode
                    and self._mngr.latest_step() == int(d.get("step", -1))):
                self.best = float(d["value"])

    def update(self, step: int, state: Any, value: float) -> bool:
        """Save ``state`` iff ``value`` beats the stored best; True when a new
        best was recorded."""
        value = float(value)
        better = self.best is None or (value > self.best if self.mode == "max"
                                       else value < self.best)
        if not better:
            return False
        self.best = value
        self._mngr.save(int(step), state)
        tmp = self._meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"metric": self.metric, "mode": self.mode, "value": value,
                       "step": int(step)}, f)
        os.replace(tmp, self._meta)
        return True

    def wait(self) -> None:
        self._mngr.wait()


def load_params_cfg(directory: str, params_cls):
    """Rebuild the typed Params object stored next to the checkpoints."""
    with open(os.path.join(os.path.abspath(directory), "params.json")) as f:
        return params_cls.from_dict(json.load(f))
