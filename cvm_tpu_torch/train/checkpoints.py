"""Checkpoint manager: keep-N, self-describing, exact resume, asynchronous
writes.

Mirrors ``cvm_tpu/train/checkpoints.py`` (``CheckpointManager``,
``BestCheckpoint``, ``load_params_cfg``) with ``torch.save``/``torch.load``
in place of Orbax. A checkpoint is one file ``<directory>/<step>.pt``,
written to a temporary name and moved into place with ``os.replace``, so a
reader sees a whole checkpoint or none. The model's hyperparameters are
stored beside them as ``params.json``.

Saves are asynchronous, as the reference's Orbax manager's
(``enable_async_checkpointing=True``): ``save`` takes a snapshot of the
state and returns, and one writer thread writes it. The snapshot copies
each device tensor into a pinned host buffer (kept and reused by the next
save) with ``non_blocking=True`` on the current stream, so the in-place
updates of the steps enqueued after ``save`` run after the copy, and
records a CUDA event after the copies; CPU tensors are cloned and every
other object deep-copied. The writer waits for the event, then writes the
temporary file, moves it into place and drops all but the newest ``keep``
steps, in that order. At most one save is in flight: ``save`` first waits
for the one before, as Orbax's does. A write that fails raises at the next
``save``, ``wait`` or ``close``. A process that dies while a write is in
flight leaves its temporary file, which ``all_steps`` ignores, and the
previous checkpoints whole. Opening a manager removes nothing: another
process (a trainer's writer thread) may be writing in the directory.

Under multi-process training only rank 0 writes (Orbax coordinates one
write for the reference): the other ranks hold a manager with ``writer``
False, which creates nothing and whose ``save`` does nothing; the
``Trainer`` gathers the state first.
"""

from __future__ import annotations

import copy
import json
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, params_cfg=None, writer: bool = True):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep, self.writer = keep, writer
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[Tuple, torch.Tensor] = {}  # snapshot buffers, by place in the state
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

    @property
    def pinned_bytes(self) -> int:
        """The bytes of pinned host memory the snapshots hold."""
        return sum(t.numel() * t.element_size() for t in self._pinned.values())

    def _snapshot(self, obj: Any, place: Tuple, events: Dict) -> Any:
        if torch.is_tensor(obj):
            t = obj.detach()
            if t.device.type != "cuda":
                return t.clone()
            buf = self._pinned.get(place)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self._pinned[place] = torch.empty(t.shape, dtype=t.dtype,
                                                        pin_memory=True)
            buf.copy_(t, non_blocking=True)
            events.setdefault(t.device, None)
            return buf
        if isinstance(obj, dict):
            return {k: self._snapshot(v, place + (k,), events) for k, v in obj.items()}
        if type(obj) in (list, tuple):
            return type(obj)(self._snapshot(v, place + (i,), events) for i, v in enumerate(obj))
        return copy.deepcopy(obj)

    def save(self, step: int, state: Any) -> None:
        """Snapshot ``state`` (tensors, numbers, strings, lists, dicts) and
        write it as ``step`` in the background, then drop all but the
        newest ``keep`` steps (nothing when this is not the writer). Waits
        for the save before it first; raises its error."""
        if not self.writer:
            return
        self.wait()
        events: Dict[torch.device, Any] = {}
        snap = self._snapshot(state, (), events)
        for dev in events:  # after the copies on each card's current stream
            events[dev] = torch.cuda.Event()
            events[dev].record(torch.cuda.current_stream(dev))
        self._thread = threading.Thread(target=self._write, args=(int(step), snap,
                                                                  list(events.values())),
                                        name=f"checkpoint-{int(step)}", daemon=True)
        self._thread.start()

    def _write(self, step: int, snap: Any, events) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            for ev in events:
                ev.synchronize()
            torch.save(snap, tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self.keep]:
                os.remove(self._path(old))
        except BaseException as e:  # raised by the next save, wait or close
            self._error = e
            if os.path.exists(tmp):
                os.remove(tmp)

    def wait(self) -> None:
        """Wait for the save in flight, if any; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"the checkpoint write to {self.directory} failed: {e}") from e

    def close(self) -> None:
        """Wait for the save in flight and release the snapshot buffers."""
        try:
            self.wait()
        finally:
            self._pinned.clear()

    def all_steps(self) -> list:
        """Steps on disk, ascending (bounded by keep-N): whole files only."""
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
            # Honor a bar only when its checkpoint is on disk: the sidecar
            # is written when the (asynchronous) save is issued.
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

    def close(self) -> None:
        self._mngr.close()


def load_params_cfg(directory: str, params_cls):
    """Rebuild the typed Params object stored next to the checkpoints."""
    with open(os.path.join(os.path.abspath(directory), "params.json")) as f:
        return params_cls.from_dict(json.load(f))
