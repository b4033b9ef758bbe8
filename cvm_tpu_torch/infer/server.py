"""Dynamic batching of single-image requests into fixed-size batches.

Port of ``cvm_tpu/infer/server.py::DynamicBatcher`` (stdlib + numpy there
too). The reference module cannot be imported here: ``cvm_tpu.infer``
imports flax eagerly. The HTTP ``ModelServer`` is not ported yet (ROADMAP
Queue 1 item 11: its requests start from the JPEG decoder). The one
change: a ``model_fn`` may return torch tensors (on any device); each is
copied to the host once per batch before the per-request fan-out.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cvm_tpu_torch.utils.batch import pad_rows


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class OverloadedError(RuntimeError):
    """The batcher's bounded request queue is full (shed load, retry later)."""


class _Request:
    __slots__ = ("args", "event", "out", "err", "t_enqueue")

    def __init__(self, args: Tuple[np.ndarray, ...]):
        self.args = args  # each array has leading batch dim 1
        self.event = threading.Event()
        self.out: Optional[Dict[str, np.ndarray]] = None
        self.err: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()


class DynamicBatcher:
    """Coalesce concurrent single-item requests into fixed-size batches.

    model_fn(*data_args) takes batch-first arrays with batch == batch_size
    exactly (the exported program's static shape) and returns a dict of
    batch-first arrays. Items are tuples of (1, ...)-shaped arrays.
    """

    def __init__(
        self,
        model_fn: Callable[..., Dict[str, Any]],
        batch_size: int,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        bucket_sizes: Optional[Sequence[int]] = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model_fn = model_fn
        self.batch_size = batch_size
        # Multi-batch artifacts: pad a short collection window to the
        # smallest bucket that fits instead of the full static batch —
        # 2 requests on a {1,4,8} artifact dispatch at 4, not 8.
        self.bucket_sizes = sorted(b for b in (bucket_sizes or [])
                                   if b <= batch_size)
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        # Stats (single-writer: the batcher thread; benign cross-thread reads).
        self.n_requests = 0
        self.n_batches = 0
        self.n_padded_rows = 0
        self.latency_ms = _Ring(1024)  # enqueue -> result, per request
        self.batch_ms = _Ring(1024)   # model_fn wall, per batch
        self._thread = threading.Thread(
            target=self._loop, name="dynamic-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, args: Sequence[np.ndarray],
               timeout_s: float = 120.0,
               enqueue_timeout_s: float = 1.0) -> Dict[str, np.ndarray]:
        """Block until this item's slice of a batched dispatch returns.

        Raises OverloadedError (not a bare queue.Full) when the bounded queue
        stays full for enqueue_timeout_s — callers map it to backpressure
        (HTTP 503), distinct from a dispatch failure (500).
        """
        req = _Request(tuple(np.asarray(a) for a in args))
        for a in req.args:
            if a.shape[:1] != (1,):
                raise ValueError(
                    f"submit() items are single rows with a leading batch dim "
                    f"of 1, got shape {a.shape}"
                )
        try:
            self._q.put(req, timeout=enqueue_timeout_s)
        except queue.Full:
            raise OverloadedError(
                f"request queue full ({self._q.maxsize} pending)"
            ) from None
        if not req.event.wait(timeout_s):
            raise TimeoutError(f"no result within {timeout_s}s")
        if req.err is not None:
            raise RuntimeError(f"batched dispatch failed: {req.err!r}") from req.err
        assert req.out is not None
        return req.out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    # -- batcher thread ------------------------------------------------------

    def _collect(self):
        """One blocking get, then drain up to batch_size within max_wait."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            n = len(batch)
            try:
                target = self.batch_size
                for b in self.bucket_sizes:
                    if b >= n:
                        target = b
                        break
                data = pad_rows(
                    [np.concatenate([r.args[k] for r in batch], axis=0)
                     for k in range(len(batch[0].args))],
                    target,
                )
                pad = target - n
                t0 = time.perf_counter()
                out = self.model_fn(*data)
                out = {k: _to_numpy(v) for k, v in out.items()}
                dt = time.perf_counter() - t0
                self.batch_ms.add(dt * 1e3)
                self.n_batches += 1
                self.n_padded_rows += pad
                now = time.perf_counter()
                for i, r in enumerate(batch):
                    r.out = {k: v[i : i + 1] for k, v in out.items()}
                    self.latency_ms.add((now - r.t_enqueue) * 1e3)
                    self.n_requests += 1
                    r.event.set()
            except Exception as e:  # fan the failure out, keep serving
                for r in batch:
                    r.err = e
                    r.event.set()

    def stats(self) -> Dict[str, Any]:
        total_rows = self.n_requests + self.n_padded_rows
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "batch_size": self.batch_size,
            "batch_fill": round(self.n_requests / total_rows, 4)
            if total_rows else 0.0,
            "latency_ms": self.latency_ms.percentiles(),
            "model_ms": self.batch_ms.percentiles(),
            "queue_depth": self._q.qsize(),
        }


class _Ring:
    """Fixed-size sample ring for percentile stats (no deps, O(1) add)."""

    def __init__(self, n: int):
        self._buf = np.zeros(n, np.float64)
        self._i = 0
        self._full = False

    def add(self, v: float) -> None:
        self._buf[self._i] = v
        self._i = (self._i + 1) % len(self._buf)
        self._full = self._full or self._i == 0

    def percentiles(self) -> Dict[str, float]:
        vals = self._buf if self._full else self._buf[: self._i]
        if not len(vals):
            return {}
        return {
            "p50": round(float(np.percentile(vals, 50)), 2),
            "p90": round(float(np.percentile(vals, 90)), 2),
            "p99": round(float(np.percentile(vals, 99)), 2),
            "n": int(len(vals)),
        }
