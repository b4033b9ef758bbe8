"""Profiling helpers; mirrors ``cvm_tpu/utils/prof.py`` (``trace``,
``start_server``, ``StepTimer``).

``trace`` records a ``torch.profiler`` trace (host and, on a card, CUDA
activity) and writes it as a Chrome trace file (``trace.json``, readable
by Perfetto or ``chrome://tracing``) into ``log_dir``; the reference writes
``jax.profiler``'s. ``StepTimer.section(block_on=...)`` synchronizes the
devices of the given tensors before it stops its clock, as the reference's
``block_until_ready`` does, so a section times the device's work and not
its enqueueing. ``start_server`` has no PyTorch counterpart: it raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: CPU activity, and CUDA activity when a card is
    present; ``<log_dir>/trace.json`` on exit. Yields the profiler (its
    ``key_averages()`` sums time by op and kernel)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def start_server(port: int = 9999):
    """The reference starts ``jax.profiler``'s live capture server here.
    PyTorch has no such server (its profiler records in-process, on demand),
    so this raises."""
    raise NotImplementedError(
        f"start_server(port={port}): PyTorch's profiler has no remote capture server; "
        "record a window with utils.prof.trace or cli.train --profile_steps")


def _synchronize(block_on) -> None:
    """Wait for the devices of every tensor in ``block_on`` (a tensor, or a
    dict / list / tuple of them, nested)."""
    if isinstance(block_on, torch.Tensor):
        if block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
    elif isinstance(block_on, dict):
        for v in block_on.values():
            _synchronize(v)
    elif isinstance(block_on, (list, tuple)):
        for v in block_on:
            _synchronize(v)


class StepTimer:
    """Named wall-clock sections; ``block_on`` tensors are synchronized
    before a section's clock stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        """Mean ms per section."""
        return {name: self.totals[name] / max(self.counts[name], 1) * 1e3
                for name in self.totals}

    def report(self) -> str:
        return "  ".join(f"{k}={v:.1f}ms" for k, v in sorted(self.summary().items()))
