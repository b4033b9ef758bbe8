"""Profiling helpers; mirrors ``cvm_tpu/utils/prof.py`` (``trace``,
``start_server``, ``StepTimer``), and the port's one span primitive,
``span``.

``trace`` records a ``torch.profiler`` trace (host and, on a card, CUDA
activity) and writes it as a Chrome trace file (``trace.json``, readable
by Perfetto or ``chrome://tracing``) into ``log_dir``; the reference writes
``jax.profiler``'s. ``StepTimer.section(block_on=...)`` synchronizes the
devices of the given tensors before it stops its clock, as the reference's
``block_until_ready`` does, so a section times the device's work and not
its enqueueing. ``start_server`` has no PyTorch counterpart: it raises.

``span(name)`` marks a stretch of host code as a named range of the trace
(``torch.profiler.record_function``), beside the ops and kernels launched
inside it, while a ``torch.profiler`` is recording and the code is not
being compiled or exported; otherwise it costs two checks and records
nothing, so spans stay in the serving path unconditionally and leave an
exported program free of profiler ops. ``StepTimer.section(name)`` opens ``span(name)``
too. The spans the program opens (``infer/pipeline.py``):

  * ``cvm.infer.call``: one ``InferencePipeline.__call__``: staging the
    batch on the host, padding it to the batch size, the spans below, and
    slicing the results back;
  * ``cvm.infer.h2d``: the host-to-device copy of the batch's arrays (the
    planes or the RGB buffer, ``image_hw``, the intrinsics), into a
    graph's input buffers when one replays;
  * ``cvm.infer.preprocess``: the ROI, the YUV or RGB resample, the
    normalisation and the bf16 cast (both frames for DMDS);
  * ``cvm.infer.forward``: the model's forward (and hflip's second pass);
  * ``cvm.infer.postprocess``: decode, argmax and the box mapping;
  * ``cvm.infer.decode``: inside ``cvm.infer.postprocess``, CenterNet's
    and multitask's peak and top-k decode (2D or 3D) and the mapping of
    its boxes into source pixels;
  * ``cvm.dmds.depth`` and ``cvm.dmds.motion``: inside
    ``cvm.infer.forward``, each pass of DMDS's depth net and of its motion
    net (``models/dmds/model.py``; two of each a call);
  * ``cvm.infer.replay``: in place of the three stages above (and the
    spans inside them), the replay of a CUDA graph of all three
    (``infer/graphs.py``) and the clones of its outputs; no host op runs
    the stages then.

``launch_counter(owner, *names)`` registers the plain-integer counters
``owner.<name>`` that a kernel's wrapper adds to in Python at each launch,
where the wrapper is defined (``LAUNCH_COUNTERS`` lists them). A CUDA
graph's replay runs no Python, so ``infer/graphs.py`` adds to each
registered counter what the graph's capture saw it move.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch
from torch._C._autograd import _profiler_enabled


LAUNCH_COUNTERS: List[Tuple[object, str]] = []


def launch_counter(owner: object, *names: str) -> None:
    """Register ``owner.<name>`` for each of ``names`` as a launch counter
    (module docstring)."""
    for name in names:
        if (owner, name) not in LAUNCH_COUNTERS:
            LAUNCH_COUNTERS.append((owner, name))


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


class span:
    """``with span(name):`` records a ``torch.profiler`` range ``name``
    around the block while a profiler is recording and nothing compiles or
    exports the code (module docstring). A class, not a generator: a
    no-op span costs two flag reads."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _profiler_enabled() and not torch.compiler.is_compiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(*exc)


class StepTimer:
    """Named wall-clock sections, each also a ``span``; ``block_on``
    tensors are synchronized before a section's clock stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            with span(name):
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
