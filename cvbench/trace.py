"""The device trace of a traced run, and what the per-layer metrics read
from it.

``Tracer`` profiles one stretch of a few seconds inside the window with
``torch.profiler`` (CPU and CUDA activities, input shapes recorded) and
exports the Chrome trace under the run's temporary directory; ``reduce``
turns the trace's events into a ``Trace``. The reduction works on the
trace's event list alone, so tests feed it hand-built events.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events, clipped to the stretch: from the start of the
``cvbench.stretch.begin`` range the harness records once the device is idle
at its start, to the start of ``cvbench.stretch.end``, recorded once the
device has finished at its end. Busy time is the length of their
union, idle the rest of the stretch.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

STRETCH = "cvbench.stretch"          # marks "<STRETCH>.begin" and "<STRETCH>.end"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    n_kernels: int
    device_ops: List[Tuple[str, float]]        # (name, seconds), most time first
    idle_gaps: List[Tuple[str, float]]         # (what the host did, seconds), longest first
    ops: List[dict]                            # host ops that launched kernels, with their
                                               # device seconds (``device_s``)
    kernels: Dict[str, Tuple[int, float]]      # kernel name -> (calls, seconds)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _host_label(host: List[dict], t: float) -> str:
    """The innermost host range that holds time ``t`` (µs)."""
    best = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e.get("dur", 0.0):
            if best is None or e.get("dur", 0.0) < best.get("dur", 0.0):
                best = e
    return "host:" + (best["name"] if best is not None else "none")


def reduce(events: List[dict], top: int = 10) -> Optional[Trace]:
    """The ``Trace`` of one stretch; None when the events hold no stretch."""
    marks = {e["name"]: e["ts"] for e in events
             if e.get("cat") in HOST_CATS and e.get("name", "").startswith(STRETCH + ".")}
    if STRETCH + ".begin" not in marks or STRETCH + ".end" not in marks:
        return None
    s0, s1 = marks[STRETCH + ".begin"], marks[STRETCH + ".end"]
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a, b = max(e["ts"], s0), min(e["ts"] + e.get("dur", 0.0), s1)
            if b > a:
                dev.append((a, b, e))
    merged = _union([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = defaultdict(float)
    kernel_s: Dict[int, float] = defaultdict(float)
    kernels: Dict[str, Tuple[int, float]] = {}
    n_kernels = 0
    for a, b, e in dev:
        by_name[e["name"]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            n_kernels += 1
            c, t = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (c + 1, t + (b - a) * 1e-6)
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                kernel_s[ext] += (b - a) * 1e-6
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and not e.get("name", "").startswith(STRETCH) and e["ts"] < s1 and e["ts"] + e.get("dur", 0) > s0]
    gaps, prev = [], s0
    for a, b in merged + [(s1, s1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [(_host_label(host, 0.5 * (a + b)), (b - a) * 1e-6) for a, b in gaps[:top]]
    ops = []
    for e in host:
        ext = e.get("args", {}).get("External id")
        if e["cat"] == "cpu_op" and ext in kernel_s:
            ops.append(dict(e, device_s=kernel_s[ext]))
    return Trace((s1 - s0) * 1e-6, busy * 1e-6, n_kernels,
                 sorted(by_name.items(), key=lambda kv: -kv[1])[:top], idle, ops, kernels)


class Tracer:
    """Profiles a stretch of ``length_s`` seconds from ``start_s`` into the
    window (once the profiler has started) when ``on``: the runner calls
    ``poll(t)`` with seconds since the window's start from the thread that
    runs the program (the profiler records the host operations of the
    thread that starts it), and ``close()`` after the window."""

    def __init__(self, on: bool, start_s: float, length_s: float, out_dir: str, device):
        self.on, self.start_s, self.length_s = on, start_s, length_s
        self.out_dir, self.device = out_dir, device
        self.prof = self.done = None
        self.events: Optional[List[dict]] = None
        self.t_start = None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start (CUPTI's initialisation) does not fall inside the window."""
        if self.on:
            import torch

            with torch.profiler.profile(activities=self._activities()):
                torch.ones(1, device=self.device).add_(1)
                self._sync()

    def _activities(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def poll(self, t: float) -> None:
        if not self.on or self.done is not None or self.events is not None:
            return
        if self.prof is None and t >= self.start_s:
            self._start()
        elif self.prof is not None and time.perf_counter() >= self.t_start + self.length_s:
            self._stop()

    def close(self) -> None:
        """End the stretch if it is still open, and read its trace (after
        the window: the export takes seconds)."""
        if self.prof is not None:
            self._stop()
        if self.done is not None:
            path = os.path.join(self.out_dir, "trace.json")
            self.done.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
            os.remove(path)
            self.done = None

    def active(self) -> bool:
        return self.prof is not None

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self) -> None:
        import torch

        self.prof = torch.profiler.profile(activities=self._activities(), record_shapes=True)
        self.prof.__enter__()
        self._sync()
        with torch.profiler.record_function(STRETCH + ".begin"):
            pass
        self.t_start = time.perf_counter()

    def _stop(self) -> None:
        import torch

        self._sync()
        with torch.profiler.record_function(STRETCH + ".end"):
            pass
        self.prof.__exit__(None, None, None)
        self.done, self.prof = self.prof, None


def per_second(times: List[float], t0: float, window_s: float) -> List[int]:
    """How many of ``times`` (host clock) fall in each whole second of the
    window that starts at ``t0``."""
    counts = [0] * max(int(window_s + 0.999), 1)
    for t in times:
        k = int(t - t0)
        if 0 <= k < len(counts):
            counts[k] += 1
    return counts


def print_per_second(what: str, times: List[float], t0: float, window_s: float) -> None:
    """The window's progress, second by second, on standard error: whether
    a run's rate drifts inside the window or only from run to run."""
    print(f"[cvbench] {what} per second of the window: {per_second(times, t0, window_s)}",
          file=sys.stderr, flush=True)
