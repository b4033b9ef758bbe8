"""The program's own spans in a traced stretch, and the split of a frame
they give.

    python -m cvbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``python -m cvbench.run --trace 1`` does (set-up, window,
check) and prints one JSON object: for every range whose name starts with
``cvm.`` (``cvm_tpu_torch/utils/prof.py::span``) its ``Span`` sums over
the stretch, the frame split per ``cvm.infer.call``, the consistency of
the spans with the harness's frame count and kernel count, and how the
device's clock lines up with the host's (each kernel's start less the
start of the op that launched it, and less its runtime launch call). A
run needs a CUDA card, as ``cvbench.run`` does; the result line of
``cvbench.run`` does not carry these numbers (no per-layer metric reads
them yet).

``reduce_spans`` works on the trace's event list alone, with the stretch
and device operations as ``cvbench/trace.py::reduce`` takes them, so
tests feed it hand-built events.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

from cvbench.trace import DEVICE_CATS, HOST_CATS, STRETCH, _union, reduce

PREFIX = "cvm."                      # the program's ranges
CALL = "cvm.infer.call"
STAGES = ("cvm.infer.h2d", "cvm.infer.preprocess", "cvm.infer.forward", "cvm.infer.postprocess")


class Span(NamedTuple):
    n: int              # ranges of the name that start in the stretch
    host_s: float       # their summed durations, clipped to the stretch
    kernels: int        # kernels launched from inside them (innermost range)
    device_s: float     # device time of the operations launched from inside them
    idle_s: float       # the part of their intervals in which the device ran nothing


def _stretch(events: List[dict]) -> Optional[Tuple[float, float]]:
    marks = {e["name"]: e["ts"] for e in events
             if e.get("cat") in HOST_CATS and e.get("name", "").startswith(STRETCH + ".")}
    if STRETCH + ".begin" not in marks or STRETCH + ".end" not in marks:
        return None
    return marks[STRETCH + ".begin"], marks[STRETCH + ".end"]


def _device_ops(events: List[dict], s0: float, s1: float) -> List[Tuple[float, float, dict]]:
    """Device operations clipped to the stretch, as ``trace.reduce`` takes
    them."""
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a, b = max(e["ts"], s0), min(e["ts"] + e.get("dur", 0.0), s1)
            if b > a:
                dev.append((a, b, e))
    return dev


def _launch_times(events: List[dict]) -> Dict[int, float]:
    """``External id`` -> start (µs) of the ``cpu_op`` that carries it: the
    op that launched the device operations with that id."""
    return {e["args"]["External id"]: e["ts"] for e in events
            if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}


def reduce_spans(events: List[dict]) -> Optional[Dict[str, Span]]:
    """Each ``cvm.`` range name -> its ``Span`` over the stretch; None when
    the events hold no stretch. A device operation counts to the innermost
    range open when the ``cpu_op`` that launched it started (by its
    ``External id``); busy time is the union of device operations, as
    ``trace.reduce``'s ``busy_s``."""
    st = _stretch(events)
    if st is None:
        return None
    s0, s1 = st
    dev = _device_ops(events, s0, s1)
    merged = _union([(a, b) for a, b, _ in dev])
    ranges = sorted((e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                     and e.get("name", "").startswith(PREFIX) and s0 <= e["ts"] < s1),
                    key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    starts, done = [a for a, _ in merged], [0.0]
    for a, b in merged:
        done.append(done[-1] + b - a)

    def busy_until(t: float) -> float:
        i = bisect.bisect_right(starts, t)
        return 0.0 if i == 0 else done[i - 1] + min(t, merged[i - 1][1]) - merged[i - 1][0]

    sums: Dict[str, list] = {}
    for e in ranges:
        a, b = e["ts"], min(e["ts"] + e.get("dur", 0.0), s1)
        s = sums.setdefault(e["name"], [0, 0.0, 0, 0.0, 0.0])
        s[0] += 1
        s[1] += b - a
        s[4] += (b - a) - (busy_until(b) - busy_until(a))
    # a sweep over range starts and launch times, with a stack of open ranges
    launched = _launch_times(events)
    by_launch = sorted((launched[x["args"]["External id"]], b - a, x["cat"] == "kernel")
                       for a, b, x in dev if x.get("args", {}).get("External id") in launched)
    stack, i = [], 0
    for t, seconds, is_kernel in by_launch:
        while i < len(ranges) and ranges[i]["ts"] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0.0) < t:
            stack.pop()
        if stack:
            s = sums[stack[-1]["name"]]
            s[2] += is_kernel
            s[3] += seconds
    return {name: Span(n, host * 1e-6, k, d * 1e-6, idle * 1e-6)
            for name, (n, host, k, d, idle) in sums.items()}


def frame_split(spans: Dict[str, Span], window_s: float, frames: int) -> Optional[dict]:
    """Milliseconds per frame: each stage's host time per ``cvm.infer.call``,
    the call's self time (the call less its stages), and the stretch's
    frame period less the call (the caller's loop between calls)."""
    call = spans.get(CALL)
    if call is None or not call.n or not frames:
        return None
    out = {s: 1e3 * spans[s].host_s / call.n for s in STAGES if s in spans}
    out["call_self"] = 1e3 * (call.host_s - sum(spans[s].host_s for s in STAGES if s in spans)) \
        / call.n
    out["outside_call"] = 1e3 * (window_s / frames - call.host_s / call.n)
    return out


def launch_leads(events: List[dict]) -> Dict[str, List[float]]:
    """For each kernel in the stretch, in µs: its start less the start of
    the ``cpu_op`` that launched it (``op``), and less the start of its
    runtime launch call, matched by ``correlation`` (``runtime``). Both are
    at least 0 where the device's clock and the host's agree."""
    st = _stretch(events)
    if st is None:
        return {"op": [], "runtime": []}
    launched = _launch_times(events)
    runtime = {e["args"]["correlation"]: e["ts"] for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    op, rt = [], []
    for a, b, e in _device_ops(events, *st):
        if e["cat"] != "kernel":
            continue
        args = e.get("args", {})
        if args.get("External id") in launched:
            op.append(e["ts"] - launched[args["External id"]])
        if args.get("correlation") in runtime:
            rt.append(e["ts"] - runtime[args["correlation"]])
    return {"op": op, "runtime": rt}


def _quantiles(xs: List[float]) -> dict:
    if len(xs) < 2:
        return {"n": len(xs)}
    q = statistics.quantiles(xs, n=100)
    return {"n": len(xs), "below_0": sum(x < 0 for x in xs), "min": min(xs), "p1": q[0],
            "p50": q[49], "p99": q[98], "max": max(xs)}


def summary(events: List[dict], counters: dict) -> dict:
    """What ``main`` prints of one traced run's events and counters."""
    tr, spans = reduce(events), reduce_spans(events)
    if tr is None or spans is None:
        return {"spans": None}
    frames = counters.get("frames_in_stretch", 0)
    kernels = sum(s.kernels for s in spans.values())
    leads = launch_leads(events)
    call = spans.get(CALL)
    return {
        "spans": {k: v._asdict() for k, v in spans.items()},
        "split_ms": frame_split(spans, tr.window_s, frames),
        "frames_in_stretch": frames, "window_s": tr.window_s,
        "calls": None if call is None else call.n,
        "stages_within_call": None if call is None else
        sum(spans[s].host_s for s in STAGES if s in spans) <= call.host_s,
        "kernels": {"in_spans": kernels, "outside": tr.n_kernels - kernels,
                    "n_kernels": tr.n_kernels},
        "launch_lead_us": {k: _quantiles(v) for k, v in leads.items()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from cvbench import run
    from cvbench.guard import assert_clean

    run.cache_env()
    spec = run.cell_spec(args.workload, run.manifest())
    import torch

    if not torch.cuda.is_available():
        print("cvbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="cvbench-") as tmp:
        out = run.run_cell(spec, args.seed, args.seconds, True, device, tmp)
    assert_clean("the run")
    res = run.report(spec, out, True, device)
    print(json.dumps({"correct": res["correct"], "device": res["device"],
                      "metrics": res["metrics"], "breakdown": res.get("breakdown"),
                      **summary(out["trace_events"] or [], out["counters"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
