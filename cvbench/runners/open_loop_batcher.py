"""Open loop through ``DynamicBatcher`` over an exported ``ServingModel``:
independent cameras send single frames as a Poisson process at the mix's
fixed rate, whether or not earlier frames are back.

Set-up builds the program's model with weights from the seed, writes it as
a training checkpoint and exports it the way ``cli.export`` does
(``export_model``: the mix's ``quantize`` posture, calibrated in the export,
planar YUV420 input, one program per bucket of ``buckets``), loads the
artifact as a server does (``ServingModel``) and puts the batcher in front
of it. Every bucket is warmed up, directly and through the batcher.

In the window a scheduler thread hands each request, at its due time, to
one of ``clients`` sender threads, which calls ``DynamicBatcher.submit``.
A request's latency runs from its due time to its result on the host, so
a late generator or a stall counts against every request it delays; a
request that fails counts as missing. ``serve_p95_ms`` is the 95th
percentile over all requests due in the window.

Each request's latency is also split where the harness can see it: due to
submit (the generator and the sender threads: the harness's own share),
submit to dispatch (the batcher's queue and collection wait) and dispatch
to result (the batch's call, its copy to the host and the fan-out). The
dispatch of each batch is taken where the batcher calls the model; the
requests are matched to the batches in the order they were submitted, as
the batcher's queue takes them.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from cvbench import program
from cvbench.guard import assert_clean
from cvbench.reference.flops import forward_flops
from cvbench.trace import Tracer
from cvbench.traffic.generator import stream, frame_pool, pick, poisson_schedule, request_order

KEYS = ("y", "u", "v", "image_hw")


def export(cfg: dict, mix: dict, seed: int, device, tmp: str):
    """``(ServingModel, weights)``: the seeded model exported and loaded."""
    from cvm_tpu_torch.cli.export import export_model
    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.train.loop import Trainer

    params, model, weights = program.build(cfg, seed, device)
    ck, art = os.path.join(tmp, "checkpoint"), os.path.join(tmp, "artifact")
    trainer = Trainer(params, device, checkpoint_dir=ck)
    trainer.init_state()
    trainer.state.model.load_state_dict(model.state_dict())
    trainer.state.step = 1
    trainer.ckpt.save(1, trainer.checkpoint_state(None))
    trainer.ckpt.close()
    del trainer, model
    t0 = time.perf_counter()
    export_model(cfg["model"], ck, art, batch_sizes=list(mix["buckets"]),
                 pad_hw=tuple(mix["buffer_hw"]), quantize=mix["quantize"],
                 input_format="yuv420", fold_bn=False, device=str(device))
    print(f"[cvbench] export {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    shutil.rmtree(ck)
    return ServingModel(art, device), weights


class Probe:
    """The batcher's model function: the served model, and the tracer's
    clock polled on the batcher's thread before each batch, so that a
    traced stretch records that thread's host operations."""

    def __init__(self, served):
        self.served, self.tracer, self.t0 = served, None, 0.0
        self.batcher = self.at_trace = self.dispatched = None

    def __call__(self, *data):
        if self.dispatched is not None:      # (time, requests answered before this batch)
            self.dispatched.append((time.perf_counter(), self.batcher.n_requests))
        if self.tracer is not None:
            self.tracer.poll(time.perf_counter() - self.t0)
            if self.at_trace is None and self.tracer.active():
                b = self.batcher
                self.at_trace = (b.n_requests, b.n_batches, b.n_padded_rows)
        return self.served(*data)


def setup(cfg: dict, mix: dict, seed: int, device, tmp: str) -> dict:
    from cvm_tpu_torch.infer.server import DynamicBatcher

    served, weights = export(cfg, mix, seed, device, tmp)
    buckets = sorted(int(b) for b in mix["buckets"])
    probe = Probe(served)
    batcher = DynamicBatcher(probe, batch_size=buckets[-1], max_wait_ms=float(mix["max_wait_ms"]),
                             max_queue=int(mix["max_queue"]), bucket_sizes=buckets)
    probe.batcher = batcher
    pool = frame_pool(stream(seed, 1), mix, cfg["params"]["num_classes"])
    senders = ThreadPoolExecutor(max_workers=int(mix["clients"]))
    for b in buckets:                   # every bucket, directly and through the batcher
        for r in range(3):
            rows = [pool[(r * b + i) % len(pool)] for i in range(b)]
            served(*(np.concatenate([f[k] for f in rows]) for k in KEYS))["scores"].cpu()
            futs = [senders.submit(batcher.submit, tuple(f[k] for k in KEYS)) for f in rows]
            for f in futs:
                f.result()
    assert_clean("set-up")
    return {"served": served, "probe": probe, "batcher": batcher, "pool": pool,
            "senders": senders, "weights": weights}


def window(st: dict, rate: float, seconds: float, rng: np.random.Generator, tracer: Tracer,
           timeout_s: float = 60.0) -> dict:
    """One window of Poisson arrivals at ``rate``: per-request latency (ms,
    inf when failed), outputs, the generator's lateness, the latency's
    split (``split``) and the batcher's counters over the window."""
    batcher, pool = st["batcher"], st["pool"]
    due = poisson_schedule(rng, rate, seconds)
    order = request_order(rng, len(pool), len(due))
    n = len(due)
    done = np.full(n, np.nan)
    submitted = np.full(n, np.nan)
    outs = [None] * n
    errors = []
    late = np.zeros(n)

    def send(i: int, t_due: float) -> None:
        f = pool[order[i]]
        submitted[i] = time.perf_counter() - t_due
        try:
            outs[i] = batcher.submit(tuple(f[k] for k in KEYS), timeout_s=timeout_s,
                                     enqueue_timeout_s=timeout_s)
            done[i] = time.perf_counter() - t_due
        except Exception as e:  # a failed or refused request counts as missing
            errors.append(repr(e))

    c0 = (batcher.n_requests, batcher.n_batches, batcher.n_padded_rows)
    futs = []
    t0 = time.perf_counter() + 0.01
    probe = st.get("probe")
    if probe is not None:
        probe.t0, probe.tracer, probe.at_trace, probe.dispatched = t0, tracer, None, []
    for i, d in enumerate(due):
        target = t0 + d
        now = time.perf_counter()
        if now < target:
            time.sleep(target - now)
            now = time.perf_counter()
        late[i] = now - target
        futs.append(st["senders"].submit(send, i, target))
    wait(futs, timeout=timeout_s + 5.0)
    t_end = time.perf_counter()
    split = None
    if probe is not None:
        probe.tracer = None
        split = latency_split(t0 + due, submitted, done, probe.dispatched,
                              batcher.n_requests)
        probe.dispatched = None
    tracer.close()
    # a traced window's counters stop where its stretch starts: the
    # profiler's start and stop stall the batcher's thread
    c1 = (batcher.n_requests, batcher.n_batches, batcher.n_padded_rows)
    if probe is not None and probe.at_trace is not None:
        c1 = probe.at_trace
    lat = np.where(np.isnan(done), np.inf, done * 1e3)
    return {"latency_ms": lat, "outs": outs, "order": order, "late_s": late,
            "errors": errors, "window_s": t_end - t0, "split": split,
            "requests": c1[0] - c0[0], "batches": c1[1] - c0[1], "padded_rows": c1[2] - c0[2]}


def latency_split(due: np.ndarray, submitted: np.ndarray, done: np.ndarray,
                  dispatched: list, answered: int):
    """Per-request seconds from due to submit, submit to dispatch and
    dispatch to result (``submitted`` and ``done`` count from the due time;
    ``dispatched`` is each batch's (time, requests answered before it),
    ``answered`` the batcher's count at the end). The requests, in the
    order they were submitted, fill the batches in turn. None where the
    counts do not match (a failed request)."""
    if not dispatched or np.isnan(done).any():
        return None
    sizes = np.diff([a for _, a in dispatched] + [answered])
    if sizes.sum() != len(due) or (sizes < 1).any():
        return None
    t_sub = due + submitted
    batch = np.repeat(np.arange(len(sizes)), sizes)[np.argsort(np.argsort(t_sub))]
    t_disp = np.array([t for t, _ in dispatched])[batch]
    return {"due_to_submit": submitted, "submit_to_dispatch": t_disp - t_sub,
            "dispatch_to_result": due + done - t_disp}


def split_summary(split) -> dict:
    """p50 and p95 (ms) and the share of the mean latency of each part."""
    if split is None:
        return {}
    total = sum(float(v.mean()) for v in split.values())
    return {k: {"p50_ms": float(np.percentile(v, 50) * 1e3),
                "p95_ms": float(np.percentile(v, 95) * 1e3),
                "share": float(v.mean()) / total} for k, v in split.items()}


def p95(latency_ms: np.ndarray) -> float:
    """The nearest-rank 95th percentile; a missing request is infinitely late."""
    s = np.sort(latency_ms)
    return float(s[int(np.ceil(0.95 * len(s))) - 1])


def close(st: dict) -> None:
    st["batcher"].close()
    st["senders"].shutdown(wait=True)


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, tmp: str,
        t_process: float) -> dict:
    st = setup(cfg, mix, seed, device, tmp)
    tracer = Tracer(trace, float(mix["trace_start_s"]), float(mix["trace_s"]), tmp, device)
    tracer.warm()
    program.settle(device)
    setup_s = time.perf_counter() - t_process
    w = window(st, float(mix["rate"]), seconds, stream(seed, 2), tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    close(st)
    n, failed = len(w["latency_ms"]), int(np.isinf(w["latency_ms"]).sum())
    if w["errors"]:
        print(f"[cvbench] {failed} requests failed, first: {w['errors'][0]}", file=sys.stderr)
    print(f"[cvbench] {n} requests, generator late p95 {np.percentile(w['late_s'], 95) * 1e3:.3f} ms "
          f"max {w['late_s'].max() * 1e3:.3f} ms, batches {w['batches']}", file=sys.stderr, flush=True)
    split = split_summary(w["split"])
    for k, v in split.items():
        print(f"[cvbench] latency split {k}: p50 {v['p50_ms']:.3f} ms p95 {v['p95_ms']:.3f} ms "
              f"share of the mean {v['share']:.3f}", file=sys.stderr, flush=True)
    ok = [i for i in range(n) if w["outs"][i] is not None]
    chosen = pick(stream(seed, 3), ok, int(mix["check"]["requests"]))
    samples = [(st["pool"][w["order"][i]], w["outs"][i]) for i in chosen]
    weights = st["weights"]
    del st
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "setup_s": setup_s,
        "e2e": {"serve_p95_ms": min(p95(w["latency_ms"]), 1e3 * 60.0)},
        "attempted": n, "failed": failed, "memory_peak_bytes": peak,
        "samples": samples, "weights": weights, "trace_events": tracer.events,
        "counters": {"frames": len(ok), "window_s": w["window_s"],
                     "requests": w["requests"], "batches": w["batches"],
                     "padded_rows": w["padded_rows"], "latency_split": split,
                     "flops_per_frame": forward_flops(weights, program.ref_cfg(cfg))},
    }
