"""Closed loop of batches of frame pairs through ``InferencePipeline``, for a
two-frame model (DMDS: depth of frame t and the ego-motion from t to t+1):
the next batch goes in as soon as the last batch's outputs are on the host,
as an offline labelling job over recorded drives runs (``cli.infer --model
dmds``, ``cli.evaluate``).

Set-up builds the program's model with weights from the seed, the pipeline
in the mix's posture (``fold_bn``), and the mix's pool of pairs
(``traffic/pairs.py``), stacked once into batches of the configuration's
``batch_size``, and runs every batch once: the first call of the one input
signature runs eagerly, the second captures the step's CUDA graph, the rest
replay it. The window calls ``InferencePipeline.__call__`` batch after batch,
in a seeded permutation renewed when spent, and copies each of the mix's
``outputs`` to the host. A pair counts as one image in
``infer_images_per_s``: in a video stream each new frame makes one pair. A
seeded sample of the finished pairs, each with its own row of the batch's
outputs, is kept for the check.

Counters: the pairs of the window and of the traced stretch, the
reference's FLOPs per pair for the served outputs only
(``reference/dmds.py::served_flops``), the window's ``graph_counts`` deltas,
and the model's network passes over the window's pipeline calls
(``net_passes``, ``calls``: the model class's ``depth_passes`` and
``motion_passes`` deltas; left out where the class has no such counters).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from cvbench import program
from cvbench.guard import assert_clean
from cvbench.reference.dmds import served_flops
from cvbench.runners.closed_loop_batches import fetch, stack
from cvbench.trace import Tracer, print_per_second
from cvbench.traffic.generator import Reservoir, stream
from cvbench.traffic.pairs import pair_pool

PASS_COUNTERS = ("depth_passes", "motion_passes")


def net_passes(model_cls) -> Optional[int]:
    """The model class's network passes so far, or None where it counts none."""
    counts = [getattr(model_cls, k, None) for k in PASS_COUNTERS]
    return None if None in counts else sum(counts)


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, tmp: str,
        t_process: float) -> dict:
    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    params, model, weights = program.build(cfg, seed, device)
    pipe = InferencePipeline(params, model, device, input_format="yuv420",
                             fold_bn=bool(mix["fold_bn"]))
    model_cls = type(model)
    del model
    size = int(cfg["params"]["batch_size"])
    pool = pair_pool(stream(seed, 1), mix)
    batches = stack(pool, size)
    keys = tuple(mix["outputs"])
    for b in batches:                    # warm-up: first sighting, capture, replays
        fetch(pipe(b), keys)
    order_rng, keep = stream(seed, 2), Reservoir(stream(seed, 3), int(mix["check"]["frames"]))
    tracer = Tracer(trace, float(mix["trace_start_s"]), float(mix["trace_s"]), tmp, device)
    tracer.warm()
    assert_clean("set-up")
    program.settle(device)
    counts0, passes0 = dict(pipe.graph_counts), net_passes(model_cls)
    n = n_stretch = calls = 0
    perm, at = order_rng.permutation(len(batches)), 0
    ends = []
    setup_s = time.perf_counter() - t_process
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        tracer.poll(now)
        if at == len(perm):
            perm, at = order_rng.permutation(len(batches)), 0
        bi = int(perm[at])
        at += 1
        res = fetch(pipe(batches[bi]), keys)
        ends.append(time.perf_counter())
        calls += 1
        n += size
        n_stretch += size * tracer.active()
        for r in range(size):
            keep.offer((bi * size + r, r, res))
    window_s = time.perf_counter() - t0
    tracer.close()
    counts = {k: v - counts0[k] for k, v in pipe.graph_counts.items()}
    passes = net_passes(model_cls)
    print_per_second("batches", ends, t0, window_s)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    counters = {"frames": n, "window_s": window_s, "frames_in_stretch": n_stretch,
                "graph_counts": counts, "calls": calls,
                "flops_per_frame": served_flops(weights, program.ref_cfg(cfg))}
    if passes is not None:
        counters["net_passes"] = passes - passes0
    return {
        "setup_s": setup_s, "e2e": {"infer_images_per_s": n / window_s},
        "attempted": n, "failed": 0, "memory_peak_bytes": peak,
        "samples": [(pool[fi], {k: v[r:r + 1].numpy() for k, v in res.items()})
                    for fi, r, res in keep.items],
        "weights": weights, "trace_events": tracer.events, "counters": counters,
    }
