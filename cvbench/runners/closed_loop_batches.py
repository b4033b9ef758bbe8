"""Closed loop of batches through ``InferencePipeline``: the next batch goes
in as soon as the last batch's outputs are on the host, as an offline job
over stored or fleet frames runs (``cli.infer``, ``cli.evaluate``).

Set-up builds the program's model with weights from the seed, the pipeline
in the mix's posture (``fold_bn``), and the mix's pool of frames, stacked
once into batches of the configuration's ``batch_size`` (so the window
stacks nothing on the host), and runs every batch once: the first call of
the one input signature runs eagerly, the second captures the step's CUDA
graph, the rest replay it. The window calls ``InferencePipeline.__call__`` batch after
batch, in a seeded permutation renewed when spent, and copies each of the
mix's ``outputs`` to the host; ``infer_images_per_s`` is the frames
completed over the window. A seeded sample of the finished frames, each
with its own row of the batch's outputs (a batch axis of 1), is kept for
the check.

Counters: the frames of the window and of the traced stretch, the
reference's FLOPs per frame, and the window's ``graph_counts`` deltas
(replays and each reason for an eager call).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from cvbench import program
from cvbench.guard import assert_clean
from cvbench.reference.flops import forward_flops
from cvbench.trace import Tracer, print_per_second
from cvbench.traffic.generator import Reservoir, frame_pool, stream


def stack(pool: List[Dict[str, np.ndarray]], size: int) -> List[Dict[str, np.ndarray]]:
    """The pool's frames (each with a batch axis of 1) in batches of
    ``size``, in pool order: frame ``i`` is row ``i % size`` of batch
    ``i // size``."""
    if len(pool) % size:
        raise ValueError(f"a pool of {len(pool)} frames does not fill batches of {size}")
    return [{k: np.ascontiguousarray(np.concatenate([f[k] for f in pool[i:i + size]]))
             for k in pool[0]} for i in range(0, len(pool), size)]


def fetch(out: Dict[str, torch.Tensor], keys) -> Dict[str, torch.Tensor]:
    """The outputs ``keys`` of one call, on the host."""
    return {k: out[k].cpu() for k in keys}


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, tmp: str,
        t_process: float) -> dict:
    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    params, model, weights = program.build(cfg, seed, device)
    pipe = InferencePipeline(params, model, device, input_format="yuv420",
                             fold_bn=bool(mix["fold_bn"]))
    del model
    size = int(cfg["params"]["batch_size"])
    pool = frame_pool(stream(seed, 1), mix, cfg["params"]["num_classes"])
    batches = stack(pool, size)
    keys = tuple(mix["outputs"])
    for b in batches:                    # warm-up: first sighting, capture, replays
        fetch(pipe(b), keys)
    order_rng, keep = stream(seed, 2), Reservoir(stream(seed, 3), int(mix["check"]["frames"]))
    tracer = Tracer(trace, float(mix["trace_start_s"]), float(mix["trace_s"]), tmp, device)
    tracer.warm()
    assert_clean("set-up")
    program.settle(device)
    counts0 = dict(pipe.graph_counts)
    n = n_stretch = 0
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
        n += size
        n_stretch += size * tracer.active()
        for r in range(size):
            keep.offer((bi * size + r, r, res))
    window_s = time.perf_counter() - t0
    tracer.close()
    counts = {k: v - counts0[k] for k, v in pipe.graph_counts.items()}
    print_per_second("batches", ends, t0, window_s)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "setup_s": setup_s, "e2e": {"infer_images_per_s": n / window_s},
        "attempted": n, "failed": 0, "memory_peak_bytes": peak,
        "samples": [(pool[fi], {k: v[r:r + 1].numpy() for k, v in res.items()})
                    for fi, r, res in keep.items],
        "weights": weights, "trace_events": tracer.events,
        "counters": {"frames": n, "window_s": window_s, "frames_in_stretch": n_stretch,
                     "graph_counts": counts,
                     "flops_per_frame": forward_flops(weights, program.ref_cfg(cfg))},
    }
