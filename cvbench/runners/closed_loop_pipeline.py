"""Closed loop through ``InferencePipeline``: one camera sends its next frame
as soon as the last frame's result is on the host.

Set-up builds the program's model with weights from the seed, the pipeline
in the mix's posture (``fold_bn``), and the mix's pool of frames, and runs
every pool frame once (the only shape the window uses). The window calls
``InferencePipeline.__call__`` frame after frame and copies the mix's
``output`` to the host; ``infer_images_per_s`` is the frames completed over
the window. A seeded sample of the finished frames is kept for the check.
"""

from __future__ import annotations

import time

import torch

from cvbench import program
from cvbench.guard import assert_clean
from cvbench.reference.flops import forward_flops
from cvbench.trace import Tracer, print_per_second
from cvbench.traffic.generator import stream, Reservoir, frame_pool


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, tmp: str,
        t_process: float) -> dict:
    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    params, model, weights = program.build(cfg, seed, device)
    pipe = InferencePipeline(params, model, device, input_format="yuv420",
                             fold_bn=bool(mix["fold_bn"]))
    del model
    pool = frame_pool(stream(seed, 1), mix, cfg["params"]["num_classes"])
    key = mix["output"]
    for f in pool:                                   # warm-up: the one shape of the window
        pipe(f)[key].cpu()
    order_rng, keep = stream(seed, 2), Reservoir(stream(seed, 3), int(mix["check"]["frames"]))
    tracer = Tracer(trace, float(mix["trace_start_s"]), float(mix["trace_s"]), tmp, device)
    tracer.warm()
    assert_clean("set-up")
    program.settle(device)
    n = n_stretch = 0
    perm, at = order_rng.permutation(len(pool)), 0
    ends = []
    setup_s = time.perf_counter() - t_process
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        tracer.poll(now)
        if at == len(perm):
            perm, at = order_rng.permutation(len(pool)), 0
        fi = int(perm[at])
        at += 1
        res = pipe(pool[fi])[key].cpu()
        ends.append(time.perf_counter())
        n += 1
        n_stretch += tracer.active()
        keep.offer((fi, res))
    window_s = time.perf_counter() - t0
    tracer.close()
    print_per_second("frames", ends, t0, window_s)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "setup_s": setup_s, "e2e": {"infer_images_per_s": n / window_s},
        "attempted": n, "failed": 0, "memory_peak_bytes": peak,
        "samples": [(pool[fi], {key: r.numpy()}) for fi, r in keep.items],
        "weights": weights, "trace_events": tracer.events,
        "counters": {"frames": n, "window_s": window_s, "frames_in_stretch": n_stretch,
                     "flops_per_frame": forward_flops(weights, program.ref_cfg(cfg))},
    }
