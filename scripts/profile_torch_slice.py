#!/usr/bin/env python3
"""Where the time goes in cvm_tpu_torch's config-B serving slice, on a card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/profile_torch_slice.py [--out DIR]

Builds config B as ``chip_smoke.py`` does (seeded weights, non-trivial BN
statistics, one calibration batch), then profiles 10 batch-8
``InferencePipeline.predict`` calls of each posture (fp with BN folded;
int8 fused + chained) with ``torch.profiler``. Prints, per posture, the wall
time per batch under the profiler, the device-busy time per batch (union of
kernel intervals), kernels per batch, and the top kernels by device time;
writes Chrome traces to ``DIR/trace_<posture>.json`` (default ``build/profile``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cvm_tpu_torch.data.synthetic import synthetic_yuv420_batch  # noqa: E402
from cvm_tpu_torch.infer import quantize as qz  # noqa: E402
from cvm_tpu_torch.infer.pipeline import InferencePipeline  # noqa: E402
from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch  # noqa: E402


def busy_ms(events) -> float:
    """Length of the union of the events' device intervals, in ms."""
    total, cur = 0.0, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if cur is None or s > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return (total + (0.0 if cur is None else cur[1] - cur[0])) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile", help="directory for the traces")
    out_dir = ap.parse_args().out
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(cs.nvidia_smi())
    cfg, model = cs.build_model(dev)
    planes = cs.batch_to(synthetic_yuv420_batch(np.random.default_rng(0), cs.B, cs.PAD_HW,
                                                num_classes=10), dev)
    scales = qz.calibrate_activation_scales(
        model, [preprocess_yuv420_batch(*planes, cfg.input_hw)[0]])
    pipes = {"fp": InferencePipeline(cfg, model, dev, fold_bn=True),
             "int8": InferencePipeline(cfg, model, dev, w8a8=scales, w8a8_fused=True,
                                       w8a8_chain=True)}
    os.makedirs(out_dir, exist_ok=True)
    n = 10
    for name, pipe in pipes.items():
        for _ in range(5):
            pipe.predict(*planes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                pipe.predict(*planes)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"== {name}: wall {wall:.3f} ms/batch under the profiler; device busy "
              f"{busy_ms(kernels) / n:.3f} ms/batch; {len(kernels) / n:.0f} kernels/batch")
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=24,
                                        max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
