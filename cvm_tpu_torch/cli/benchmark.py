"""Benchmark harness for the BASELINE.json measurement configs A-E.

``python -m cvm_tpu_torch.cli.benchmark [--configs A,B,C,D,E] [--iters N]
[--train] [--device cuda] [--num_processes N]``

A: semseg 640x256 batch 1              C: depth KITTI-ish, batch 8
B: centernet COCO 512x512 batch 8      D: multitask NuScenes-ish, batch 8
E: dmds 192x640 batch 8, two frames; its training step is what is timed
   (the warping loss is the workload)

Mirrors ``cvm_tpu/cli/benchmark.py`` (``_bench_infer``,
``_bench_train_step``, ``_configs``, ``main``). Prints one JSON line per
config: images/s and p50 latency of the end-to-end inference pipeline
(preprocess + forward + postprocess), or, with ``--train``, steps/s of the
training step; each line names the device and its power limit.

The training leg runs over every visible card, as the reference's
``Trainer(spec, cfg)`` runs over every chip: with more than one card (or
``--num_processes N``) this process launches one rank per card
(``parallel/mesh.py::launch_local``), the config's batch is the global
batch split over them, and rank 0 prints each line with ``processes`` (N)
and the rates of its card (``achieved_tflops``, ``mfu_pct``: this rank's
FLOPs). The serving leg stays on one card, rank 0's, as the reference's
does; one card gives one process and the lines it always gave.

Timing keeps the reference's honesty rules: distinct host buffers
(``max(8, warmup + 1)`` of them), a pipelined clock over ``iters`` calls
closed by ``torch.cuda.synchronize()`` and a one-element readback, and a
blocked clock (p50) that waits for each call. The training bench runs 500
pipelined steps where the card's peak is known, plus a blocked clock that
reads the loss every step. FLOPs are counted once on the fp model with
``torch.utils.flop_counter.FlopCounterMode`` (XLA's cost analysis has no
counterpart here); a rate above the card's bf16 peak is refused as an
impossible measurement. An unknown card (or the CPU) reports no MFU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Dense bf16 tensor-core peaks (TFLOP/s, without sparsity) from NVIDIA's
# H100 data sheet, matched on ``torch.cuda.get_device_name()``, most
# specific first. Unknown cards report no MFU and skip the guard.
_CARD_PEAK_TFLOPS = (
    ("H100 NVL", 835.0),
    ("H100 PCIe", 756.0),
    ("H100", 989.0),  # SXM5, e.g. "NVIDIA H100 80GB HBM3"
)


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _device_peak_tflops(device):
    name = _device_name(device)
    for sub, peak in _CARD_PEAK_TFLOPS:
        if device.type == "cuda" and sub in name:
            return peak, name
    return None, name


def _power_limit_w(device):
    """The card's power limit in watts (``nvidia-smi``), or None."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _count_flops(fn) -> float:
    """FLOPs of one ``fn()`` as ``FlopCounterMode`` counts them (convs and
    matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _rate_fields(res, flops, seconds, peak, what):
    """achieved_tflops and mfu_pct; raises on a rate above the peak."""
    if flops <= 0:
        return
    achieved = flops / seconds / 1e12
    res["achieved_tflops"] = round(achieved, 2)
    if peak is not None:
        res["mfu_pct"] = round(100.0 * achieved / peak, 1)
        if achieved > peak:
            raise RuntimeError(f"IMPOSSIBLE measurement for {what}: {achieved:.0f} TFLOP/s "
                               f"> {peak:.0f} peak — refusing")


def _pad_hw(cfg):
    return (int(cfg.input_hw[0] * 1.5) // 2 * 2, int(cfg.input_hw[1] * 1.5) // 2 * 2)


def _bench_infer(spec_name, cfg, device, iters=20, warmup=3):
    import torch

    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.registry import build_model, get_model

    model = build_model(get_model(spec_name), cfg, device)
    pipe = InferencePipeline(cfg, model, device, input_format="rgb")
    rng = np.random.default_rng(0)
    n_buf = max(8, warmup + 1)
    batches = [synthetic_batch(rng, cfg.batch_size, _pad_hw(cfg), num_classes=5,
                               two_frame=spec_name == "dmds")
               for _ in range(n_buf)]

    def readback(out):
        return float(next(iter(out.values())).reshape(-1)[0])

    for b in batches:
        readback(pipe(b))
    # counted on the eager step: a CUDA graph's replay dispatches no op
    data = [torch.from_numpy(batches[0][k]).to(device) for k in pipe.keys]
    with torch.no_grad():
        flops = _count_flops(lambda: pipe.run(*data))

    t0 = time.perf_counter()
    outs = [pipe(batches[i % n_buf]) for i in range(iters)]
    _sync(device)
    readback(outs[-1])
    t_pipe = (time.perf_counter() - t0) / iters

    lat = []
    for i in range(max(iters // 3, 3)):
        t0 = time.perf_counter()
        out = pipe(batches[i % n_buf])
        _sync(device)
        readback(out)
        lat.append(time.perf_counter() - t0)

    res = {"images_per_sec": round(cfg.batch_size / t_pipe, 2),
           "p50_latency_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
           "batch_size": cfg.batch_size}
    peak, _ = _device_peak_tflops(device)
    _rate_fields(res, flops, t_pipe, peak, spec_name)
    return res


def _bench_train_step(spec_name, cfg, device, iters=10, warmup=2, mesh=None):
    """Training throughput on two clocks: blocked (the loss read on the
    host every step) and pipelined (no host read until the end of a long
    window; each step's update feeds the next, so the final read cannot
    finish before every step ran). Under ``mesh`` each rank steps on its
    rows of the global batch."""
    from cvm_tpu_torch.data.loader import prefetch_to_device
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.train.loop import Trainer, step_generator

    trainer = Trainer(cfg, device, mesh=mesh)
    trainer.init_state()
    nc = min(getattr(cfg, "num_classes", getattr(cfg, "num_det_classes", 3)), 10)
    batch = synthetic_batch(np.random.default_rng(0), cfg.batch_size, _pad_hw(cfg),
                            num_classes=nc, two_frame=spec_name == "dmds")
    if trainer.mesh.data > 1:
        rows = trainer.mesh.batch_rows(cfg.batch_size)
        batch = {k: v[rows.start:rows.stop] for k, v in batch.items()}
    b = next(prefetch_to_device([batch], trainer.device))
    peak, kind = _device_peak_tflops(trainer.device)
    step = [0]

    def one_step():
        gen = step_generator(trainer.device, 0, step[0])
        step[0] += 1
        trainer.state, m = trainer.train_step(trainer.state, b, gen)
        return m

    for _ in range(warmup):
        one_step()
    flops_per_step = _count_flops(one_step)
    _sync(trainer.device)

    lat = []
    for _ in range(max(iters, 10)):
        t0 = time.perf_counter()
        loss = float(one_step()["loss"])  # host read: the sync point
        lat.append(time.perf_counter() - t0)
    dt_blocked = float(np.percentile(lat, 50))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    n_pipe = 500 if peak is not None else max(iters, 10)
    t0 = time.perf_counter()
    for _ in range(n_pipe):
        m = one_step()
    _sync(trainer.device)
    final_loss = float(m["loss"])
    dt_pipe = (time.perf_counter() - t0) / n_pipe
    if not np.isfinite(final_loss):
        raise RuntimeError(f"non-finite loss {final_loss}")

    res = {"steps_per_sec": round(1.0 / dt_pipe, 2),
           "images_per_sec": round(cfg.batch_size / dt_pipe, 2),
           "steps_per_sec_blocked": round(1.0 / dt_blocked, 2),
           "p50_step_ms_blocked": round(dt_blocked * 1e3, 3),
           "pipelined_steps": n_pipe, "batch_size": cfg.batch_size, "device_kind": kind}
    if trainer.mesh.world > 1:
        res["processes"] = trainer.mesh.world
    if flops_per_step > 0:
        res["tflops_per_step"] = round(flops_per_step / 1e12, 4)
    _rate_fields(res, flops_per_step, dt_pipe, peak, f"{spec_name} training")
    return res


def _configs():
    from cvm_tpu_torch.models.registry import get_model

    return {
        # BASELINE.json:7 — semseg 640x256 single image
        "A": ("semseg", get_model("semseg").params_cls(batch_size=1), "infer"),
        # BASELINE.json:8 — CenterNet COCO 512x512 batch 8 (headline)
        "B": ("centernet", get_model("centernet").params_cls(), "infer"),
        # BASELINE.json:9 — dense depth with multi-scale upsampling
        "C": ("depth", get_model("depth").params_cls(), "infer"),
        # BASELINE.json:10 — multitask shared backbone
        "D": ("multitask", get_model("multitask").params_cls(), "infer"),
        # BASELINE.json:11 — two-frame DMDS with pose + warping loss
        "E": ("dmds", get_model("dmds").params_cls(), "train"),
    }


def main(argv=None):
    from cvm_tpu_torch.parallel.mesh import (add_process_args, launch_local, process_count,
                                             process_mesh)

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--configs", default="A,B,C,D,E")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--train", action="store_true",
                        help="benchmark the training step instead of inference")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="override the config's batch size")
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    add_process_args(parser)
    args = parser.parse_args(argv)

    cfgs = _configs()
    runs = []
    for key in args.configs.split(","):
        key = key.strip().upper()
        if key not in cfgs:
            parser.error(f"unknown config {key!r}; choose from {sorted(cfgs)}")
        spec_name, cfg, mode = cfgs[key]
        if args.batch_size:
            cfg = cfg.replace(batch_size=args.batch_size)
        runs.append((key, spec_name, cfg, "train" if args.train else mode))
    # the serving leg runs on one card: over several only for a training leg
    training = any(mode == "train" for *_, mode in runs)
    world = process_count(parser, args) if training or args.coordinator else 1
    rc = launch_local(args, world, "cvm_tpu_torch.cli.benchmark", argv)
    if rc is not None:
        return rc
    from cvm_tpu_torch.utils.device import resolve_device

    with process_mesh(args, args.device) as (device, mesh):
        device = resolve_device(device)
        for key, spec_name, cfg, mode in runs:
            if mode == "train":
                res = _bench_train_step(spec_name, cfg, device, iters=max(args.iters // 2, 5),
                                        mesh=mesh)
            elif mesh is None:
                res = _bench_infer(spec_name, cfg, device, iters=args.iters)
            else:  # rank 0's card serves; the other ranks wait for it
                res = mesh.from_rank0(f"infer {key}", lambda: _bench_infer(
                    spec_name, cfg, device, iters=args.iters))
            if mesh is None or mesh.is_rank0:
                res.update({"config": key, "model": spec_name, "mode": mode,
                            "input_hw": list(cfg.input_hw), "device": _device_name(device),
                            "power_limit_w": _power_limit_w(device)})
                print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
