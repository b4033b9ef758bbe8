#!/usr/bin/env python3
"""Smoke test of cvm_tpu_torch on one CUDA card (an NVIDIA H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
hand-written kernel from ``cvm_tpu_torch/csrc`` and drives the port's
serving slice, CenterNet config B (512x512, ``small`` backbone with the
space-to-depth stem, stride 4, 80 classes, batch 8, planar YUV420 padded to
768x768), with random seeded weights:

  1. card, versions, kernel build;
  2. kernel vs its plain PyTorch version at every config-B shape of the
     fused W8A8 ConvBN and at the reference tests' shapes, in four modes,
     with kernel and plain times (CUDA events, median);
  3. the model at full width with non-trivial BN statistics, calibrated on
     3 synthetic batches; the fp (BN folded) and int8 (fused + chained)
     pipelines;
  4. one batch-8 request through each posture: finite results, exactly 24
     kernel launches (7 with int8 output) per int8 forward, int8 heads near
     fp heads, and the int8 posture through the kernel vs through the plain
     version on the card;
  5. a DynamicBatcher over the int8 pipeline answering 16 threaded requests;
  6. median batch-8 latency of both postures.

Any failure raises (exit code != 0). The last two lines are the kernels'
JSON record and ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits 1 before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

B = 8
PAD_HW = (768, 768)
KERNEL_SOURCE = "cvm_tpu_torch/csrc/fused_qconv.cu"
KERNEL_REPLACES = "cvm_tpu/ops/pallas/fused_qconv.py:150"

# The 24 fused_qconv calls of one config-B int8 forward (B = 8, all 3x3):
# (name, H, W, Cin, Cout, input, output, act, calls per forward).
MAIN_CALLS = [
    ("stem", 256, 256, 12, 32, "bf16", "bf16", "silu", 1),
    ("s2 c1", 128, 128, 64, 64, "bf16", "int8", "silu", 1),
    ("s2 c2", 128, 128, 64, 64, "int8", "bf16", None, 1),
    ("s3 c1", 64, 64, 128, 128, "bf16", "int8", "silu", 2),
    ("s3 c2", 64, 64, 128, 128, "int8", "bf16", None, 2),
    ("s4 c1", 32, 32, 256, 256, "bf16", "int8", "silu", 2),
    ("s4 c2", 32, 32, 256, 256, "int8", "bf16", None, 2),
    ("s5 c1", 16, 16, 512, 512, "bf16", "int8", "silu", 2),
    ("s5 c2", 16, 16, 512, 512, "int8", "bf16", None, 2),
    ("up0 c1", 32, 32, 768, 128, "bf16", "bf16", "silu", 1),
    ("up0 c2", 32, 32, 128, 128, "bf16", "bf16", "silu", 1),
    ("up1 c1", 64, 64, 256, 128, "bf16", "bf16", "silu", 1),
    ("up1 c2", 64, 64, 128, 128, "bf16", "bf16", "silu", 1),
    ("up2 c1", 128, 128, 192, 128, "bf16", "bf16", "silu", 1),
    ("up2 c2", 128, 128, 128, 128, "bf16", "bf16", "silu", 1),
    ("head c1", 128, 128, 128, 64, "bf16", "bf16", "silu", 3),
]
# (k, B, H, W, Cin, Cout, act) of tests/test_fused_qconv.py: 1x1, W not a
# multiple of the tile, Cout > 128, narrow Cin with wide W, W = 1.
TEST_SHAPES = [
    (1, 2, 8, 16, 32, 64, "silu"),
    (3, 2, 16, 20, 32, 64, "silu"),
    (3, 1, 32, 48, 16, 256, None),
    (3, 1, 8, 96, 8, 32, "relu"),
    (3, 2, 2, 1, 16, 32, "relu"),
]
# mode -> (input, output)
MODES = {"f32->f32": ("f32", "f32"), "bf16->bf16": ("bf16", "bf16"),
         "int8->bf16": ("int8", "bf16"), "bf16->int8": ("bf16", "int8")}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of ``fn()`` ending in a device synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare(got, ref):
    """(ok, max abs error, note). Tolerances by output type: f32 1e-4
    (the kernel's int32 sums are exact; cuDNN's f32 conv in the plain version
    may round them, e.g. with Winograd, at ~1e-6 relative); bf16 one bf16
    step (2^-7 relative); int8 one lattice step on at most 0.1% of outputs."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False, float("inf"), f"dtype/shape {got.dtype}{tuple(got.shape)} vs {ref.dtype}{tuple(ref.shape)}"
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs()
        frac = float((d > 0).float().mean())
        return int(d.max()) <= 1 and frac <= 1e-3, float(d.max()), f"lattice diff frac {frac:.2e}"
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    if got.dtype == torch.bfloat16:
        ok = bool(((g - r).abs() <= 2 ** -7 * r.abs() + 1e-5).all())
    else:
        ok = bool(((g - r).abs() <= 1e-4 * r.abs() + 1e-4).all())
    return ok, err, ""


def kernel_case(dev, gen, k, b, h, w, cin, cout, act, x_kind, out_kind):
    """Inputs for one fused_qconv call whose output is O(1)."""
    import torch

    if x_kind == "int8":
        x = torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=dev, dtype=torch.int8)
        inv_sx = None
    else:
        x = torch.randn(b, h, w, cin, generator=gen, device=dev)
        x = x.to(torch.bfloat16) if x_kind == "bf16" else x
        inv_sx = 127.0 / 3.0
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device=dev, dtype=torch.int8)
    acc_std = (k * k * cin) ** 0.5 * 42.0 * 73.0
    scale = torch.rand(cout, generator=gen, device=dev) / acc_std + 0.5 / acc_std
    bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
    out_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[out_kind]
    kw = dict(inv_sx=inv_sx, act=act, out_dtype=out_dtype,
              inv_s_out=127.0 / 4.0 if out_kind == "int8" else None)
    return (x, wq, scale, bias), kw


def phase_kernels(dev):
    import torch

    from cvm_tpu_torch.ops.cuda.fused_qconv import fused_qconv, fused_qconv_reference

    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = []
    for name, h, w, cin, cout, _, _, act, _ in MAIN_CALLS:
        key = (3, B, h, w, cin, cout)
        if key not in [s[1:7] for s in shapes]:
            shapes.append((name.split()[0], *key, act))
    shapes += [(f"test{i}", *s) for i, s in enumerate(TEST_SHAPES)]
    log("[kernel] tolerance vs plain: f32 out |d| <= 1e-4*|ref| + 1e-4; bf16 out "
        "|d| <= 2^-7*|ref| + 1e-5; int8 out |d| <= 1 lattice step on <= 0.1% of outputs")
    worst, failures = 0.0, []
    for name, k, b, h, w, cin, cout, act in shapes:
        notes = []
        for mode, (xk, ok_) in MODES.items():
            args, kw = kernel_case(dev, gen, k, b, h, w, cin, cout, act, xk, ok_)
            got = fused_qconv(*args, **kw)
            torch.cuda.synchronize()
            ok, err, note = compare(got, fused_qconv_reference(*args, **kw))
            if ok_ != "int8":
                worst = max(worst, err)
            notes.append(f"{mode} {'ok' if ok else 'FAIL'} err={err:.3g}{' ' + note if note else ''}")
            if not ok:
                failures.append(f"{name} {mode}: {err} {note}")
        log(f"[kernel] {name:7s} k{k} B{b} {h}x{w} {cin}->{cout} act={act}: " + "; ".join(notes))
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")

    # Times at the main path's shapes and modes, kernel beside plain.
    ms = plain_ms = 0.0
    for name, h, w, cin, cout, xk, ok_, act, n in MAIN_CALLS:
        args, kw = kernel_case(dev, gen, 3, B, h, w, cin, cout, act, xk, ok_)
        t_k = cuda_ms(lambda: fused_qconv(*args, **kw))
        t_p = cuda_ms(lambda: fused_qconv_reference(*args, **kw))
        gmac = B * h * w * 9 * cin * cout / 1e9
        log(f"[kernel-time] {name:8s} {h}x{w} {cin}->{cout} {xk}->{ok_} x{n}: kernel "
            f"{t_k:.4f} ms ({2 * gmac / t_k:.1f} TOP/s), plain {t_p:.4f} ms")
        ms += n * t_k
        plain_ms += n * t_p
    log(f"[kernel-time] one config-B int8 forward's 24 calls: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return worst, ms, plain_ms


def build_model(dev):
    """Config B with seeded weights and non-trivial BN statistics."""
    import torch

    from cvm_tpu_torch.models.centernet.model import create_model
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.models.layers import BatchNorm

    cfg = CenternetParams()
    gen = torch.Generator().manual_seed(0)
    model = create_model(cfg, "cpu", gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return cfg, model.to(dev).eval()


def batch_to(batch, dev):
    import torch

    return [torch.from_numpy(batch[k]).to(dev) for k in ("y", "u", "v", "image_hw")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this test needs the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[card] {smi}")
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")

    # Phase 1: build the kernel from the checkout's sources.
    from cvm_tpu_torch.ops.cuda import _build
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    _build.load_library("fused_qconv")
    log(f"[build] fused_qconv built in {_build.BUILD_SECONDS['fused_qconv']:.1f} s "
        f"into {_build.BUILD_DIR}")

    # Phase 2: kernel vs plain.
    max_err, k_ms, plain_ms = phase_kernels(dev)

    # Phase 3: model, calibration, both pipelines.
    from cvm_tpu_torch.data.synthetic import synthetic_yuv420_batch
    from cvm_tpu_torch.entry import entry
    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.infer.server import DynamicBatcher
    from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch

    cfg, model = build_model(dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cal = []
    for _ in range(3):
        planes = batch_to(synthetic_yuv420_batch(rng, B, PAD_HW, num_classes=10), dev)
        cal.append(preprocess_yuv420_batch(*planes, cfg.input_hw)[0])
    scales = qz.calibrate_activation_scales(model, cal)
    log(f"[calibrate] {len(scales)} conv scales from 3 batches in "
        f"{time.perf_counter() - t0:.1f} s")
    pipe_fp = InferencePipeline(cfg, model, dev, fold_bn=True)
    pipe_q = InferencePipeline(cfg, model, dev, w8a8=scales, w8a8_fused=True, w8a8_chain=True)
    log(f"[pipelines] fp: BN folded; int8: {pipe_q.fused_counts}")
    if pipe_q.fused_counts != {"convbn": 10, "resblock": 7, "calls": 24}:
        raise AssertionError(f"unexpected fused coverage {pipe_q.fused_counts}")

    # Phase 4: serve one batch-8 request through each posture.
    batch = synthetic_yuv420_batch(np.random.default_rng(1), B, PAD_HW, num_classes=10)
    out_fp = pipe_fp(batch)
    fq.reset_counts()
    out_q = pipe_q(batch)                      # the main path, int8 posture
    torch.cuda.synchronize()
    launches, int8_launches = fq.fused_qconv.launches, fq.fused_qconv.int8_out_launches
    log(f"[serve] int8 forward: {launches} kernel launches, {int8_launches} with int8 output")
    if (launches, int8_launches) != (24, 7):
        raise AssertionError(f"expected 24 launches (7 int8-out), got {launches} ({int8_launches})")
    for name, out in (("fp", out_fp), ("int8", out_q)):
        if out["boxes"].shape != (B, cfg.top_k, 4) or out["scores"].shape != (B, cfg.top_k):
            raise AssertionError(f"{name}: bad shapes {out['boxes'].shape} {out['scores'].shape}")
        if not (torch.isfinite(out["boxes"]).all() and torch.isfinite(out["scores"]).all()):
            raise AssertionError(f"{name}: non-finite boxes or scores")

    planes = batch_to(batch, dev)
    proc, _ = preprocess_yuv420_batch(*planes, cfg.input_hw, out_dtype=torch.bfloat16)
    with torch.no_grad():
        heads_fp = pipe_fp.model(proc)
        heads_q = pipe_q.model(proc)
        real = qz.fused_qconv
        qz.fused_qconv = fq.fused_qconv_reference  # the same posture, plain version
        try:
            heads_plain = pipe_q.model(proc)
        finally:
            qz.fused_qconv = real
    p_fp, p_q, p_plain = (torch.sigmoid(h["heatmap"]) for h in (heads_fp, heads_q, heads_plain))
    d_fp = float((p_q - p_fp).abs().mean())
    d_plain = float((p_q - p_plain).abs().mean())
    d_plain_max = max(float((heads_q[k] - heads_plain[k]).abs().max()) for k in heads_q)
    log(f"[serve] mean |sigmoid(hm_int8) - sigmoid(hm_fp)| = {d_fp:.3e} (bound 5e-2); "
        f"int8 kernel vs int8 plain: mean |d sigmoid(hm)| = {d_plain:.3e} (bound 1e-3), "
        f"max |d head| = {d_plain_max:.3e}")
    if not d_fp < 5e-2:
        raise AssertionError(f"int8 heads too far from fp: {d_fp}")
    if not d_plain < 1e-3:
        raise AssertionError(f"int8 kernel posture disagrees with its plain version: {d_plain}")
    fn, args = entry(dev)
    boxes, scores, classes = fn(*args)
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("entry(): non-finite results")
    log(f"[entry] config-B fp program: boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}")

    # Phase 5: a DynamicBatcher (batch 8) over the int8 pipeline.
    keys = ("y", "u", "v", "image_hw")
    reqs = synthetic_yuv420_batch(np.random.default_rng(2), 2 * B, PAD_HW, num_classes=10)
    direct = [pipe_q({k: reqs[k][i:i + B] for k in keys}) for i in (0, B)]
    direct_scores = torch.cat([d["scores"] for d in direct]).cpu().numpy()
    fq.reset_counts()
    batcher = DynamicBatcher(lambda *a: pipe_q(dict(zip(keys, a))), batch_size=B,
                             max_wait_ms=200)
    results, errors = [None] * (2 * B), []

    def client(i):
        try:
            results[i] = batcher.submit([reqs[k][i:i + 1] for k in keys])
        except Exception as e:  # collected and raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2 * B)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        batcher.close()
    if errors or any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"batcher: unanswered requests or errors {errors}")
    for i, r in enumerate(results):
        if r["scores"].shape != (1, cfg.top_k) or not np.allclose(r["scores"][0],
                                                                  direct_scores[i], atol=1e-4):
            raise AssertionError(f"batcher: request {i} result differs from its direct run")
    st = batcher.stats()
    log(f"[server] 16 threaded requests answered: {st['batches']} batches, fill "
        f"{st['batch_fill']}, {fq.fused_qconv.launches} kernel launches")

    # Phase 6: median batch-8 latency, inputs resident on the card.
    lat_fp = host_ms(lambda: pipe_fp.predict(*planes))
    lat_q = host_ms(lambda: pipe_q.predict(*planes))
    log(f"[latency] batch-8 predict (preprocess+forward+decode), median of 20 on {smi}: "
        f"fp (BN folded) {lat_fp:.3f} ms, int8 (fused, chained) {lat_q:.3f} ms")

    log(f"[card] {nvidia_smi()}")
    print(json.dumps({"kernels": [{
        "name": "fused_qconv", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
