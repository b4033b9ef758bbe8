"""The trace reduction and the per-layer readers on hand-built profiler
events (Chrome-trace dicts, times in µs)."""

import pytest

from cvbench import run
from cvbench.reference.kernels import PEAK_BYTES, PEAK_INT8_OPS, k2_bound_s
from cvbench.trace import STRETCH, reduce


def _x(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "args": args}


def events():
    return [
        _x(STRETCH + ".begin", "user_annotation", 1000.0, 1.0),
        _x("host_step", "cpu_op", 1000.0, 950.0),
        _x("cvm_tpu_torch::fused_qconv", "cpu_op", 1010.0, 20.0, **{
            "External id": 7, "Input Dims": [[8, 128, 128, 64], [3, 3, 64, 64], [64], [64], [], [], [], [], []],
            "Input type": ["c10::BFloat16", "signed char", "float", "float", "signed char", "Scalar", "", "ScalarType", ""],
            "Concrete Inputs": ["", "", "", "", "", "0.01", "silu", "1", ""]}),
        _x("aten::add", "cpu_op", 1100.0, 5.0, **{"External id": 8}),
        _x("k2_kernel", "kernel", 1020.0, 100.0, **{"External id": 7}),     # 1020-1120
        _x("add_kernel", "kernel", 1100.0, 50.0, **{"External id": 8}),     # 1100-1150 overlaps
        _x("Memcpy HtoD", "gpu_memcpy", 1500.0, 100.0),                     # 1500-1600
        _x("late_kernel", "kernel", 1990.0, 40.0),                          # clipped to 2000
        _x(STRETCH + ".end", "user_annotation", 2000.0, 1.0),
        _x("outside", "kernel", 2500.0, 10.0),
    ]


def test_busy_idle_and_gaps():
    tr = reduce(events())
    assert tr.window_s == pytest.approx(1000e-6)
    # union: 1020-1150, 1500-1600, 1990-2000 -> 130 + 100 + 10 µs
    assert tr.busy_s == pytest.approx(240e-6)
    assert tr.idle_pct == pytest.approx(76.0)
    assert tr.n_kernels == 3
    assert tr.device_ops[0] == ("k2_kernel", pytest.approx(100e-6))
    # gaps: 1150-1500 (350), 1600-1990 (390), 1000-1020 (20); labelled by the innermost host op
    assert [round(s * 1e6) for _, s in tr.idle_gaps] == [390, 350, 20]
    assert tr.idle_gaps[0][0] == "host:host_step"
    assert tr.idle_gaps[2][0] == "host:cvm_tpu_torch::fused_qconv"


def test_no_stretch_no_trace():
    assert reduce([e for e in events() if not e["name"].startswith(STRETCH)]) is None


def test_k2_roofline_from_shapes():
    tr = reduce(events())
    ctx = run.Context(trace=tr, counters={}, peak=None, card="x")
    got = run.metric_reader("k2_roofline_pct")(ctx)
    ops = 2.0 * 8 * 128 * 128 * 9 * 64 * 64
    nbytes = 8 * 128 * 128 * (64 * 2 + 64 * 1) + 9 * 64 * 64 + 8 * 64
    bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)
    assert bound == pytest.approx(k2_bound_s(8, 128, 128, 64, 64, 3, 2, 1))
    assert got == pytest.approx(100.0 * bound / 100e-6)


def test_readers_without_a_trace_read_nothing():
    ctx = run.Context(trace=None, counters={"frames": 0}, peak=989e12, card="x")
    for name in ("k2_roofline_pct", "idle_pct.serve", "kernels_per_image.infer", "mfu.infer"):
        assert run.metric_reader(name)(ctx) is None


def test_mfu_and_counters():
    ctx = run.Context(trace=None, counters={"frames": 100, "window_s": 2.0, "flops_per_frame": 1e12,
                                            "requests": 90, "batches": 15}, peak=1e15, card="x")
    assert run.metric_reader("mfu.serve")(ctx) == pytest.approx(5.0)
    assert run.metric_reader("rows_per_batch.serve")(ctx) == pytest.approx(6.0)
    ctx.counters["frames"] = 10 ** 6
    with pytest.raises(RuntimeError, match="impossible"):
        run.metric_reader("mfu.infer")(ctx)
