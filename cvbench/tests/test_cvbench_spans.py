"""``cvbench/spans.py`` on hand-built profiler events (Chrome-trace dicts,
times in µs): the program's ``cvm.`` ranges over ``test_cvbench_trace``'s
stretch."""

import pytest

from cvbench import spans
from cvbench.trace import reduce
from test_cvbench_trace import _x, events


def program_ranges():
    """The program's spans over ``events()``, with a device-side twin,
    which neither reduction reads."""
    return [
        _x("cvm.infer.call", "user_annotation", 900.0, 50.0, **{"External id": 100}),  # before
        _x("cvm.infer.call", "user_annotation", 1005.0, 900.0, **{"External id": 101}),
        _x("cvm.infer.preprocess", "user_annotation", 1008.0, 32.0, **{"External id": 102}),
        _x("cvm.infer.forward", "user_annotation", 1050.0, 400.0, **{"External id": 103}),
        _x("cvm.test.inner", "user_annotation", 1090.0, 110.0, **{"External id": 104}),
        _x("cvm.infer.h2d", "user_annotation", 1480.0, 140.0, **{"External id": 105}),
        _x("cvm.infer.postprocess", "user_annotation", 1700.0, 100.0, **{"External id": 106}),
        _x("cvm.infer.call", "user_annotation", 1970.0, 80.0, **{"External id": 107}),  # clipped
        _x("cvm.infer.call", "user_annotation", 2100.0, 50.0, **{"External id": 108}),  # after
        _x("cvm.infer.forward", "gpu_user_annotation", 1050.0, 400.0),
    ]


def spanned():
    """``events()`` with the program's spans, a kernel launched inside the
    forward and the frame copy launched inside ``cvm.infer.h2d``."""
    evs = [dict(e, args=dict(e["args"], **{"External id": 9})) if e["name"] == "Memcpy HtoD"
           else e for e in events()]
    return evs + program_ranges() + [
        _x("aten::mul", "cpu_op", 1300.0, 5.0, **{"External id": 10}),
        _x("mul_kernel", "kernel", 1310.0, 20.0, **{"External id": 10}),       # 1310-1330
        _x("aten::copy_", "cpu_op", 1495.0, 110.0, **{"External id": 9}),
    ]


def test_program_ranges_leave_the_trace_reduction_unchanged():
    plain, tr = reduce(events()), reduce(events() + program_ranges())
    for field in ("window_s", "busy_s", "n_kernels", "device_ops", "ops", "kernels"):
        assert getattr(tr, field) == getattr(plain, field), field


def test_spans_sum_host_device_and_idle_time():
    sp = spans.reduce_spans(spanned())
    # busy: 1020-1150, 1310-1330, 1500-1600, 1990-2000; each launch to its
    # innermost range: k2 (op at 1010) to preprocess, add (op at 1100) to
    # the inner range two spans deep, mul (1300) to forward, the copy (1495)
    # to h2d; late_kernel has no launching op
    want = {  # n, host µs, kernels, device µs, idle µs
        "cvm.infer.call": (2, 900 + 30, 0, 0, (900 - 130 - 20 - 100) + (30 - 10)),
        "cvm.infer.preprocess": (1, 32, 1, 100, 32 - 20),
        "cvm.infer.forward": (1, 400, 1, 20, 400 - 100 - 20),
        "cvm.test.inner": (1, 110, 1, 50, 110 - 60),
        "cvm.infer.h2d": (1, 140, 0, 100, 140 - 100),
        "cvm.infer.postprocess": (1, 100, 0, 0, 100),
    }
    assert set(sp) == set(want)
    for name, (n, host, k, dev, idle) in want.items():
        got = sp[name]
        assert (got.n, got.kernels) == (n, k), name
        assert got.host_s == pytest.approx(host * 1e-6), name
        assert got.device_s == pytest.approx(dev * 1e-6), name
        assert got.idle_s == pytest.approx(idle * 1e-6), name


def test_no_stretch_or_no_ranges():
    assert spans.reduce_spans([e for e in spanned() if not e["name"].startswith("cvbench.")]) \
        is None
    assert spans.reduce_spans(events()) == {}
    assert spans.frame_split({}, 1e-3, 2) is None


def test_frame_split_and_summary():
    ev = spanned()
    split = spans.frame_split(spans.reduce_spans(ev), 1000e-6, 2)
    assert split == pytest.approx({
        "cvm.infer.h2d": 0.140 / 2, "cvm.infer.preprocess": 0.032 / 2,
        "cvm.infer.forward": 0.400 / 2, "cvm.infer.postprocess": 0.100 / 2,
        "call_self": (0.930 - 0.140 - 0.032 - 0.400 - 0.100) / 2,
        "outside_call": 1.000 / 2 - 0.930 / 2})
    s = spans.summary(ev, {"frames_in_stretch": 2})
    assert s["calls"] == 2 and s["stages_within_call"]
    # k2, add, mul in spans; late_kernel launched by no op
    assert s["kernels"] == {"in_spans": 3, "outside": 1, "n_kernels": 4}


def test_launch_leads_show_a_device_clock_ahead_of_the_host():
    ev = spanned() + [
        _x("cudaLaunchKernel", "cuda_runtime", 1012.0, 3.0, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1302.0, 3.0, correlation=2),
    ]
    for e in ev:
        if e["name"] == "k2_kernel":
            e["args"]["correlation"] = 1
        if e["name"] == "mul_kernel":
            e["args"]["correlation"] = 2
            e["ts"] = 1290.0                        # 10 µs before its op, 12 before its launch
    leads = spans.launch_leads(ev)
    # k2 (op 1010, launch 1012, start 1020), add (op 1100, start 1100), mul
    assert sorted(leads["op"]) == [-10.0, 0.0, 10.0]
    assert sorted(leads["runtime"]) == [-12.0, 8.0]
