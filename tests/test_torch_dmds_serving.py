"""DMDS (config E) on its serving path, on the CPU at a tiny size
(``backbone="tiny"``, 64x192 input, decoder 16, motion features 32, batch 8):
planar YUV420 frame pairs of several source sizes, odd ones among them,
through ``InferencePipeline(input_format="yuv420", fold_bn=True)``, and a
short batch of 3 that ``__call__`` pads to 8, against the benchmark's plain
float32 reference (``cvbench/reference/dmds.py``) on seeded weights, by the
benchmark cell's own readings (``cvbench/checks/dmds.py``: ``depth_log_gap``
and ``pose_gap``). Also the spans ``cvm.dmds.depth`` and ``cvm.dmds.motion``,
twice each inside ``cvm.infer.forward`` under a recording profiler and never
entered without one, and the pass counters, 2 + 2 a call. No JAX here: the
reference is the benchmark's.
"""

import json

import numpy as np
import pytest
import torch

from cvbench import program
from cvbench.checks import dmds as check
from cvbench.reference.lowprec import control_quant
from cvbench.traffic.pairs import pair_pool
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models.dmds.model import DmdsModel
from cvm_tpu_torch.utils import prof

CPU = torch.device("cpu")
CFG = {"model": "dmds",
       "program": {"params": "cvm_tpu_torch.models.dmds.params:DmdsParams",
                   "model": "cvm_tpu_torch.models.dmds.model:DmdsModel"},
       "params": {"input_hw": [64, 192], "batch_size": 8, "backbone": "tiny",
                  "decoder_features": 16, "num_scales": 1, "min_depth": 0.1, "max_depth": 80.0,
                  "motion_features": 32, "predict_object_motion": True},
       # as the cell does: the finest disp head scaled so that a frame's depth is
       # no near-flat map, the ego-motion head so that poses are of metres
       "weights": {"gain": {"depth.disp3.out.weight": 32.0, "motion.fc2.weight": 500.0},
                   "shift": {"depth.disp3.out.bias": -3.0}}}
# several source sizes, odd ones among them, in one buffer; zoom and shift as the cell's
MIX = {"pool": 8, "buffer_hw": [128, 384], "sizes": [[125, 380], [126, 379], [121, 370],
                                                     [96, 300], [127, 383]],
       "colors": 10, "max_objects": 12, "zoom": [1.0, 1.04], "focus": 0.1, "shift_px": 3.0}
KEYS = ("depth", "rotation", "translation")

# Tolerances, in the cell's units: each gap over the bfloat16 floor's, the
# same reference computed in bfloat16 against the float32 one (a pair at the
# floor reads about 1). At this size, on seeds 1-12, the program reads
# 1.35-2.92 in depth_log_gap and 1.31-4.11 in pose_gap; the reference
# computed in fp8 e4m3 reads 7.57-26.23 and 4.54-22.68. Each tolerance lies
# between: 1.7x from the program's largest and 1.5x from the control's least
# in depth; in pose 1.5x from the program's largest, which the control
# passes on seeds 3-5 (the motion net at width 32 averages its last
# features over 12 positions only, and its global mean is rounded to
# bfloat16), so the control is failed by depth there.
DEPTH_TOL = 5.0
POSE_TOL = 6.0


def _pairs(seed: int):
    return pair_pool(np.random.default_rng(seed), MIX)


def _batch(pairs):
    return {k: np.concatenate([p[k] for p in pairs]) for k in pairs[0]}


def _setup(seed: int):
    params, model, weights = program.build(CFG, seed, CPU)
    pipe = InferencePipeline(params, model, CPU, input_format="yuv420", fold_bn=True)
    return pipe, weights


def _served(out, n):
    return [{k: out[k][i:i + 1].numpy() for k in KEYS} for i in range(n)]


def _readings(served, pairs, weights, quant=None):
    rc = program.ref_cfg(CFG)
    refs = check.reference_outputs(pairs, weights, rc, CPU)
    floors = check.reference_outputs(pairs, weights, rc, CPU, check.Bf16Floor())
    if quant is not None:
        served = check.reference_outputs(pairs, weights, rc, CPU, quant)
    return check.readings(served, refs, floors)


@pytest.mark.parametrize("seed", [1, 2])
def test_a_batch_of_pairs_matches_the_reference(seed):
    pipe, weights = _setup(seed)
    pairs = _pairs(seed)
    out = pipe(_batch(pairs))
    assert {k: tuple(out[k].shape) for k in KEYS} == {
        "depth": (8, 64, 192, 1), "rotation": (8, 3), "translation": (8, 3)}
    assert all(out[k].dtype == torch.float32 for k in KEYS)
    got = _readings(_served(out, 8), pairs, weights)
    assert got["depth_log_gap"] <= DEPTH_TOL and got["pose_gap"] <= POSE_TOL, got


@pytest.mark.parametrize("seed", [1, 2])
def test_the_fp8_control_fails_a_tolerance(seed):
    _, weights = _setup(seed)
    got = _readings(None, _pairs(seed), weights, control_quant("fp8_e4m3"))
    assert got["depth_log_gap"] > DEPTH_TOL or got["pose_gap"] > POSE_TOL, got


def test_a_short_batch_is_padded_and_sliced():
    pipe, weights = _setup(3)
    pairs = _pairs(3)
    full = pipe(_batch(pairs))
    short = pipe(_batch(pairs[:3]))
    assert {k: tuple(short[k].shape[:1]) for k in KEYS} == dict.fromkeys(KEYS, (3,))
    for k in KEYS:   # the padding rows change nothing of the rows served
        assert torch.equal(short[k], full[k][:3]), k


def test_the_depth_is_no_flat_map():
    """The cell's premise at this size: the scaled disp head gives depth maps
    that span most of a decade, where the unscaled one gives a near-flat map."""
    pipe, _ = _setup(1)
    d = pipe(_batch(_pairs(1)))["depth"].reshape(8, -1)
    span = torch.log10(torch.quantile(d, 0.95, dim=1) / torch.quantile(d, 0.05, dim=1))
    assert float(span.median()) > 0.3, span


def test_each_call_counts_two_depth_and_two_motion_passes():
    pipe, _ = _setup(4)
    batch = _batch(_pairs(4))
    for _ in range(2):
        d0, m0 = DmdsModel.depth_passes, DmdsModel.motion_passes
        pipe(batch)
        assert (DmdsModel.depth_passes - d0, DmdsModel.motion_passes - m0) == (2, 2)
    assert (DmdsModel, "depth_passes") in prof.LAUNCH_COUNTERS
    assert (DmdsModel, "motion_passes") in prof.LAUNCH_COUNTERS


def _ranges(path):
    events = json.load(open(path))["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("cvm.")), key=lambda e: e["ts"])


def test_the_net_spans_open_inside_the_forward(tmp_path):
    pipe, _ = _setup(5)
    batch = _batch(_pairs(5))
    plain = pipe(batch)
    with prof.trace(str(tmp_path / "tr")):
        traced = pipe(batch)
    for k in KEYS:
        assert torch.equal(plain[k], traced[k]), k
    spans = _ranges(tmp_path / "tr" / "trace.json")
    names = [e["name"] for e in spans]
    assert names.count("cvm.dmds.depth") == 2 and names.count("cvm.dmds.motion") == 2
    assert names.count("cvm.infer.forward") == 1
    fwd = spans[names.index("cvm.infer.forward")]
    inner = [e for e in spans if e["name"].startswith("cvm.dmds.")]
    assert [e["name"] for e in inner] == ["cvm.dmds.depth"] * 2 + ["cvm.dmds.motion"] * 2
    for e in inner:
        assert fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= fwd["ts"] + fwd["dur"]


def test_no_net_span_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    pipe, _ = _setup(6)
    batch = _batch(_pairs(6))
    pipe(batch)
    assert entered == []
    with torch.profiler.profile():
        pipe(batch)
    assert entered.count("cvm.dmds.depth") == 2 and entered.count("cvm.dmds.motion") == 2
    assert entered.index("cvm.infer.forward") < entered.index("cvm.dmds.depth")
