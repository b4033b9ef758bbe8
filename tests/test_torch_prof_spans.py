"""The program's spans (``utils/prof.py::span``) on the CPU: one batch-1
frame through a tiny semseg and a tiny CenterNet ``InferencePipeline``
(yuv420, BN folded) under ``utils.prof.trace`` shows each of the five
``cvm.infer.*`` ranges once, the four stages inside ``cvm.infer.call`` in
order, and CenterNet's ``cvm.infer.decode`` inside the postprocess; the
outputs are bit-equal with and without the profiler; without one
``record_function`` is never entered; ``StepTimer.section`` opens its
span; and ``torch.export`` of ``run`` records the same graph inside a
running profiler as outside it, with no profiler op in it.
"""

import json

import numpy as np
import pytest
import torch

from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.registry import build_model
from cvm_tpu_torch.utils import prof

CALL = "cvm.infer.call"
STAGES = ("cvm.infer.h2d", "cvm.infer.preprocess", "cvm.infer.forward", "cvm.infer.postprocess")
DECODE = "cvm.infer.decode"
TINY = {"semseg": dict(input_hw=(32, 32), backbone="tiny", decoder_features=8, num_classes=3,
                       batch_size=1),
        "centernet": dict(input_hw=(32, 32), backbone="tiny", neck_features=16, head_features=8,
                          num_classes=3, top_k=10, batch_size=1)}


def _pipeline(name):
    spec = get_model(name)
    cfg = spec.params_cls(**TINY[name])
    model = build_model(spec, cfg, "cpu", torch.Generator().manual_seed(3))
    return InferencePipeline(cfg, model, "cpu", input_format="yuv420", fold_bn=True)


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    return {"y": rng.integers(0, 256, (1, 48, 48), dtype=np.uint8),
            "u": rng.integers(0, 256, (1, 24, 24), dtype=np.uint8),
            "v": rng.integers(0, 256, (1, 24, 24), dtype=np.uint8),
            "image_hw": np.array([[40, 46]], np.int32)}


def _ranges(path):
    """The trace's ``cvm.`` host ranges, in start order."""
    events = json.load(open(path))["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("cvm.")), key=lambda e: e["ts"])


@pytest.mark.parametrize("name", ["semseg", "centernet"])
def test_one_frame_shows_each_span_once_in_order(name, tmp_path):
    pipe, frame = _pipeline(name), _frame()
    plain = pipe(frame)
    with prof.trace(str(tmp_path / "tr")):
        traced = pipe(frame)
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    spans = _ranges(tmp_path / "tr" / "trace.json")
    decode = [DECODE] if name == "centernet" else []
    assert [e["name"] for e in spans] == [CALL, *STAGES, *decode]
    call, stages = spans[0], spans[1:len(STAGES) + 1]
    for e in spans[1:]:
        assert call["ts"] <= e["ts"] and e["ts"] + e["dur"] <= call["ts"] + call["dur"]
    for a, b in zip(stages, stages[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    if decode:  # the decode and box mapping, inside the postprocess
        post, dec = stages[-1], spans[-1]
        assert post["ts"] <= dec["ts"] and dec["ts"] + dec["dur"] <= post["ts"] + post["dur"]


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    pipe, frame = _pipeline("semseg"), _frame(1)
    pipe(frame)
    timer = prof.StepTimer()
    with timer.section("step"):
        pass
    assert entered == [] and timer.counts == {"step": 1}
    with torch.profiler.profile():
        pipe(frame)
    assert entered == [CALL, *STAGES]


def test_step_timer_section_is_a_span(tmp_path):
    timer = prof.StepTimer()
    with prof.trace(str(tmp_path / "tr")):
        with timer.section("cvm.test.section"):
            torch.ones(4).add_(1)
    assert [e["name"] for e in _ranges(tmp_path / "tr" / "trace.json")] == ["cvm.test.section"]
    assert timer.counts == {"cvm.test.section": 1}


@pytest.mark.parametrize("strict", [False, True])
def test_export_of_run_holds_no_profiler_op(strict):
    pipe = _pipeline("semseg")

    class Run(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = pipe.model  # registered: strict tracing lifts its weights

        def forward(self, y, u, v, image_hw):
            return pipe.run(y, u, v, image_hw)

    args = tuple(torch.from_numpy(a) for a in _frame(2).values())
    with torch.no_grad():
        outside = torch.export.export(Run(), args, strict=strict)
        with torch.profiler.profile():
            inside = torch.export.export(Run(), args, strict=strict)
    assert str(inside.graph) == str(outside.graph)
    targets = [str(n.target) for n in inside.graph.nodes if n.op == "call_function"]
    assert targets and not any("profiler" in t or "record_function" in t for t in targets)
