"""``infer/graphs.py``'s signature logic on the CPU, with a stand-in for
the CUDA capture (``graphs.capture``) that records by running the step and
replays by running it again into the same output tensors, as a graph
rewrites its outputs: the first call of a signature runs eagerly and the
second captures; ``MAX_GRAPHS`` caps the signatures with a graph; a CPU or
mesh pipeline never captures; ``graph_counts`` by reason; no returned
output is a graph's own buffer; a replay adds its capture's launch
counts, and the kernel wrappers register their counters; and through a
tiny ``InferencePipeline`` the replayed results equal ``run``'s, the numpy
inputs go straight into the graph's input buffers, a replayed call shows
``cvm.infer.replay`` in place of the three stages, ``predict`` on
device tensors opens no copy span, and ``cli.benchmark`` counts the FLOPs
of a pipeline whose step replays.
The card's own graphs: ``tests/test_torch_graphs_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from cvm_tpu_torch.infer import graphs
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.registry import build_model
from cvm_tpu_torch.utils import prof

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


class Recorder:
    """The stand-in capture: how often it captured, and each replay."""

    def __init__(self):
        self.captures = self.replays = 0

    def __call__(self, step, inputs):
        self.captures += 1
        outputs = step(*inputs)

        def replay():
            self.replays += 1
            for k, v in step(*inputs).items():
                outputs[k].copy_(v)

        return replay, outputs


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(graphs, "capture", rec)
    return rec


class Step:
    """A toy step: its eager calls, and ``{"y": 2x + 1}``."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return {"y": 2 * x + 1}


def test_first_sighting_runs_eager_and_the_second_captures(recorder):
    step = Step()
    g = graphs.StepGraphs(step, CPU, None)
    x = torch.arange(4.0)
    assert torch.equal(g([x])["y"], 2 * x + 1)
    assert (step.calls, recorder.captures, g.counts["first_sighting"]) == (1, 0, 1)
    assert torch.equal(g([x + 1])["y"], 2 * x + 3)
    assert (recorder.captures, recorder.replays, g.counts["captures"], g.counts["replays"]) \
        == (1, 1, 1, 1)
    assert torch.equal(g([x + 2])["y"], 2 * x + 5)
    assert (recorder.captures, recorder.replays, g.counts["replays"]) == (1, 2, 2)
    assert graphs.signature([x]) in g._graphs and graphs.signature([x[:2]]) not in g._graphs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_signature_is_every_shape_and_dtype(recorder, dtype):
    g = graphs.StepGraphs(Step(), CPU, None)
    x = torch.zeros(3, dtype=dtype)
    for _ in range(2):
        g([x])
    g([x.float() if dtype == torch.float64 else x.double()])  # another dtype: first sighting
    g([torch.zeros(4, dtype=dtype)])                          # another shape: first sighting
    assert (g.counts["first_sighting"], g.counts["captures"]) == (3, 1)


def test_the_cap_sends_later_signatures_eager(recorder):
    g = graphs.StepGraphs(Step(), CPU, None)
    n = graphs.MAX_GRAPHS + 2
    for size in range(1, n + 1):
        for _ in range(3):
            g([torch.ones(size)])
    c = g.counts
    assert c["captures"] == recorder.captures == graphs.MAX_GRAPHS
    assert c["replays"] == 2 * graphs.MAX_GRAPHS
    assert c["first_sighting"] == graphs.MAX_GRAPHS and c["cap"] == 3 * 2


def test_blocking_rule():
    assert graphs.blocked_by(CUDA, None) is None
    assert graphs.blocked_by(CUDA, object()) == "mesh"
    assert graphs.blocked_by(CPU, None) == "cpu" and graphs.blocked_by(CPU, object()) == "cpu"


@pytest.mark.parametrize("reason", ["cpu", "mesh"])
def test_a_blocked_step_never_captures(recorder, reason):
    step = Step()
    g = graphs.StepGraphs(step, CPU, reason)
    for _ in range(4):
        g([torch.ones(2)])
    assert recorder.captures == 0 and step.calls == 4 and not g._graphs
    assert g.counts == dict(captures=0, replays=0, first_sighting=0, cap=0,
                            **{r: 4 * (r == reason) for r in ("cpu", "mesh")})


def test_outputs_are_the_callers_own(recorder):
    g = graphs.StepGraphs(Step(), CPU, None)
    x = torch.arange(3.0)
    results = [g([x + i])["y"] for i in range(5)]
    for i, y in enumerate(results):
        assert torch.equal(y, 2 * (x + i) + 1)
    own = next(iter(g._graphs.values())).outputs["y"]
    assert all(y.data_ptr() != own.data_ptr() for y in results)
    results[-1].zero_()  # a caller writing its result touches no graph
    assert torch.equal(g([x])["y"], 2 * x + 1)


def test_a_replay_adds_its_captures_launches(recorder, monkeypatch):
    class Kernel:
        launches = 0

    recording = []

    def step(x):
        if not recording or recording[-1]:  # Python runs the launch: eager or capturing
            Kernel.launches += 3
        return {"y": x + 1}

    def capture(step_, inputs):
        recording.append(True)
        replay, out = Recorder()(step_, inputs)
        recording.append(False)
        return replay, out

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(prof, "LAUNCH_COUNTERS", [(Kernel, "launches")])
    g = graphs.StepGraphs(step, CPU, None)
    for n in range(1, 5):
        g([torch.ones(2)])
        assert Kernel.launches == 3 * n


def test_the_kernel_wrappers_register_their_launch_counters():
    from cvm_tpu_torch.infer.quantize import Int8Conv
    from cvm_tpu_torch.ops.cuda.fused_qconv import fused_qconv
    from cvm_tpu_torch.ops.cuda.gaussian_splat import render_heatmap
    from cvm_tpu_torch.ops.cuda.yuv_letterbox import yuv_letterbox

    want = [(fused_qconv, "launches"), (fused_qconv, "int8_out_launches"),
            (fused_qconv, "weight_packs"), (Int8Conv, "mm_launches"),
            (render_heatmap, "launches"), (yuv_letterbox, "launches")]
    assert all(c in prof.LAUNCH_COUNTERS for c in want)
    n = len(prof.LAUNCH_COUNTERS)
    prof.launch_counter(fused_qconv, "launches")  # a second registration adds nothing
    assert len(prof.LAUNCH_COUNTERS) == n


# A tiny semseg and CenterNet, as tests/test_torch_prof_spans.py builds them.
TINY = {"semseg": dict(input_hw=(32, 32), backbone="tiny", decoder_features=8, num_classes=3,
                       batch_size=1),
        "centernet": dict(input_hw=(32, 32), backbone="tiny", neck_features=16, head_features=8,
                          num_classes=3, top_k=10, batch_size=1)}


def _pipeline(name, unblock=True):
    spec = get_model(name)
    cfg = spec.params_cls(**TINY[name])
    model = build_model(spec, cfg, "cpu", torch.Generator().manual_seed(3))
    pipe = InferencePipeline(cfg, model, "cpu", input_format="yuv420", fold_bn=True)
    if unblock:  # as on a card: the stand-in capture records on the CPU
        pipe._graphs.blocked = None
    return pipe


def _frame(seed):
    rng = np.random.default_rng(seed)
    return {"y": rng.integers(0, 256, (1, 48, 48), dtype=np.uint8),
            "u": rng.integers(0, 256, (1, 24, 24), dtype=np.uint8),
            "v": rng.integers(0, 256, (1, 24, 24), dtype=np.uint8),
            "image_hw": np.array([[40 - 2 * seed, 46 - 2 * seed]], np.int32)}


def _eager(pipe, frame):
    return pipe.run(*(torch.from_numpy(frame[k]) for k in pipe.keys))


def test_a_cpu_pipeline_never_captures(recorder):
    pipe = _pipeline("semseg", unblock=False)
    for s in range(3):
        assert torch.equal(pipe(_frame(s))["class_map"], _eager(pipe, _frame(s))["class_map"])
    assert recorder.captures == 0
    assert pipe.graph_counts["cpu"] == 3 and pipe.graph_counts["replays"] == 0


@pytest.mark.parametrize("name", ["semseg", "centernet"])
def test_pipeline_replays_equal_run(recorder, name):
    pipe = _pipeline(name)
    frames = [_frame(s) for s in range(4)]
    results = [pipe(f) for f in frames]
    for f, got in zip(frames, results):  # each result as served, after all the calls
        want = _eager(pipe, f)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    c = pipe.graph_counts
    assert (c["first_sighting"], c["captures"], c["replays"]) == (1, 1, 3)
    assert recorder.replays == 3


def test_predict_takes_tensors_into_the_graph(recorder):
    pipe = _pipeline("semseg")
    frames = [[torch.from_numpy(_frame(s)[k]) for k in pipe.keys] for s in range(3)]
    got = [pipe.predict(*d)["class_map"] for d in frames]
    graph = next(iter(pipe._graphs._graphs.values()))
    assert all(torch.equal(a, b) for a, b in zip(graph.inputs, frames[-1]))
    assert all(b.data_ptr() != a.data_ptr() for a, b in zip(graph.inputs, frames[-1]))
    for d, y in zip(frames, got):
        assert torch.equal(y, pipe.run(*d)["class_map"])


def test_host_batch_goes_straight_into_the_graphs_inputs(recorder, monkeypatch):
    pipe = _pipeline("semseg")
    pipe(_frame(0)), pipe(_frame(1))

    def no_device_copy(*data):
        raise AssertionError("a captured signature's host batch went through predict")

    monkeypatch.setattr(pipe, "predict", no_device_copy)
    got = pipe(_frame(2))["class_map"]
    graph = next(iter(pipe._graphs._graphs.values()))
    for buf, k in zip(graph.inputs, pipe.keys):
        assert np.array_equal(buf.numpy(), _frame(2)[k])
    assert torch.equal(got, _eager(pipe, _frame(2))["class_map"])
    assert pipe.graph_counts["replays"] == 2


def test_cli_benchmark_counts_the_flops_of_a_captured_step(monkeypatch):
    from cvm_tpu_torch.cli import benchmark
    from cvm_tpu_torch.infer import pipeline

    captures = []

    def frozen(step, inputs):  # a replay that dispatches no op, as a card's does not
        captures.append(1)
        return (lambda: None), step(*inputs)

    monkeypatch.setattr(graphs, "capture", frozen)
    monkeypatch.setattr(pipeline, "blocked_by", lambda device, mesh: None)  # as on a card
    counted, count = [], benchmark._count_flops
    monkeypatch.setattr(benchmark, "_count_flops", lambda fn: counted.append(count(fn)) or counted[-1])
    cfg = get_model("semseg").params_cls(**TINY["semseg"])
    benchmark._bench_infer("semseg", cfg, CPU, iters=3, warmup=1)
    assert captures == [1] and len(counted) == 1 and counted[0] > 0


def _ranges(path):
    events = json.load(open(path))["traceEvents"]
    return [e["name"] for e in sorted(
        (e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and e.get("name", "").startswith("cvm.")), key=lambda e: e["ts"])]


def test_a_replayed_call_shows_the_replay_span(recorder, tmp_path):
    pipe = _pipeline("semseg")
    with prof.trace(str(tmp_path / "first")):
        pipe(_frame(0))
    pipe(_frame(1))
    with prof.trace(str(tmp_path / "replayed")):
        pipe(_frame(2))
    assert _ranges(tmp_path / "first" / "trace.json") == [
        "cvm.infer.call", "cvm.infer.h2d", "cvm.infer.preprocess", "cvm.infer.forward",
        "cvm.infer.postprocess"]
    # the stand-in's replay runs the step in Python, whose stage spans open
    # inside the replay's; a card's replay opens none
    replayed = _ranges(tmp_path / "replayed" / "trace.json")
    assert replayed[:3] == ["cvm.infer.call", "cvm.infer.h2d", "cvm.infer.replay"]
    assert replayed.count("cvm.infer.replay") == 1 and replayed.count("cvm.infer.h2d") == 1


def test_predict_with_device_tensors_opens_no_copy_span(recorder, tmp_path):
    pipe = _pipeline("semseg")
    data = [torch.from_numpy(_frame(0)[k]) for k in pipe.keys]
    pipe.predict(*data), pipe.predict(*data)
    with prof.trace(str(tmp_path / "replayed")):
        pipe.predict(*data)
    replayed = _ranges(tmp_path / "replayed" / "trace.json")
    assert replayed[0] == "cvm.infer.replay" and "cvm.infer.h2d" not in replayed
