"""The batch-8 detection cell (``centernet_b.infer_fp_b8``, runner
``closed_loop_batches``) on the CPU at a tiny size: a sound run reads
correct, and each fault planted under the timed path reads not correct
against the cell's committed limits: the rows of a batch answered in a
rotated order, one row letterboxed with another row's ``image_hw``, a class
altered, boxes shifted by 64 px. Also the runner's batches and its two
new per-layer readers on hand-built counters and traces."""

import tempfile

import numpy as np
import pytest
import torch

from cvbench import run
from cvbench.runners.closed_loop_batches import stack
from cvbench.trace import Trace

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
CELL = "centernet_b.infer_fp_b8"
TINY = {"config": {"params": {"input_hw": [64, 64], "batch_size": 8, "num_classes": 5,
                              "stride": 4, "backbone": "tiny", "neck_features": 32,
                              "head_features": 16, "top_k": 10}},
        "mix": {"pool": 16, "buffer_hw": [100, 100], "src_h": [40, 100], "src_w": [40, 100]}}


def _run(cell_spec):
    with tempfile.TemporaryDirectory() as tmp:
        out = run.run_cell(cell_spec(CELL), SEED, 1.0, False, CPU, tmp, TINY)
    return out["correct"], {n: v for n, v, _ in out["compared"]}, out


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def limits(cell_spec):
    return cell_spec(CELL)["limits"]


def test_a_sound_run_is_correct(cell_spec, limits):
    ok, got, out = _run(cell_spec)
    assert ok, got
    assert set(got) == set(limits)
    c = out["counters"]
    assert c["frames"] == out["attempted"] and c["frames"] % 8 == 0
    assert c["graph_counts"]["cpu"] == c["frames"] // 8      # a CPU pipeline never captures
    assert len(out["samples"]) == 16
    for frame, served in out["samples"]:
        assert frame["y"].shape[0] == 1 and served["boxes"].shape == (1, 10, 4)


def test_rows_answered_in_a_rotated_order(monkeypatch, cell_spec, limits):
    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    call = InferencePipeline.__call__
    monkeypatch.setattr(InferencePipeline, "__call__",
                        lambda self, batch: {k: torch.roll(v, 1, 0)
                                             for k, v in call(self, batch).items()})
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["pixel_score_gap"] > limits["pixel_score_gap"], got


def test_one_row_letterboxed_with_another_rows_size(monkeypatch, cell_spec, limits):
    import cvm_tpu_torch.infer.pipeline as pl

    pre = pl.preprocess_yuv420_batch

    def wrong(y, u, v, image_hw, *a, **kw):
        image_hw = image_hw.clone()
        image_hw[0] = image_hw[1]
        return pre(y, u, v, image_hw, *a, **kw)

    monkeypatch.setattr(pl, "preprocess_yuv420_batch", wrong)
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["pixel_box_gap_px"] > limits["pixel_box_gap_px"], got


def test_a_class_altered(monkeypatch, cell_spec, limits):
    import cvm_tpu_torch.infer.pipeline as pl

    decode = pl.decode_centernet

    def altered(heatmap, *a, **kw):
        det = decode(heatmap, *a, **kw)
        return det._replace(classes=(det.classes + 1) % heatmap.shape[-1])

    monkeypatch.setattr(pl, "decode_centernet", altered)
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["pixel_box_gap_px"] > limits["pixel_box_gap_px"], got


def test_boxes_shifted_64px(monkeypatch, cell_spec, limits):
    import cvm_tpu_torch.infer.pipeline as pl

    mapped = pl.map_boxes_to_input
    monkeypatch.setattr(pl, "map_boxes_to_input", lambda boxes, rois: mapped(boxes, rois) + 64.0)
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["pixel_box_gap_px"] > 60.0 and got["pixel_score_gap"] > limits["pixel_score_gap"]


def test_stack_keeps_pool_order():
    pool = [{"y": np.full((1, 2, 2), i, np.uint8), "image_hw": np.array([[i, i]], np.int32)}
            for i in range(6)]
    batches = stack(pool, 3)
    assert len(batches) == 2 and batches[1]["y"].shape == (3, 2, 2)
    assert batches[1]["y"][2, 0, 0] == 5 and batches[0]["image_hw"][1, 0] == 1
    with pytest.raises(ValueError):
        stack(pool, 4)


def _ctx(counters, trace=None):
    return run.Context(trace=trace, counters=counters, peak=None, card="cpu")


def test_graph_replay_pct_reads_the_windows_counts():
    read = run.metric_reader("graph_replay_pct.infer")
    counts = {"captures": 0, "replays": 99, "first_sighting": 0, "cap": 1, "cpu": 0, "mesh": 0}
    assert read(_ctx({"graph_counts": counts})) == pytest.approx(99.0)
    assert read(_ctx({"graph_counts": dict(counts, replays=0, cap=0, cpu=5)})) == 0.0
    assert read(_ctx({})) is None


def test_h2d_ms_per_image_reads_the_copies_of_the_stretch():
    read = run.metric_reader("h2d_ms_per_image.infer")
    ops = [("Memcpy HtoD (Pageable -> Device)", 0.016), ("some_kernel", 0.5),
           ("Memcpy DtoH (Device -> Pageable)", 0.004)]
    tr = Trace(2.0, 1.0, 10, ops, [], [], {})
    assert read(_ctx({"frames_in_stretch": 80}, tr)) == pytest.approx(0.2)
    assert read(_ctx({"frames_in_stretch": 80}, tr._replace(device_ops=ops[1:]))) is None
    assert read(_ctx({"frames_in_stretch": 80})) is None
