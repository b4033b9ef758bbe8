"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, check; no look for a card) on the CPU at a
tiny size, once sound and once for each fault the cell can have, judged
against the cell's committed limits."""

import tempfile

import pytest
import torch

from cvbench import run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11

TINY = {
    "semseg_a.infer_b1": {
        "config": {"params": {"input_hw": [64, 128], "batch_size": 1, "num_classes": 5,
                              "backbone": "tiny", "decoder_features": 16}},
        "mix": {"pool": 3, "buffer_hw": [100, 150], "src_h": [100, 100], "src_w": [150, 150],
                "check": {"frames": 3}}},
    "centernet_b.serve_int8": {
        "config": {"params": {"input_hw": [128, 128], "batch_size": 4, "num_classes": 6,
                              "stride": 4, "backbone": "tiny", "neck_features": 32,
                              "head_features": 16, "top_k": 10}},
        "mix": {"buckets": [1, 4], "rate": 150.0, "pool": 6, "buffer_hw": [400, 400],
                "src_h": [200, 400], "src_w": [200, 400], "clients": 8, "check": {"requests": 16}}},
}


def _run(cell_spec, cell, seconds=1.5):
    spec = cell_spec(cell)
    ov = TINY.get(cell)
    if cell == "centernet_b.train_records":
        p = dict(spec["config"]["params"], input_hw=[64, 64], num_classes=6, backbone="tiny",
                 neck_features=32, head_features=16, top_k=10, max_objects=16)
        ov = {"config": {"params": p},
              "mix": {"records": 40, "src_h": [60, 100], "src_w": [60, 100], "objects_mean": 3,
                      "max_objects": 16, "buffer_hw": [128, 128], "decode_target_hw": [0, 0],
                      "warm_steps": 1}}
    with tempfile.TemporaryDirectory() as tmp:
        out = run.run_cell(spec, SEED, seconds, False, CPU, tmp, ov)
    return out["correct"], {n: v for n, v, _ in out["compared"]}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_semseg_answer_altered(monkeypatch, cell_spec):
    import cvm_tpu_torch.infer.pipeline as pl

    ok, sound = _run(cell_spec, "semseg_a.infer_b1")
    argmax = pl.semseg_argmax
    monkeypatch.setattr(pl, "semseg_argmax", lambda logits: (argmax(logits) + 1) % logits.shape[-1])
    bad, broken = _run(cell_spec, "semseg_a.infer_b1")
    assert ok and not bad
    assert broken["class_gap"] > 3 * max(sound["class_gap"], 1e-3)


@pytest.mark.parametrize("fault", ["class", "box"])
def test_serve_answer_altered(monkeypatch, cell_spec, fault):
    import cvm_tpu_torch.infer.pipeline as pl

    ok, sound = _run(cell_spec, "centernet_b.serve_int8")
    if fault == "class":
        decode = pl.decode_centernet

        def altered(heatmap, *a, **kw):
            det = decode(heatmap, *a, **kw)
            return det._replace(classes=(det.classes + 1) % heatmap.shape[-1])

        monkeypatch.setattr(pl, "decode_centernet", altered)
    else:
        mapped = pl.map_boxes_to_input
        monkeypatch.setattr(pl, "map_boxes_to_input",
                            lambda boxes, rois: mapped(boxes, rois) + 64.0)
    bad, broken = _run(cell_spec, "centernet_b.serve_int8")
    assert ok and not bad
    assert broken["box_gap_px"] > 3 * max(sound["box_gap_px"], 0.5)


def test_serve_half_the_batch_answered_wrong(monkeypatch, cell_spec):
    from cvm_tpu_torch.infer.runtime import ServingModel

    call = ServingModel.__call__

    def half(self, *data):
        out = call(self, *data)
        n = int(data[0].shape[0])
        if n < 2:
            return out
        keep = n // 2
        idx = torch.arange(n) % keep          # the second half gets the first half's answers
        return {k: v[idx.to(v.device)] for k, v in out.items()}

    monkeypatch.setattr(ServingModel, "__call__", half)
    bad, broken = _run(cell_spec, "centernet_b.serve_int8")
    assert not bad


def test_train_half_the_batch_left_out(monkeypatch, cell_spec):
    import cvm_tpu_torch.models.centernet.loss as L

    ok, sound = _run(cell_spec, "centernet_b.train_records")
    loss = L.centernet_loss

    def half(out, targets, params, red=None, **kw):
        n = out["heatmap"].shape[0] // 2
        return loss({k: v[:n] for k, v in out.items()},
                    type(targets)(*(f[:n] if torch.is_tensor(f) else f for f in targets)),
                    params, *(() if red is None else (red,)))

    monkeypatch.setattr(L, "centernet_loss", half)
    bad, broken = _run(cell_spec, "centernet_b.train_records")
    assert not bad
    assert broken["loss_gap"] > 10 * sound["loss_gap"]


def test_train_state_left_unchanged(monkeypatch, cell_spec):
    from cvm_tpu_torch.train.optim import Optimizer

    def frozen(self, grads):
        self.count += 1
        return True

    monkeypatch.setattr(Optimizer, "step", frozen)
    bad, broken = _run(cell_spec, "centernet_b.train_records")
    assert not bad
    assert broken["change_gap"] == pytest.approx(1.0)


DP_FAULTS = {
    # each rank keeps its own gradients: the exchange between cards left out
    "exchange": "import cvm_tpu_torch.parallel.mesh as m\n"
                "m.Mesh.all_reduce_grads = lambda self, grads: list(grads)\n",
    "unchanged": "import cvm_tpu_torch.train.optim as o\n"
                 "def step(self, grads):\n    self.count += 1\n    return True\n"
                 "o.Optimizer.step = step\n",
    "half_batch": "import torch\nimport cvm_tpu_torch.models.centernet.loss as L\n"
                  "f = L.centernet_loss\n"
                  "def half(out, t, p, red=None):\n"
                  "    n = out['heatmap'].shape[0] // 2\n"
                  "    t = type(t)(*(x[:n] if torch.is_tensor(x) else x for x in t))\n"
                  "    return f({k: v[:n] for k, v in out.items()}, t, p, *(() if red is None else (red,)))\n"
                  "L.centernet_loss = half\n",
}


def _dp_spec(cell_spec):
    """The four-card training cell as a later manifest would name it (its
    runner, rank and mix are here; its limits are not read yet): the one-card
    cell's configuration, check and limits over the four-rank mix."""
    spec = cell_spec("centernet_b.train_records")
    cell = dict(spec["cell"], name="centernet_b.train_dp4", traffic="records_coco_dp4", chips=4)
    return dict(spec, cell=cell, mix=run.load_json(run.HERE / "traffic" / "records_coco_dp4.json"))


def _run_dp(cell_spec):
    spec = _dp_spec(cell_spec)
    p = dict(spec["config"]["params"], input_hw=[64, 64], num_classes=6, backbone="tiny",
             neck_features=32, head_features=16, top_k=10, max_objects=16, batch_size=2)
    ov = {"config": {"params": p},
          "mix": {"records": 40, "src_h": [60, 100], "src_w": [60, 100], "objects_mean": 3,
                  "max_objects": 16, "buffer_hw": [128, 128], "decode_target_hw": [0, 0],
                  "warm_steps": 1, "decode_threads": 1}}
    with tempfile.TemporaryDirectory() as tmp:
        out = run.run_cell(spec, SEED, 1.5, False, CPU, tmp, ov)
    return out["correct"], {n: v for n, v, _ in out["compared"]}


@pytest.mark.parametrize("fault", [None, *DP_FAULTS])
def test_data_parallel_faults(monkeypatch, tmp_path, cell_spec, fault):
    """Four gloo ranks on the CPU: sound, and with each fault planted in
    every rank (a ``sitecustomize`` the ranks import at start)."""
    if fault is not None:
        (tmp_path / "sitecustomize.py").write_text(DP_FAULTS[fault])
        monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    ok, got = _run_dp(cell_spec)
    if fault is None:
        assert ok, got
    else:
        assert not ok, got
