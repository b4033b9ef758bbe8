"""The LR range finder (``train/lr_find.py``, ``cli/lr_find.py``) against
the reference's (``cvm_tpu/train/lr_find.py``), on the CPU.

Exact: the sweep's schedule, and the suggestion from the same (lr, loss)
curve (the same float64 numpy arithmetic). ``run_lr_finder`` sweeps a
tiny CenterNet through the real train step with the reference's LRs, the
optimizer it builds is the reference's chain (clip 10, AdamW with the
config's weight decay) on the sweep's schedule, it stops on divergence,
and ``cli.lr_find`` prints the picks and writes the curve.
"""

import json

import numpy as np
import pytest

from cvm_tpu.train import lr_find as jlr
from cvm_tpu_torch.cli.lr_find import main as lr_main
from cvm_tpu_torch.data.synthetic import SyntheticIterator
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.train import lr_find

TINY = dict(input_hw=(64, 64), num_classes=3, max_objects=8, backbone="tiny",
            neck_features=32, head_features=16, batch_size=2)


@pytest.mark.parametrize("lo,hi,n", [(1e-6, 1.0, 200), (1e-4, 3e-2, 7), (0.5, 2.0, 1)])
def test_schedule_is_the_references(lo, hi, n):
    got, want = lr_find.exp_range_schedule(lo, hi, n), jlr.exp_range_schedule(lo, hi, n)
    assert [got(s) for s in range(n)] == [want(s) for s in range(n)]
    assert got(0) == lo
    with pytest.raises(ValueError):
        lr_find.exp_range_schedule(hi, lo, n)


def test_suggestion_is_the_references_on_the_same_curve():
    rng = np.random.default_rng(0)
    sched = jlr.exp_range_schedule(1e-6, 1.0, 120)
    lrs = [sched(s) for s in range(120)]
    for shape in range(4):
        x = np.log10(lrs)
        base = 3.0 - 0.4 * np.tanh((x + 3.5) * (1 + shape)) + 0.002 * np.exp(2.2 * (x + 1))
        losses = (base + rng.normal(0, 0.05, base.shape)).tolist()
        assert lr_find.suggest_from_curve(lrs, losses) == jlr.suggest_from_curve(lrs, losses)
    short = ([1e-3, 1e-2, 1e-1, 1.0], [2.0, 1.5, 1.7, 3.0])
    assert lr_find.suggest_from_curve(*short) == jlr.suggest_from_curve(*short)
    with pytest.raises(ValueError):
        lr_find.suggest_from_curve([1.0, 2.0], [1.0, 2.0])


def test_run_lr_finder_sweeps_the_real_step():
    cfg = CenternetParams(**TINY, weight_decay=1e-4)
    res = lr_find.run_lr_finder(cfg, SyntheticIterator(0, 2, (96, 96), num_classes=3), "cpu",
                                num_steps=12, lr_min=1e-5, lr_max=1e-2)
    sched = jlr.exp_range_schedule(1e-5, 1e-2, 12)
    assert res["curve"]["lr"] == [sched(s) for s in range(12)]
    assert res["steps_run"] == 12 and not res["stopped_early"]
    assert all(np.isfinite(res["curve"]["loss"]))
    assert res["suggestion"] in res["curve"]["lr"]
    picks = {k: res[k] for k in ("lr_steepest", "lr_min_loss", "suggestion", "smoothed_min")}
    assert picks == jlr.suggest_from_curve(res["curve"]["lr"], res["curve"]["loss"])


def test_run_lr_finder_stops_on_divergence():
    res = lr_find.run_lr_finder(CenternetParams(**TINY),
                                SyntheticIterator(0, 2, (96, 96), num_classes=3), "cpu",
                                num_steps=40, lr_min=1e-3, lr_max=1e6)
    assert res["stopped_early"] and 11 < res["steps_run"] < 40


def test_cli_lr_find(tmp_path, capsys):
    curve = tmp_path / "curve.jsonl"
    assert lr_main(["--model", "centernet", "--device", "cpu", "--num_steps", "6",
                    "--pad_hw", "96,96", "--input_hw", "64,64", "--backbone", "tiny",
                    "--neck_features", "32", "--head_features", "16", "--num_classes", "3",
                    "--batch_size", "2", "--curve_out", str(curve)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps_run"] == 6 and np.isfinite(res["suggestion"])
    pts = [json.loads(line) for line in open(curve)]
    assert len(pts) == 6 and pts[0]["lr"] == 1e-6
