"""``cli.train --eval_every / --keep_best / --early_stop`` and ``cli.evaluate``
of cvm_tpu_torch on the CPU at a tiny size (``backbone="tiny"``, 64x64 input,
batches of 2): the eval rows and the best checkpoint, the early stop, a run
stopped and resumed against one that is not (the same losses and evals, bit
for bit), the reference's argument checks, every evaluation posture and
each refusal.
"""

import json

import numpy as np
import pytest

import cvm_tpu.cli.train as j_train
from cvm_tpu_torch.cli.evaluate import main as eval_main
from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.train import evaluate as t_eval

BASE = ["--model", "centernet", "--data", "synthetic", "--device", "cpu", "--pad_hw", "96,96",
        "--input_hw", "64,64", "--backbone", "tiny", "--neck_features", "32",
        "--head_features", "16", "--num_classes", "3", "--batch_size", "2",
        "--warmup_steps", "2", "--log_every", "1", "--checkpoint_every", "3"]
EVAL = ["--eval_every", "5", "--eval_batches", "1", "--keep_best", "mAP"]


def records(workdir):
    with open(workdir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """10 steps with an eval every 5 and the best checkpoint kept."""
    w = tmp_path_factory.mktemp("run")
    assert train_main(BASE + EVAL + ["--workdir", str(w), "--steps", "10"]) == 0
    return w


def test_train_writes_eval_rows_and_the_best_checkpoint(workdir):
    recs = records(workdir)
    evals = [r for r in recs if "val_mAP" in r]
    assert [r["step"] for r in evals] == [5, 10]
    for r in evals:
        assert {"val_mAP", "val_mAP50", "val_mAP75", "eval_seconds"} <= set(r)
        assert all(0.0 <= r[k] <= 1.0 for k in ("val_mAP", "val_mAP50", "val_mAP75"))
    assert [r["step"] for r in recs if "loss" in r] == list(range(1, 11))
    best = json.loads((workdir / "best" / "best.json").read_text())
    assert best["metric"] == "mAP" and best["step"] in (5, 10)
    assert (workdir / "best" / f"{best['step']}.pt").exists()
    assert (workdir / "best" / "params.json").exists()


def test_early_stop_fires_at_the_second_eval(tmp_path, monkeypatch, capsys):
    falling = iter([0.5, 0.4, 0.3, 0.2])
    monkeypatch.setattr(t_eval, "evaluate_model",
                        lambda *a, **k: {"mAP": next(falling), "mAP50": 0.0, "mAP75": 0.0})
    assert train_main(BASE + EVAL + ["--early_stop", "1", "--workdir", str(tmp_path),
                                     "--steps", "20"]) == 0
    assert "early stop @step 10" in capsys.readouterr().out
    recs = records(tmp_path)
    assert [r["step"] for r in recs if "val_mAP" in r] == [5, 10]
    assert max(r["step"] for r in recs) == 10
    assert json.loads((tmp_path / "best" / "best.json").read_text())["step"] == 5


def test_stopped_and_resumed_run_logs_what_a_straight_run_logs(tmp_path):
    straight, split = tmp_path / "straight", tmp_path / "split"
    assert train_main(BASE + EVAL + ["--workdir", str(straight), "--steps", "10"]) == 0
    assert train_main(BASE + EVAL + ["--workdir", str(split), "--steps", "6"]) == 0
    assert train_main(BASE + EVAL + ["--workdir", str(split), "--steps", "10"]) == 0
    a, b = records(straight), records(split)
    losses = {r["step"]: r["loss"] for r in a if "loss" in r}
    assert {r["step"]: r["loss"] for r in b if "loss" in r} == losses
    assert sorted(losses) == list(range(1, 11))
    val_a = {r["step"]: r["val_mAP"] for r in a if "val_mAP" in r}
    val_b = {r["step"]: r["val_mAP"] for r in b if "val_mAP" in r}
    assert sorted(val_a) == [5, 10] and sorted(val_b) == [5, 6, 10]  # 6: the first run's end
    assert val_b[5] == val_a[5] and val_b[10] == val_a[10]
    # Resumed at or past the target (the newest checkpoint is step 9): the
    # final eval still runs.
    assert train_main(BASE + EVAL + ["--workdir", str(split), "--steps", "8"]) == 0
    assert records(split)[-1]["step"] == 9 and "val_mAP" in records(split)[-1]


@pytest.mark.parametrize("argv", [["--keep_best", "mAP"],
                                  ["--eval_images", "2", "--eval_every", "5"],
                                  ["--early_stop", "2"]])
def test_argument_checks_fail_as_the_reference(argv, capsys):
    with pytest.raises(SystemExit) as ref:
        j_train.main(["--model", "centernet"] + argv)
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        train_main(["--model", "centernet", "--device", "cpu"] + argv)
    assert got.value.code == ref.value.code == 2
    assert capsys.readouterr().err.strip().splitlines()[-1] == ref_err


@pytest.mark.parametrize("extra", [[], ["--fold_bn"], ["--quantize", "int8"],
                                   ["--quantize", "w8a8_fused", "--calib_batches", "1"],
                                   ["--quantize", "w8a8_fused_chain", "--calib_batches", "1"],
                                   ["--quantize", "w8a8"],
                                   ["--quantize", "w8a8_static", "--calib_batches", "1"],
                                   ["--quantize", "w8a8_static", "--fold_bn",
                                    "--calib_batches", "1"],
                                   ["--tta", "hflip"], ["--average_last", "2"],
                                   ["--checkpoint_dir", "best"]],
                         ids=["fp", "fold_bn", "int8", "w8a8_fused", "w8a8_fused_chain", "w8a8",
                              "w8a8_static", "w8a8_static_fold_bn", "tta", "average_last",
                              "best"])
def test_evaluate_postures(workdir, tmp_path, extra):
    out = tmp_path / "m.json"
    extra = [str(workdir / e) if e == "best" else e for e in extra]
    assert eval_main(["--model", "centernet", "--workdir", str(workdir), "--device", "cpu",
                      "--pad_hw", "96,96", "--batches", "2", "--json_out", str(out)] + extra) == 0
    m = json.loads(out.read_text())
    best_step = json.loads((workdir / "best" / "best.json").read_text())["step"]
    assert m["step"] == (best_step if "--checkpoint_dir" in extra else 9)
    assert m["quantize"] == (extra[1] if extra[:1] == ["--quantize"] else "none")
    assert all(np.isfinite(m[k]) and 0.0 <= m[k] <= 1.0 for k in ("mAP", "mAP50", "mAP75"))


def test_evaluate_breakdowns(workdir, tmp_path):
    out, pr = tmp_path / "m.json", tmp_path / "pr.json"
    assert eval_main(["--model", "centernet", "--workdir", str(workdir), "--device", "cpu",
                      "--pad_hw", "96,96", "--batches", "2", "--json_out", str(out),
                      "--per_class", "--size_ap", "--pr_out", str(pr)]) == 0
    m = json.loads(out.read_text())
    assert {"mAP_small", "mAP_medium", "mAP_large"} <= set(m)
    assert any(k.startswith("ap_class_") for k in m) and "pr_curves" not in m
    assert json.loads(pr.read_text())["iou"] == 0.5


@pytest.mark.parametrize("extra,match", [
    (["--quantize", "w8a8_fused", "--fold_bn"], None),
    (["--artifact", "x", "--tta", "hflip"], None),
    (["--artifact", "x", "--quantize", "w8a8"], None),
    (["--artifact", "x", "--input_hw", "32,32"], None),
    (["--model", "semseg", "--pr_out", "x"], None),
    (["--data", "a.cvrec", "--split", "test"], None),
])
def test_evaluate_refusals(workdir, extra, match):
    argv = ["--model", "centernet", "--workdir", str(workdir), "--device", "cpu"] + extra
    with pytest.raises(SystemExit) as e:
        eval_main(argv)
    if match is None:
        assert e.value.code == 2  # the reference's parser.error
    else:
        assert "not ported yet" in str(e.value.code) and match in str(e.value.code)
