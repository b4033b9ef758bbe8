"""The dense zoo's evaluation and entry points (cvm_tpu_torch) against the
reference, on the CPU at a tiny size (``backbone="tiny"``, 64x128, batches
of 2).

* ``evaluate_model`` with the same injected predictions (``predict_fn``)
  gives exactly the reference's metrics: the GT masks and depth go
  through the same letterbox resample (``sample_nearest``) into the same
  evaluators, so equal class maps score equal mIoU, pixel accuracy,
  confusion matrix and depth metrics.
* ``evaluate_model`` through each model, from the same converted weights
  on the same scenes: mIoU, pixel_acc, abs_rel, rmse and delta1 (and
  multitask's mAP) within 0.01 of the reference.
* ``cli.train`` and ``cli.evaluate`` for each model (a few steps, evals,
  a best checkpoint, the postures); ``cli.train`` checks the multi-process
  flags as the reference does and refuses ``--dcn_slices``, naming why; ``cli.benchmark`` on tiny configs
  prints one line per config with the reference's keys, the device and
  its power limit, in inference and training, and times config E's (dmds)
  training step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.train import evaluate as j_eval
from cvm_tpu_torch.cli import benchmark
from cvm_tpu_torch.cli.evaluate import main as eval_main
from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.data.synthetic import synthetic_batch
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.train import evaluate as t_eval
from test_torch_model import random_bn_stats

HW = (64, 128)
PAD = (80, 160)
TINY = {
    "semseg": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=2),
    "depth": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=2),
    "multitask": dict(input_hw=HW, backbone="tiny", neck_features=32, head_features=16,
                      batch_size=2, num_det_classes=3, top_k=20),
}

SEG_LEAN = 0.4  # added to an untrained seg head's background logit


def _val(n=3, seed=999):
    rng = np.random.default_rng(seed)
    return [synthetic_batch(rng, 2, PAD, num_classes=3) for _ in range(n)]


def _injected(name, cfg, val):
    """The same predictions for both sides, one dict per batch."""
    rng = np.random.default_rng(4)
    preds = []
    for b in val:
        B, (H, W) = b["image_hw"].shape[0], cfg.input_hw
        p = {}
        if name in ("semseg", "multitask"):
            p["class_map"] = rng.integers(0, 5, (B, H, W)).astype(np.int32)
        if name in ("depth", "multitask"):
            p["depth"] = rng.uniform(3, 45, (B, H, W, 1)).astype(np.float32)
        if name == "multitask":
            x0 = rng.uniform(0, 120, (B, 20, 2)).astype(np.float32)
            p.update(boxes=np.concatenate([x0, x0 + rng.uniform(5, 60, (B, 20, 2))], -1),
                     scores=rng.uniform(0, 1, (B, 20)).astype(np.float32),
                     classes=rng.integers(0, 3, (B, 20)).astype(np.int32))
        preds.append(p)
    return preds


@pytest.mark.parametrize("name", sorted(TINY))
def test_evaluate_model_with_injected_predictions_is_exact(name):
    cfg_t = get_model(name).params_cls(**TINY[name])
    cfg_j = j_get_model(name).params_cls(**TINY[name])
    val = _val()
    preds = _injected(name, cfg_t, val)
    it_t, it_j = iter(preds), iter(preds)
    got = t_eval.evaluate_model(name, cfg_t, None, val, device="cpu", confusion=True,
                                per_class=True, predict_fn=lambda b: next(it_t))
    ref = j_eval.evaluate_model(j_get_model(name), cfg_j, None, val, confusion=True,
                                per_class=True, predict_fn=lambda b: next(it_j))
    assert got == ref
    want = {"semseg": {"miou", "pixel_acc", "confusion"},
            "depth": {"abs_rel", "rmse", "delta1"},
            "multitask": {"mAP", "miou", "pixel_acc", "abs_rel", "delta1"}}[name]
    assert want <= set(got)


@pytest.mark.parametrize("name", sorted(TINY))
def test_evaluate_model_through_the_model_matches_reference(name):
    jspec, tspec = j_get_model(name), get_model(name)
    cfg_j, cfg_t = jspec.params_cls(**TINY[name]), tspec.params_cls(**TINY[name])
    jm = jspec.create_model(cfg_j)
    variables = random_bn_stats(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, *HW, 3)),
                                        train=False), np.random.default_rng(6))
    # Untrained heads: lean the class logits towards the background and the
    # depth towards the scenes' range (sigmoid(-3.9) maps to about 20 m),
    # so that mIoU and delta1 are not 0 on both sides.
    for head, node in variables["params"].items():
        if head == "seg" or head.startswith("disp"):
            bias = np.array(node["out"]["bias"])
            if head == "seg":
                bias[0] += SEG_LEAN
            else:
                bias[:] = -3.9
            node["out"]["bias"] = bias
    model = tspec.create_model(cfg_t, "cpu")
    model.load_state_dict(convert_variables(variables), strict=True)
    val = _val(2)
    got = t_eval.evaluate_model(name, cfg_t, model, val, device="cpu")
    ref = j_eval.evaluate_model(jspec, cfg_j, variables, val)
    assert set(got) == set(ref)
    for k in ("miou", "pixel_acc", "abs_rel", "rmse", "delta1", "mAP"):
        if k in ref:
            scale = 1.0 if k in ("miou", "pixel_acc", "delta1", "mAP") else abs(ref[k])
            assert abs(got[k] - ref[k]) <= 0.01 * scale, (k, got[k], ref[k])
    for k in ("miou", "delta1"):
        if k in got:
            assert 0.0 < got[k] < 1.0, (k, got[k])


KEEP_BEST = {"semseg": "miou", "depth": "delta1", "multitask": "miou"}


def _flags(name):
    kw = dict(TINY[name], warmup_steps=2)
    out = []
    for k, v in kw.items():
        out += [f"--{k}", ",".join(map(str, v)) if isinstance(v, tuple) else str(v)]
    return out


@pytest.mark.parametrize("name", sorted(TINY))
def test_cli_train_and_evaluate(tmp_path, name):
    wd = tmp_path / "w"
    base = ["--model", name, "--device", "cpu", "--workdir", str(wd), "--pad_hw", "80,160"]
    assert train_main(base + _flags(name) + [
        "--steps", "4", "--log_every", "1", "--checkpoint_every", "2", "--eval_every", "2",
        "--eval_batches", "1", "--keep_best", KEEP_BEST[name]]) == 0
    rows = [json.loads(line) for line in open(wd / "metrics.jsonl")]
    evals = [r for r in rows if f"val_{KEEP_BEST[name]}" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    assert (wd / "best" / "best.json").exists()
    postures = [[], ["--fold_bn"], ["--tta", "hflip"]]
    if name == "semseg":
        postures += [["--confusion"], ["--quantize", "w8a8_fused_chain", "--calib_batches", "1"]]
    for extra in postures:
        out = tmp_path / "m.json"
        assert eval_main(["--model", name, "--workdir", str(wd), "--device", "cpu",
                          "--pad_hw", "80,160", "--batches", "1", "--json_out", str(out)]
                         + extra) == 0
        m = json.loads(out.read_text())
        assert m["step"] == 4
        key = KEEP_BEST[name]
        assert np.isfinite(m[key]) and 0.0 <= m[key] <= 1.0, (extra, m)
        assert ("confusion" in m) == (extra == ["--confusion"])
    with pytest.raises(FileNotFoundError):
        eval_main(["--model", name, "--workdir", str(wd), "--device", "cpu", "--data",
                   str(tmp_path / "val.cvrec")])


# The multi-process flags, ported: each gets the reference's argument check (and
# --dcn_slices its reason for not being ported) before anything trains.
_REFUSALS = {
    "--model_parallel": "1 processes not divisible by --model_parallel 2",
    "--dcn_slices": "--dcn_slices is not ported: it orders a multi-slice TPU mesh",
    "--coordinator": "--coordinator requires --num_processes and --process_id",
}


# ids: the names these cases have had since they were ROADMAP item 17's refusals
@pytest.mark.parametrize("flag", [
    ["--model_parallel", "2"], ["--dcn_slices", "2"],
    ["--coordinator", "127.0.0.1:1", "--num_processes", "2"],
    ["--coordinator", "127.0.0.1:1", "--process_id", "1"]],
    ids=[f"flag{i}-17" for i in range(4)])
def test_cli_train_refuses_unported_reference_flags(flag, capsys):
    argv = ["--model", "semseg", "--device", "cpu"] + flag
    with pytest.raises(SystemExit) as e:
        train_main(argv)
    assert _REFUSALS[flag[0]] in str(e.value.code) + capsys.readouterr().err


def test_cli_benchmark_prints_a_line_per_config_and_refuses_e(monkeypatch, capsys):
    tiny = {"A": ("semseg", get_model("semseg").params_cls(**dict(TINY["semseg"],
                                                                  batch_size=1)), "infer"),
            "C": ("depth", get_model("depth").params_cls(**TINY["depth"]), "infer"),
            "D": ("multitask", get_model("multitask").params_cls(**TINY["multitask"]),
                  "infer"),
            "E": ("dmds", get_model("dmds").params_cls(input_hw=HW, backbone="tiny",
                                                       decoder_features=16,
                                                       motion_features=16, batch_size=2),
                  "train")}
    monkeypatch.setattr(benchmark, "_configs", lambda: tiny)
    assert benchmark.main(["--configs", "A,C,D", "--iters", "3", "--device", "cpu"]) == 0
    assert benchmark.main(["--configs", "A", "--iters", "2", "--train", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [(r["config"], r["mode"]) for r in lines] == [("A", "infer"), ("C", "infer"),
                                                         ("D", "infer"), ("A", "train")]
    for r in lines:
        assert r["device"] == "cpu" and r["power_limit_w"] is None
        assert "mfu_pct" not in r and r["achieved_tflops"] >= 0
    assert {"images_per_sec", "p50_latency_ms", "batch_size", "model", "input_hw"} <= set(lines[0])
    assert lines[0]["batch_size"] == 1 and lines[0]["input_hw"] == list(HW)
    assert {"steps_per_sec", "steps_per_sec_blocked", "p50_step_ms_blocked",
            "pipelined_steps", "tflops_per_step"} <= set(lines[3])
    # Config E (dmds) times its training step, as the reference's.
    assert benchmark.main(["--configs", "E", "--iters", "2", "--device", "cpu"]) == 0
    (e,) = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert (e["config"], e["model"], e["mode"]) == ("E", "dmds", "train")
    assert e["steps_per_sec"] > 0 and e["batch_size"] == 2
