"""The 3D CenterNet and DMDS entry points of cvm_tpu_torch, end to end on
the CPU at a tiny size (``backbone="tiny"``, batch 2).

* ``cli.train`` with ``--with_3d true`` and with ``--model dmds``: a few
  steps on the reference's synthetic scenes (3D labels, two frames), evals
  with the reference's metric names (``val_center_err_3d_m``,
  ``val_depth3d_abs_rel``, ``val_matched_3d_frac``; the median-scaled
  ``val_abs_rel`` / ``val_delta1``) and a ``--keep_best`` checkpoint;
  finite losses including the 3D and DMDS terms.
* ``cli.evaluate`` on each run in its postures (DMDS: fp, ``--fold_bn``,
  weight-only ``int8``); ``--quantize w8a8*`` with dmds exits with the
  reference's refusal, as does ``cli.export``.
* ``cli.export`` of the 3D run in ``none`` and ``w8a8_fused`` (yuv420, with
  intrinsics) and of the DMDS run in ``none`` (two frames; rgb and
  yuv420) and weight-only ``int8``: each artifact is served by ``ServingModel(device="cpu")``, its
  selftest passes (``cli.serve --selftest`` exits 0), its outputs equal the
  eager pipeline's of the same posture (within 1e-5), and ``cli.evaluate
  --artifact`` scores it.
* ``cli.benchmark --configs E --device cpu`` (on a tiny config E) prints
  its JSON line, timing the DMDS training step.
"""

import json
import os

import numpy as np
import pytest
import torch

from cvm_tpu_torch.cli import benchmark
from cvm_tpu_torch.cli.evaluate import main as eval_main
from cvm_tpu_torch.cli.export import export_model
from cvm_tpu_torch.cli.serve import main as serve_main
from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.data.synthetic import synthetic_batch
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.runtime import ServingModel
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.train.checkpoints import load_params_cfg
from cvm_tpu_torch.train.loop import Trainer

RUNS = {
    "3d": dict(model="centernet", pad="96,96", flags=[
        "--with_3d", "true", "--input_hw", "64,64", "--neck_features", "16",
        "--head_features", "8", "--num_classes", "3"], keep="mAP",
        evals=("mAP", "center_err_3d_m", "depth3d_abs_rel", "matched_3d_frac")),
    "dmds": dict(model="dmds", pad="96,160", flags=[
        "--input_hw", "64,128", "--decoder_features", "16", "--motion_features", "32"],
        keep="delta1", evals=("abs_rel", "delta1", "rmse")),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo3d")
    out = {}
    for name, r in RUNS.items():
        wd = root / name
        assert train_main(["--model", r["model"], "--data", "synthetic", "--device", "cpu",
                           "--workdir", str(wd), "--pad_hw", r["pad"], "--backbone", "tiny",
                           "--batch_size", "2", "--warmup_steps", "2", "--log_every", "1",
                           "--checkpoint_every", "2", "--steps", "4", "--eval_every", "2",
                           "--eval_batches", "1", "--keep_best", r["keep"]] + r["flags"]) == 0
        out[name] = wd
    return root, out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_train_with_evals_and_best(runs, name):
    wd = runs[1][name]
    rows = [json.loads(line) for line in open(wd / "metrics.jsonl")]
    train = [r for r in rows if "loss" in r]
    evals = [r for r in rows if f"val_{RUNS[name]['keep']}" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert [r["step"] for r in evals] == [2, 4]
    terms = ("loss_dep3d", "loss_dim3d", "loss_rot") if name == "3d" else (
        "loss_photo", "loss_smooth", "loss_cycle", "loss_msparse")
    assert all(np.isfinite(r[k]) for r in train for k in ("loss", "grad_norm") + terms)
    for k in RUNS[name]["evals"]:
        assert all(np.isfinite(r[f"val_{k}"]) for r in evals), k
    assert (wd / "best" / "best.json").exists()
    cfg = load_params_cfg(str(wd / "checkpoints"), get_model(RUNS[name]["model"]).params_cls)
    assert cfg.with_3d if name == "3d" else cfg.name == "dmds"


@pytest.mark.parametrize("name,extra", [
    ("3d", []), ("3d", ["--quantize", "w8a8_fused_chain", "--calib_batches", "1"]),
    ("3d", ["--checkpoint_dir", "BEST"]), ("dmds", []), ("dmds", ["--fold_bn"]),
    ("dmds", ["--quantize", "int8"])])
def test_cli_evaluate_postures(runs, tmp_path, name, extra):
    wd = runs[1][name]
    extra = [str(wd / "best") if e == "BEST" else e for e in extra]
    out = tmp_path / "m.json"
    assert eval_main(["--model", RUNS[name]["model"], "--workdir", str(wd), "--device", "cpu",
                      "--pad_hw", RUNS[name]["pad"], "--batches", "2", "--json_out", str(out)]
                     + extra) == 0
    m = json.loads(out.read_text())
    for k in RUNS[name]["evals"]:
        assert np.isfinite(m[k]), (k, m)


@pytest.mark.parametrize("q", ["w8a8", "w8a8_static", "w8a8_fused", "w8a8_fused_chain"])
def test_dmds_refuses_w8a8(runs, tmp_path, q):
    wd = runs[1]["dmds"]
    with pytest.raises(SystemExit):
        eval_main(["--model", "dmds", "--workdir", str(wd), "--device", "cpu", "--quantize", q])
    if q != "w8a8_static":
        with pytest.raises(ValueError, match="w8a8 export not supported for two-frame dmds"):
            export_model("dmds", str(wd / "checkpoints"), str(tmp_path / "a"), quantize=q,
                         device="cpu")


EXPORTS = [("3d", "none", "yuv420"), ("3d", "w8a8_fused", "yuv420"), ("dmds", "none", "rgb"),
           ("dmds", "none", "yuv420"), ("dmds", "int8", "rgb")]


@pytest.mark.parametrize("name,quantize,fmt", EXPORTS)
def test_export_serve_and_score(runs, name, quantize, fmt):
    root, wds = runs
    r = RUNS[name]
    ckdir = str(wds[name] / "checkpoints")
    art = str(root / f"art_{name}_{quantize}_{fmt}")
    pad = tuple(int(v) for v in r["pad"].split(","))
    stats = export_model(r["model"], ckdir, art, batch_size=2, pad_hw=pad, quantize=quantize,
                         input_format=fmt, fold_bn=quantize == "none", device="cpu")
    assert stats["device"] == "cpu"
    sm = ServingModel(art, device="cpu")
    assert sm.selftest() == []
    assert serve_main(["--artifact", art, "--selftest", "--device", "cpu"]) == 0
    assert sm.keys == ((("y", "u", "v") + (("y_t1", "u_t1", "v_t1") if name == "dmds" else ())
                        + ("image_hw",)) if fmt == "yuv420" else
                       ("image", "image_hw") + (("image_t1",) if name == "dmds" else ())) + (
        ("intrinsics",) if name == "3d" else ())
    # The artifact against the eager pipeline of the same posture.
    batch = synthetic_batch(np.random.default_rng(3), 2, pad, num_classes=3,
                            two_frame=name == "dmds", with_3d=name == "3d",
                            yuv420=fmt == "yuv420")
    cfg = load_params_cfg(ckdir, get_model(r["model"]).params_cls)
    tr = Trainer(cfg, "cpu", checkpoint_dir=ckdir)
    tr.init_state()
    kw = dict(fold_bn=True) if quantize == "none" else {}
    model = tr.eval_model(use_ema=cfg.ema_decay > 0.0)
    if quantize == "int8":  # the artifact ships dequantized int8 weights
        from cvm_tpu_torch.infer.quantize import dequantize_params, quantize_params

        params = dict(model.named_parameters())
        deq = dequantize_params(quantize_params(params)[0])
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(deq[n])
    if quantize == "w8a8_fused":
        from cvm_tpu_torch.cli.export import calibration_scales

        kw = dict(w8a8=calibration_scales(cfg, model, pad, 3, 2, torch.device("cpu")),
                  w8a8_fused=True)
    eager = InferencePipeline(cfg, model, "cpu", input_format=fmt, **kw)(batch)
    got = sm.predict_batch(batch)
    assert set(got) == set(eager)
    for k, v in eager.items():
        np.testing.assert_allclose(got[k], v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
    out = root / f"m_{name}_{quantize}_{fmt}.json"
    assert eval_main(["--artifact", art, "--device", "cpu", "--batches", "1", "--json_out",
                      str(out)]) == 0
    m = json.loads(out.read_text())
    assert all(np.isfinite(m[k]) for k in r["evals"])
    meta = json.loads(open(os.path.join(art, "artifact.json")).read())
    assert meta["model"] == r["model"] and meta["selftest"]["outputs"]


def test_cli_benchmark_config_e(monkeypatch, capsys):
    name, cfg, mode = benchmark._configs()["E"]  # the reference's config E
    assert (name, mode, cfg.input_hw, cfg.batch_size, cfg.backbone, cfg.motion_features) == (
        "dmds", "train", (192, 640), 8, "small", 128) and cfg.predict_object_motion
    dmds = get_model("dmds").params_cls
    monkeypatch.setattr(benchmark, "_configs", lambda: {
        "E": ("dmds", dmds(input_hw=(64, 128), backbone="tiny", decoder_features=16,
                           motion_features=32, batch_size=2), "train")})
    assert benchmark.main(["--configs", "E", "--iters", "4", "--device", "cpu"]) == 0
    (line,) = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert line["config"] == "E" and line["model"] == "dmds" and line["mode"] == "train"
    assert line["input_hw"] == [64, 128] and line["device"] == "cpu"
    assert line["steps_per_sec"] > 0 and line["tflops_per_step"] > 0
    assert np.isfinite(line["p50_step_ms_blocked"])
