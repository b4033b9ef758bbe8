"""Sharded serving and evaluation of cvm_tpu_torch (``InferencePipeline(
mesh=)``, ``evaluate_model(mesh=)``, ``cli.evaluate / infer / video
--coordinator``, the in-training eval) against the reference's sharded
pipeline on the conftest's 8-device CPU mesh and against one process, at a
tiny size (``backbone="tiny"``, 32x32 CenterNet, 64x128 semseg); the
port's ranks are gloo children of ``tests/torch_dist_child.py`` or of the
CLIs.

* ``InferencePipeline(mesh=)`` on a batch of 3 (padded to the data ranks
  and sliced back) over (data 2) in fp from planar YUV420, and over (data
  1, model 2) with ``tensor_parallel`` in fp with BN folded from RGB (the
  stage-5 convs served split) and in static W8A8 (whole weights, as the
  reference's GSPMD gives): against the reference's pipeline on meshes of
  the same shapes with tie-robust matching (``assert_jsonl_close``: scores
  0.01, boxes 0.5 px; W8A8 each image's best detection), and over a data
  axis equal to one process's exactly.
* Every model of the zoo in every posture of the one-card pipeline
  (hflip, dynamic, static and fused W8A8, a QAT model's fake quant, the 3D
  heads, BN folded, DMDS in fp; YUV420 and RGB) over a data axis of 2
  equals one process exactly: dynamic activation scales are maxima over
  the global batch, as the reference's GSPMD takes them.
* ``evaluate_model(mesh=)`` over 2 ranks: CenterNet's and semseg's metrics
  equal one process's exactly and the reference's sharded evaluation's
  within 0.03 (mAP, mIoU, pixel accuracy).
* ``cli.evaluate``, ``cli.infer`` (images, the last chunk padded) and
  ``cli.video`` over two processes: rank 0's JSON / JSONL byte-equal to one
  process's, rank 1 silent; ``cli.infer --tiled`` refuses ranks.
* ``cli.train`` over two processes with ``--eval_every``: each eval's
  ``val_*`` equal ``cli.evaluate``'s in one process on the same checkpoint.
"""

import contextlib
import functools
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_dist_child as child
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline
from cvm_tpu.infer.quantize import calibrate_activation_scales as j_calibrate
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.parallel.mesh import make_mesh as j_make_mesh
from cvm_tpu.pipeline.preprocess import preprocess_batch as j_preprocess_batch
from cvm_tpu.train.evaluate import evaluate_model as j_evaluate_model
from cvm_tpu_torch.cli.evaluate import main as eval_main
from cvm_tpu_torch.cli.infer import main as infer_main
from cvm_tpu_torch.convert import convert_scales, convert_variables
from cvm_tpu_torch.data.synthetic import synthetic_batch
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.parallel.mesh import launch_ranks

from test_torch_cli_infer import assert_jsonl_close
from test_torch_export import CFG, write_checkpoint
from test_torch_model import random_bn_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = (48, 48)
DET = dict(CFG, batch_size=4)
SEG = dict(input_hw=(64, 128), backbone="tiny", decoder_features=16, batch_size=4)


def _variables(name, fields, seed):
    """The reference's variables of a tiny model (random BatchNorm
    statistics; CenterNet's heatmap head sharpened, as
    ``test_torch_cli_infer.py`` does, so that top-k scores spread)."""
    spec = j_get_model(name)
    jm = spec.create_model(spec.params_cls(**fields))
    hw = fields["input_hw"]
    init = jax.jit(functools.partial(jm.init, train=False))  # eager init is slower
    variables = random_bn_stats(init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3))),
                                np.random.default_rng(seed))
    if name == "centernet":
        hm = variables["params"]["hm"]["out"]
        hm["kernel"] = np.asarray(hm["kernel"]) * 6.0
    return variables


@pytest.fixture(scope="module")
def det():
    rng = np.random.default_rng(7)
    ph, pw = PAD
    batch = {"y": rng.integers(0, 255, (3, ph, pw), dtype=np.uint8),
             "u": rng.integers(0, 255, (3, ph // 2, pw // 2), dtype=np.uint8),
             "v": rng.integers(0, 255, (3, ph // 2, pw // 2), dtype=np.uint8),
             "image": synthetic_batch(rng, 3, PAD, num_classes=3)["image"],
             "image_hw": np.asarray([[48, 48], [40, 44], [30, 48]], np.int32)}
    return _variables("centernet", DET, 0), batch


def _records(out):
    """Batch outputs -> ``assert_jsonl_close``'s records (every detection)."""
    return [{"input": str(i), **{k: np.asarray(out[k][i]).tolist()
                                  for k in ("boxes", "scores", "classes")}}
            for i in range(len(out["scores"]))]


def _npz(path, name, cfg, sd, **arrays):
    np.savez(path, name=json.dumps(name), cfg=cfg.to_json(),
             **{f"sd/{k}": v.numpy() for k, v in sd.items()}, **arrays)


# (mesh (data, model), pipeline options): against the reference's pipeline
LAYOUTS = {
    "data2-fp-yuv420": ((2, 1), dict(input_format="yuv420")),
    "model2-tp-fold_bn-rgb": ((1, 2), dict(input_format="rgb", fold_bn=True)),
    "model2-tp-w8a8_static": ((1, 2), dict(input_format="rgb", w8a8="scales")),
}


def _tiny(name):
    return dict(child.CONFIGS["tiny"][name][0], batch_size=4)


# id -> (model, params, pipeline options): every model of the zoo and every
# posture the one-card pipeline serves, both input formats, over a data axis
POSTURES = {
    "centernet-hflip-rgb": ("centernet", DET, dict(input_format="rgb", tta="hflip")),
    "centernet-w8a8-yuv420": ("centernet", DET, dict(input_format="yuv420", w8a8=True)),
    "centernet-w8a8_fused_chain-rgb": ("centernet", DET, dict(
        input_format="rgb", w8a8="scales", w8a8_fused=True, w8a8_chain=True)),
    "centernet-qat-rgb": ("centernet", dict(DET, qat=True), dict(input_format="rgb")),
    "centernet3d-yuv420": ("centernet", dict(DET, with_3d=True),
                           dict(input_format="yuv420")),
    "semseg-fold_bn-rgb": ("semseg", SEG, dict(input_format="rgb", fold_bn=True)),
    "depth-yuv420": ("depth", _tiny("depth"), dict(input_format="yuv420")),
    "multitask-w8a8_static-rgb": ("multitask", _tiny("multitask"),
                                  dict(input_format="rgb", w8a8="scales")),
    "dmds-yuv420": ("dmds", _tiny("dmds"), dict(input_format="yuv420")),
}


def _reference_scales(variables, batch):
    """The reference's calibration of the tiny CenterNet on ``batch``."""
    spec = j_get_model("centernet")
    proc, _ = j_preprocess_batch(None, {k: jnp.asarray(batch[k]) for k in ("image", "image_hw")},
                                 DET["input_hw"], train=False)
    jm = spec.create_model(spec.params_cls(**DET))
    return j_calibrate(lambda x: jm.apply(variables, x, train=False), [proc])


EVAL = {"centernet": (DET, PAD), "semseg": (SEG, (80, 160))}


@pytest.fixture(scope="module")
def eval_variables(det):
    """The reference's variables of each ``EVAL`` model (CenterNet's
    ``det``'s)."""
    return {"centernet": det[0], "semseg": _variables("semseg", SEG, 1)}


@pytest.fixture(scope="module")
def served(det, eval_variables, tmp_path_factory):
    """Every ``LAYOUTS`` case (the reference's weights) and ``POSTURES``
    case (seeded weights) served, and every ``EVAL`` model evaluated
    (``evaluate_model(mesh=)``, case ``eval-<name>``), by two ranks in one
    launch: {case: (IN, [(rank's JSON result, its outputs)])}."""
    from cvm_tpu_torch.cli.export import calibration_scales

    root = tmp_path_factory.mktemp("served")
    variables, batch = det
    cases = []  # (case, IN)
    for case, ((_, model), opts) in LAYOUTS.items():
        cfg = get_model("centernet").params_cls(**DET, tensor_parallel=model > 1)
        scales = (convert_scales(_reference_scales(variables, batch))
                  if opts.get("w8a8") == "scales" else {})
        cases.append((case, str(root / f"{case}.npz")))
        _npz(cases[-1][1], "centernet", cfg, convert_variables(variables),
             opts=json.dumps(opts), scales=json.dumps(scales), model_parallel=model,
             **{f"b/{k}": v for k, v in batch.items()})
    for i, (case, (name, fields, opts)) in enumerate(sorted(POSTURES.items())):
        spec = get_model(name)
        cfg = spec.params_cls(**fields)
        model = spec.create_model(cfg, "cpu", torch.Generator().manual_seed(i))
        pad = (48, 48) if name == "centernet" else (80, 160)
        scales = (calibration_scales(cfg, model, pad, 1, 4, "cpu")
                  if opts.get("w8a8") == "scales" else {})
        rows = synthetic_batch(np.random.default_rng(i), 3, pad, num_classes=3,
                               two_frame=name == "dmds", with_3d=cfg.name == "centernet"
                               and cfg.with_3d, yuv420=opts["input_format"] == "yuv420")
        cases.append((case, str(root / f"{case}.npz")))
        _npz(cases[-1][1], name, cfg, model.state_dict(), opts=json.dumps(opts),
             scales=json.dumps(scales), **{f"b/{k}": v for k, v in rows.items()})
    for name, (fields, pad) in sorted(EVAL.items()):
        cases.append((f"eval-{name}", str(root / f"eval-{name}.npz")))
        _npz(cases[-1][1], name, get_model(name).params_cls(**fields),
             convert_variables(eval_variables[name]), opts=json.dumps({}), pad=pad,
             batches=2, mode="evaluate")
    ranks = child.launch(2, ["serve", "--npz", ",".join(p for _, p in cases)],
                         str(root / "r"))
    return {case: (path, [(res["results"][i], {k[len(f"{i}/"):]: v for k, v in arrays.items()
                                               if k.startswith(f"{i}/")})
                          for res, arrays in ranks])
            for i, (case, path) in enumerate(cases)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_pipeline_matches_reference_and_one_process(layout, det, served):
    (_, model), opts = LAYOUTS[layout]
    variables, batch = det
    tp = model > 1
    spec = j_get_model("centernet")
    jopts = dict(opts)
    if opts.get("w8a8") == "scales":
        jopts["w8a8"] = _reference_scales(variables, batch)
    mesh = j_make_mesh(jax.devices()[:2], model_axis=model)
    want = {k: np.asarray(v) for k, v in JPipeline(
        spec, spec.params_cls(**DET, tensor_parallel=tp), variables, mesh=mesh,
        **jopts)(batch).items()}
    path, ranks = served[layout]
    one, mine = child.run_serve(None, "cpu", path)
    top = 1 if "w8a8" in opts else None
    for res, got in ranks:
        assert res["tensor_parallel"] == (tp and "w8a8" not in opts)
        assert got["boxes"].shape == (3, DET["top_k"], 4)  # 3 rows padded to 4, sliced
        assert_jsonl_close(_records(got), _records(want), top=top)
        if not tp:
            for k in want:
                np.testing.assert_array_equal(got[k], mine[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(POSTURES))
def test_every_model_and_posture_over_two_ranks_equals_one_process(case, served):
    """Each data rank predicts its rows of a batch of 3 (padded to 4); the
    gathered results equal one process's exactly. Dynamic activation
    scales (``w8a8=True``, a QAT model's fake quant) are maxima over the
    whole batch on both ranks, as the reference's GSPMD takes them."""
    path, ranks = served[case]
    want = child.run_serve(None, "cpu", path)[1]
    for _, got in ranks:
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape[0] == 3
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dynamic_scales_take_the_max_over_the_global_batch():
    """A rank's dynamic activation scale (``Int8Conv``, QAT's
    ``fake_quant_act``, the train step's too) is its reducer's max over the
    global batch: with a reducer standing in for a data group whose other
    rank holds the batch's max, a rank's rows quantize as they do within
    the whole batch."""
    from cvm_tpu_torch.infer.quantize import Int8Conv
    from cvm_tpu_torch.models.layers import Conv
    from cvm_tpu_torch.parallel.reduce import BatchReducer
    from cvm_tpu_torch.train.qat import fake_quant_act

    whole = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 6, 6, 8))
                             .astype(np.float32))
    whole[2:] *= 50.0

    class OtherRankHoldsTheMax(BatchReducer):
        def max(self, x):
            return torch.amax(whole.abs())

    red = OtherRankHoldsTheMax()
    torch.testing.assert_close(fake_quant_act(whole[:2], red), fake_quant_act(whole)[:2],
                               rtol=0, atol=0)
    conv = Int8Conv(Conv(8, 4, 3, dtype=torch.float32), None)
    want = conv(whole)[:2]
    conv.reducer = red
    torch.testing.assert_close(conv(whole[:2]), want, rtol=0, atol=0)
    assert not torch.equal(fake_quant_act(whole[:2]), fake_quant_act(whole)[:2])


@pytest.mark.parametrize("name", sorted(EVAL))
def test_evaluate_model_over_ranks(name, eval_variables, served):
    fields, pad = EVAL[name]
    variables = eval_variables[name]
    path, ranks = served[f"eval-{name}"]
    ranks = [res["metrics"] for res, _ in ranks]
    one, _ = child.run_evaluate(None, "cpu", path)
    rng = np.random.default_rng(999)
    val = [synthetic_batch(rng, 4, pad, num_classes=3) for _ in range(2)]
    spec = j_get_model(name)
    want = j_evaluate_model(spec, spec.params_cls(**fields), variables, val,
                            mesh=j_make_mesh(jax.devices()[:2]))
    assert ranks == [one["metrics"]] * 2
    for k in ("mAP", "mAP50") if name == "centernet" else ("miou", "pixel_acc"):
        assert abs(one["metrics"][k] - want[k]) <= 0.03, (k, one["metrics"][k], want[k])


@pytest.fixture(scope="module")
def ckpt(det, tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_serve")
    cfg = get_model("centernet").params_cls(**DET)
    ckdir = write_checkpoint(root / "ck", cfg, convert_variables(det[0]))
    rng = np.random.default_rng(3)
    (root / "images").mkdir()
    for i in range(5):  # the last chunk of 4 padded
        img = synthetic_batch(rng, 1, (40 + i, 44), num_classes=3)["image"][0]
        Image.fromarray(img).save(root / "images" / f"im{i}.jpg", quality=90)
    return root, ckdir


def _ranks(module, argv):
    """Two processes of ``python -m module argv --coordinator ...``."""
    return launch_ranks(2, lambda r, port: [
        sys.executable, "-m", module, *argv, "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(r)], 300, cwd=REPO)


def _one(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_cli_evaluate_and_infer_over_two_processes_equal_one(ckpt, tmp_path):
    root, ckdir = ckpt
    ev = ["--model", "centernet", "--checkpoint_dir", ckdir, "--device", "cpu",
          "--pad_hw", "48,48", "--batches", "2", "--size_ap"]
    two = _ranks("cvm_tpu_torch.cli.evaluate", ev + ["--json_out", str(tmp_path / "2.json")])
    one = _one(eval_main, ev + ["--json_out", str(tmp_path / "1.json")])
    assert two[0] == one and two[1] == "" and "mAP" in one
    assert (tmp_path / "2.json").read_bytes() == (tmp_path / "1.json").read_bytes()

    inf = ["--model", "centernet", "--checkpoint_dir", ckdir, "--device", "cpu",
           "--images", str(root / "images" / "*.jpg"), "--batch_size", "4",
           "--score_threshold", "0"]
    two = _ranks("cvm_tpu_torch.cli.infer", inf)
    one = _one(infer_main, inf)
    assert two[0] == one and two[1] == "" and len(one.splitlines()) == 5
    with pytest.raises(SystemExit):
        infer_main(inf + ["--tiled", "--coordinator", "127.0.0.1:1", "--num_processes", "2",
                          "--process_id", "0"])


def test_cli_video_over_two_processes_equals_one(ckpt, tmp_path):
    pytest.importorskip("cv2")
    from cvm_tpu_torch.cli.video import main as video_main
    from test_torch_video import write_clip

    _, ckdir = ckpt
    clip = str(tmp_path / "clip.mp4")
    write_clip(clip, n=6, hw=(40, 48))
    argv = ["--model", "centernet", "--checkpoint_dir", ckdir, "--device", "cpu", "--video",
            clip, "--batch_size", "4", "--score_threshold", "0"]
    two = _ranks("cvm_tpu_torch.cli.video", argv + ["--jsonl", str(tmp_path / "2.jsonl")])
    _one(video_main, argv + ["--jsonl", str(tmp_path / "1.jsonl")])
    assert two[1] == "" and '"frames": 6' in two[0]
    assert (tmp_path / "2.jsonl").read_bytes() == (tmp_path / "1.jsonl").read_bytes()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli.train`` over two ranks, 4 steps with an eval every 2 and
    ``--keep_best``; rank 0's first best write sleeps 6 s, past the
    group's collective timeout of 4 s, and rank 1 reaches each of rank 0's
    eval writes 1.5 s late: (workdir, each rank's result)."""
    root = tmp_path_factory.mktemp("trained")
    work = str(root / "w")
    tiny = ["--model", "centernet", "--data", "synthetic", "--device", "cpu", "--pad_hw",
            "80,96", "--input_hw", "64,64", "--backbone", "tiny", "--neck_features", "32",
            "--head_features", "16", "--num_classes", "3", "--batch_size", "4",
            "--warmup_steps", "2", "--log_every", "1", "--workdir", work, "--steps", "4",
            "--checkpoint_every", "4", "--eval_every", "2", "--eval_batches", "2",
            "--keep_best", "mAP"]
    ranks = child.launch(2, ["cli", "--module", "cvm_tpu_torch.cli.train", "--argv",
                             json.dumps(tiny), "--timeout", 4, "--slow_best", 6,
                             "--late_best", 1.5],
                         str(root / "r"))
    return work, [res for res, _ in ranks]


def test_in_training_eval_over_ranks_is_cli_evaluates(trained):
    work, (r0, r1) = trained
    assert [r0["rc"], r1["rc"]] == [0, 0]
    assert r0["stdout"].count("eval@2") == r0["stdout"].count("eval@4") == 1
    assert r1["stdout"] == ""
    rows = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    val = {k[4:]: v for r in rows for k, v in r.items() if k.startswith("val_")}
    one = _one(eval_main, ["--model", "centernet", "--workdir", work, "--device", "cpu",
                           "--pad_hw", "80,96", "--batches", "2"])
    assert json.loads(one.split(": ", 1)[1]) == val


def test_rank0_best_write_outlasts_the_collective_timeout(trained):
    """Rank 0 keeps the best checkpoint while the other ranks wait on the
    store, not in a collective: a write longer than the collective timeout
    fails no rank."""
    work, (r0, r1) = trained
    assert [r0["rc"], r1["rc"]] == [0, 0]
    assert "new best mAP" in r0["stdout"]
    with open(os.path.join(work, "best", "best.json")) as f:
        assert json.load(f)["metric"] == "mAP"


def test_rank0_outlives_a_late_rank(trained):
    """The last eval's write is the run's last use of rank 0's store: rank
    0 waits for the other ranks before it leaves, so a rank that reaches
    that wait late still reads it."""
    _, ranks = trained
    assert [r["rc"] for r in ranks] == [0, 0]
