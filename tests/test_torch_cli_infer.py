"""``cli.infer`` of cvm_tpu_torch against the reference's, on the CPU at a
tiny size (``backbone="tiny"``, 32x32 input, 3 classes), from checkpoints
of the same weights (the reference's orbax checkpoint, and the port's
holding ``convert.convert_variables`` of it).

* ``--checkpoint_dir`` over ``--images`` (JPEGs and a PNG of other sizes,
  the last chunk padded) and over ``--records``, fp, ``--tta hflip`` and
  ``--w8a8`` (scales calibrated on the first batch, the convs on the int8
  path): with ``--score_threshold 0`` every image reports its top-k
  boxes; the JSON lines name the same inputs in the same order, and each
  detection of the reference's that no score difference within 0.01 can
  push out of the top k is the port's too, with the same class, a score
  within 0.01 and a box within 0.5 px (the reference's bf16 head convs
  are not rounded on the CPU, and bf16 ties add neighbouring peaks:
  ``ROADMAP.md``, known differences); under ``--w8a8`` each image's best
  detection (an int8 step of an activation reorders or suppresses the
  lower peaks of this random model's flat heatmap, which are nearly
  tied; ``test_torch_int8.py`` holds the int8 convs themselves), and
  its lines are not the port's own fp lines, so the int8 path ran.
* ``--visualize`` writes one PNG per image at the source image's size.
* ``--artifact``: a ``w8a8_fused_chain`` RGB export of the port's
  checkpoint reports what the eager pipeline of the same posture and
  calibration gives on the same decoded batches.
* The reference's refusals, argv for argv where the reference can run the
  argv (no artifact of the reference's is made here), and the port's own
  for artifacts; ``--tiled`` names its ROADMAP item; the per-model entry
  points pass their model; ``cli.infer`` defaults to the card.
"""

import contextlib
import glob
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvm_tpu.cli.infer import main as ref_main
from cvm_tpu.data.records import RecordWriter
from cvm_tpu.models import get_model
from cvm_tpu.train.loop import Trainer as RefTrainer
from cvm_tpu_torch.cli.infer import main as infer_main
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.data.synthetic import synthetic_sample
from cvm_tpu_torch.models.centernet.params import CenternetParams

from test_torch_export import CFG, write_checkpoint
from test_torch_model import random_bn_stats
from test_torch_records import load_reference_decoder

# Source images: (H, W) within the 48x48 pad, and one PNG.
_SIZES = [(40, 44), (30, 48), (48, 36), (33, 41), (44, 44)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    load_reference_decoder()
    root = tmp_path_factory.mktemp("infer")
    spec = get_model("centernet")
    jp = spec.params_cls(**CFG)
    rt = RefTrainer(spec, jp, checkpoint_dir=str(root / "ref_ck"))
    rt.init_state()
    variables = random_bn_stats({"params": rt.state.params,
                                 "batch_stats": rt.state.batch_stats},
                                np.random.default_rng(31))
    # A sharper heatmap head, so that the top-k scores spread beyond the
    # 0.01 the two sides may differ by and the detections can be matched.
    hm = variables["params"]["hm"]["out"]
    hm["kernel"] = np.asarray(hm["kernel"]) * 6.0
    rt.state = rt.state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                                batch_stats=jax.tree.map(jnp.asarray,
                                                         variables["batch_stats"]))
    rt.ckpt.save(1, rt.state)
    rt.ckpt.wait()
    cfg = CenternetParams(**CFG)
    ckdir = write_checkpoint(root / "ck", cfg, convert_variables(variables))

    rng = np.random.default_rng(5)
    img_dir = root / "images"
    img_dir.mkdir()
    with RecordWriter(str(root / "scenes.cvrec")) as w:
        for i, (h, wd) in enumerate(_SIZES + _SIZES[:3]):
            s = synthetic_sample(rng, (h, wd), num_classes=3, max_objects=4)
            if i < len(_SIZES):
                ext = "png" if i == 3 else "jpg"
                Image.fromarray(s["image"]).save(img_dir / f"im{i}.{ext}", quality=90)
            buf = io.BytesIO()
            Image.fromarray(s["image"]).save(buf, format="JPEG", quality=90)
            w.write({"id": f"r{i}", "height": h, "width": wd, "boxes": [], "classes": []},
                    {"jpeg": buf.getvalue()})
    return dict(root=root, ref_ck=str(root / "ref_ck"), ckdir=ckdir, cfg=cfg,
                images=str(img_dir / "*"), records=str(root / "scenes.cvrec"))


def _run(main, argv):
    """(exit code, JSON lines of stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    return rc, lines, err.getvalue()


def assert_jsonl_close(got, want, top=None):
    """The same inputs in order, with top scores within 0.01; and every
    detection of the reference's that stands more than 0.01 above its
    list's last score (no score difference within the tolerance can push
    it out of the top k) is one of the port's: the same class, its box
    within 0.5 px, its score within 0.01. Ties of the port's bf16 heatmap
    may add a neighbouring peak of the same score (ROADMAP.md, known
    differences: decode ties), so the port's list is not held rank by
    rank. ``top``: only each image's ``top`` best detections are held
    (for W8A8, where one int8 step of an activation may reorder or
    suppress a lower peak that is nearly tied with a neighbour). Returns
    how many detections were matched."""
    assert [g["input"] for g in got] == [w["input"] for w in want]
    matched = 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert abs(g["scores"][0] - w["scores"][0]) <= 0.01, g["input"]
        gs, gc, gb = (np.asarray(g[k]) for k in ("scores", "classes", "boxes"))
        for s, c, box in list(zip(w["scores"], w["classes"], w["boxes"]))[:top]:
            if s <= w["scores"][-1] + 0.01:
                continue
            hit = (gc == c) & (np.abs(gs - s) <= 0.01) & \
                (np.abs(gb - np.asarray(box)).max(1) <= 0.5)
            assert hit.any(), (g["input"], s, c, box)
            matched += 1
    return matched


@pytest.mark.parametrize("source,extra", [
    ("images", []), ("records", []), ("images", ["--tta", "hflip"]),
    ("images", ["--w8a8"])])
def test_checkpoint_jsonl_is_the_references(setup, source, extra):
    common = [f"--{source}", setup[source], "--model", "centernet", "--batch_size", "4",
              "--score_threshold", "0"] + extra
    ref = _run(ref_main, common + ["--checkpoint_dir", setup["ref_ck"]])
    got = _run(infer_main, common + ["--checkpoint_dir", setup["ckdir"], "--device", "cpu"])
    assert got[0] == ref[0] == 0
    if "--w8a8" in extra:  # the calibration line, then the images
        assert got[1][0] == ref[1][0] == {"w8a8_calibrated_convs": 29}
        got, ref = (got[0], got[1][1:]), (ref[0], ref[1][1:])
    assert len(got[1]) == (5 if source == "images" else 8)  # ragged tail padded / dropped
    assert all(len(g["scores"]) == CFG["top_k"] for g in got[1])
    top = 1 if "--w8a8" in extra else None
    assert assert_jsonl_close(got[1], ref[1], top) >= len(got[1])
    if "--w8a8" in extra:  # the int8 path ran: its lines are not the fp pipeline's
        fp = _run(infer_main, common[:-1] + ["--checkpoint_dir", setup["ckdir"],
                                             "--device", "cpu"])
        assert fp[0] == 0 and [g["input"] for g in fp[1]] == [g["input"] for g in got[1]]
        assert any(f["scores"] != g["scores"] for f, g in zip(fp[1], got[1]))


def test_visualize_writes_one_png_per_image_at_its_size(setup, tmp_path):
    out = tmp_path / "vis"
    rc, lines, err = _run(infer_main, ["--images", setup["images"], "--checkpoint_dir",
                                       setup["ckdir"], "--model", "centernet", "--batch_size",
                                       "4", "--visualize", str(out), "--device", "cpu",
                                       "--max_batches", "1"])
    assert rc == 0 and len(lines) == 4
    assert json.loads(err.splitlines()[-1])["batches"] == 1
    for i, (h, w) in enumerate(_SIZES[:4]):
        ext = "png" if i == 3 else "jpg"
        assert Image.open(out / f"im{i}.{ext}.png").size == (w, h)
    assert len(os.listdir(out)) == 4


@pytest.fixture(scope="module")
def artifact(setup):
    """A ``w8a8_fused_chain`` RGB export (batch 4, 48x48) of the port's
    checkpoint."""
    from cvm_tpu_torch.cli.export import main as export_main

    art = str(setup["root"] / "art")
    assert export_main(["--model", "centernet", "--checkpoint_dir", setup["ckdir"], "--out",
                        art, "--quantize", "w8a8_fused_chain", "--input_format", "rgb",
                        "--batch_size", "4", "--pad_hw", "48,48", "--device", "cpu"]) == 0
    return art


def test_artifact_reports_what_the_eager_pipeline_gives(setup, artifact):
    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.data.images import read_image_as_jpeg
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.train.loop import Trainer

    art = artifact
    rc, lines, _ = _run(infer_main, ["--artifact", art, "--images", setup["images"],
                                     "--score_threshold", "0", "--device", "cpu"])
    assert rc == 0 and len(lines) == 5
    tr = Trainer(setup["cfg"], "cpu", checkpoint_dir=setup["ckdir"])
    tr.init_state()
    model = tr.eval_model()
    eager = InferencePipeline(setup["cfg"].replace(batch_size=4), model, "cpu",
                              input_format="rgb", w8a8_fused=True, w8a8_chain=True,
                              w8a8=calibration_scales(setup["cfg"], model, (48, 48), 3, 4,
                                                      "cpu"))
    files = sorted(__import__("glob").glob(setup["images"]))
    for s in (0, 4):
        jpegs = [read_image_as_jpeg(f)[0] for f in files[s:s + 4]]
        img, hw = decode_jpeg_batch(jpegs + [jpegs[-1]] * (4 - len(jpegs)), 48, 48)
        out = {k: v.numpy() for k, v in eager({"image": img, "image_hw": hw}).items()}
        for i, line in enumerate(lines[s:s + 4]):
            assert line["input"] == os.path.basename(files[s + i])
            for k in ("boxes", "scores", "classes"):
                np.testing.assert_allclose(line[k], out[k][i], rtol=1e-5, atol=1e-5)


def test_predict_batch_gives_a_3d_artifact_placeholder_intrinsics():
    """A 3D artifact's batch without intrinsics (bare image files) gets the
    identity camera [1, 1, 0, 0], as the reference's ``predict_batch``."""
    from cvm_tpu_torch.infer.runtime import ServingModel

    class Echo(ServingModel):
        def __init__(self):
            self.keys = ("image", "image_hw", "intrinsics")

        def __call__(self, *data):
            return {"intrinsics": torch.from_numpy(data[2])}

    batch = {"image": np.zeros((3, 8, 8, 3), np.uint8), "image_hw": np.full((3, 2), 8)}
    np.testing.assert_array_equal(Echo().predict_batch(batch)["intrinsics"],
                                  np.tile(np.float32([[1, 1, 0, 0]]), (3, 1)))
    given = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        Echo().predict_batch(dict(batch, intrinsics=given))["intrinsics"], given)


@pytest.mark.parametrize("argv", [
    ["--images", "X"],
    ["--images", "X", "--artifact", "A", "--checkpoint_dir", "C"],
    ["--images", "X", "--checkpoint_dir", "C"],
    ["--images", "X", "--artifact", "A", "--w8a8"],
    ["--images", "X", "--artifact", "A", "--tta", "hflip"],
    ["--images", "X", "--artifact", "A", "--tiled"],
    ["--images", "X", "--checkpoint_dir", "{ck}", "--model", "centernet", "--tiled"],
    ["--records", "R", "--checkpoint_dir", "{ck}", "--model", "centernet", "--tiled"],
    ["--checkpoint_dir", "{ck}", "--model", "centernet"]])
def test_refusals_are_the_references(setup, argv):
    ref = _run(ref_main, [a.format(ck=setup["ref_ck"]) for a in argv])
    got = _run(infer_main, [a.format(ck=setup["ckdir"]) for a in argv] + ["--device", "cpu"])
    assert got[0] == ref[0] == 2
    assert got[2].splitlines()[-1] == ref[2].splitlines()[-1]


def test_artifact_refusals_and_tiled(setup, artifact, tmp_path):
    art = artifact
    base = ["--images", setup["images"], "--device", "cpu"]
    for change, message in (({"input_format": "yuv420"}, "cli.infer serves rgb artifacts"),
                            ({"model": "dmds"}, "two-frame dmds artifacts stream")):
        bad = str(tmp_path / next(iter(change.values())))
        shutil.copytree(art, bad)
        meta = json.load(open(os.path.join(bad, "artifact.json")))
        meta.update(change)
        json.dump(meta, open(os.path.join(bad, "artifact.json"), "w"))
        rc, _, err = _run(infer_main, base + ["--artifact", bad])
        assert rc == 2 and message in err
    rc, _, err = _run(infer_main, base + ["--artifact", art, "--model", "semseg"])
    assert rc == 2 and "--model semseg but the artifact is a 'centernet' export" in err

    from cvm_tpu_torch.models.semseg.params import SemsegParams
    from cvm_tpu_torch.train.loop import Trainer

    cfg = SemsegParams(input_hw=(32, 32), backbone="tiny", decoder_features=8, batch_size=2)
    tr = Trainer(cfg, "cpu", checkpoint_dir=str(tmp_path / "sem"))
    tr.init_state()
    tr.ckpt.save(1, tr.checkpoint_state(None))
    tr.ckpt.wait()  # the write is asynchronous
    # --tiled runs now: one line per image at its own size (the held
    # stitching is tests/test_torch_tiled.py)
    rc, lines, err = _run(infer_main, base + ["--checkpoint_dir", str(tmp_path / "sem"),
                                              "--model", "semseg", "--tiled",
                                              "--visualize", str(tmp_path / "vis")])
    assert rc == 0, err
    files = sorted(glob.glob(setup["images"]))
    assert [r["input"] for r in lines] == [os.path.basename(f) for f in files]
    for r, f in zip(lines, files):
        w, h = Image.open(f).size
        assert r["hw"] == [h, w] and sum(r["class_histogram"]) == h * w
        assert os.path.exists(os.path.join(tmp_path / "vis", r["input"] + ".classes.png"))


def test_per_model_entry_points_and_the_card_default(setup, monkeypatch):
    import importlib

    from cvm_tpu_torch.models.centernet import inference as cn
    from cvm_tpu_torch.models.dmds import inference as dmds

    rc, lines, _ = _run(cn.main, ["--checkpoint_dir", setup["ckdir"], "--images",
                                  setup["images"], "--device", "cpu", "--max_batches", "1"])
    assert rc == 0 and len(lines) == 5
    rc, _, err = _run(dmds.main, ["--images", "X", "--artifact", "A", "--w8a8"])
    assert rc == 2 and "--w8a8 is baked at export time" in err
    for model in ("centernet", "semseg", "depth", "multitask", "dmds"):
        for part in ("inference", "train", "evaluate"):
            mod = importlib.import_module(f"cvm_tpu_torch.models.{model}.{part}")
            monkeypatch.setattr(mod, "_main", lambda argv: argv)
            assert mod.main(["--x", "1"]) == ["--model", model, "--x", "1"]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_main(["--checkpoint_dir", setup["ckdir"], "--model", "centernet", "--images",
                    setup["images"]])
