"""``cli.export``, ``cli.serve --selftest`` and ``cli.evaluate --artifact`` of
cvm_tpu_torch on the CPU at a tiny size (``backbone="tiny"``, 32x32 input,
batch 2), from a checkpoint of converted reference weights.

* ``cli.export`` defaults ``--fold_bn`` to on for ``--quantize none`` only;
  a 2-bucket artifact serves batches of 1, 2 and 3 (the last in chunks) as
  the eager pipeline does (within 1e-5; the buckets are programs of their
  own); a re-export into the same directory drops the stale buckets.
* A ``DynamicBatcher`` over the bucketed ``ServingModel`` answers
  threaded single-image requests as the direct call does.
* ``cli.serve --selftest`` exits 0 on an artifact and 3 when a tensor of
  its ``weights.npz`` is altered; ``--images`` over no file prints
  nothing, and no mode at all is refused.
* ``cli.evaluate --artifact`` scores what the direct eval of the same
  posture scores on the same scenes (the same calibration recipe), and
  refuses flags that the export has fixed.
* The K2 op's fake implementation gives each mode's output shape and
  dtype; export keeps the reference's refusals for dmds (the W8A8
  postures) and ``with_3d`` (hflip TTA), and refuses an unknown posture.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.models import get_model
from cvm_tpu_torch.cli.evaluate import main as eval_main
from cvm_tpu_torch.cli.export import export_model
from cvm_tpu_torch.cli.export import main as export_main
from cvm_tpu_torch.cli.serve import main as serve_main
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.runtime import ServingModel
from cvm_tpu_torch.models import get_model as get_model_t
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.train.loop import Trainer

from test_torch_export import CFG, PAD, write_checkpoint
from test_torch_model import random_bn_stats


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jp = get_model("centernet").params_cls(**CFG)
    variables = random_bn_stats(
        get_model("centernet").create_model(jp).init(
            jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)), train=False),
        np.random.default_rng(22))
    cfg = CenternetParams(**CFG)
    root = tmp_path_factory.mktemp("export_cli")
    ckdir = write_checkpoint(root / "ck", cfg, convert_variables(variables))
    arts = {"none": str(root / "art_none"), "chain": str(root / "art_chain")}
    common = ["--model", "centernet", "--checkpoint_dir", ckdir, "--pad_hw", "48,48",
              "--device", "cpu"]
    assert export_main(common + ["--out", arts["none"], "--batch_sizes", "1,2"]) == 0
    assert export_main(common + ["--out", arts["chain"], "--batch_size", "2", "--quantize",
                                 "w8a8_fused_chain", "--input_format", "yuv420"]) == 0
    tr = Trainer(cfg, "cpu", checkpoint_dir=ckdir)
    tr.init_state()
    return dict(cfg=cfg, ckdir=ckdir, arts=arts, model=tr.eval_model(), root=root)


def test_cli_export_defaults_and_buckets(setup):
    art = setup["arts"]["none"]
    meta = json.loads(open(os.path.join(art, "artifact.json")).read())
    chain = json.loads(open(os.path.join(setup["arts"]["chain"], "artifact.json")).read())
    assert meta["fold_bn"] and not chain["fold_bn"]  # --fold_bn: on for none only
    assert meta["batch_sizes"] == [1, 2] and meta["batch_size"] == 2
    sm = ServingModel(art, device="cpu")
    assert sm.bucket_sizes == [1, 2] and sm.selftest() == []
    eager = InferencePipeline(setup["cfg"], setup["model"], "cpu", input_format="rgb",
                              fold_bn=True)
    b = synthetic_batch(np.random.default_rng(7), 3, PAD)
    batch = {k: b[k] for k in ("image", "image_hw")}
    want = eager({k: v[:2] for k, v in batch.items()})
    want3 = eager({k: v[2:] for k, v in batch.items()})
    for n in (1, 2, 3):
        out = sm.predict_batch({k: v[:n] for k, v in batch.items()})
        assert out["boxes"].shape == (n, CFG["top_k"], 4)
        for k in ("boxes", "scores", "classes"):
            ref = np.concatenate([want[k].numpy(), want3[k].numpy()])[:n]
            np.testing.assert_allclose(out[k], ref, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{k} at batch {n}")


def test_dynamic_batcher_serves_the_bucketed_artifact(setup):
    import threading

    from cvm_tpu_torch.infer.server import DynamicBatcher

    sm = ServingModel(setup["arts"]["none"], device="cpu")
    b = synthetic_batch(np.random.default_rng(8), 3, PAD)
    keys = ("image", "image_hw")
    direct = sm.predict_batch({k: b[k] for k in keys})
    batcher = DynamicBatcher(sm, batch_size=2, max_wait_ms=50, bucket_sizes=sm.bucket_sizes)
    results = [None] * 3

    def client(i):
        results[i] = batcher.submit([b[k][i:i + 1] for k in keys])

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        batcher.close()
    for i, r in enumerate(results):
        np.testing.assert_allclose(r["scores"][0], direct["scores"][i], atol=1e-5)
    assert batcher.stats()["requests"] == 3


def test_reexport_drops_stale_buckets(setup, tmp_path):
    art = str(tmp_path / "art")
    shutil.copytree(setup["arts"]["none"], art)
    export_model("centernet", setup["ckdir"], art, batch_size=2, pad_hw=PAD, fold_bn=True,
                 device="cpu")
    assert not [f for f in os.listdir(art) if f.startswith("model_b")]
    assert ServingModel(art, device="cpu").bucket_sizes == [2]


def test_serve_selftest_exits_3_on_tampered_weights(setup, tmp_path, capsys):
    art = setup["arts"]["chain"]
    assert serve_main(["--artifact", art, "--selftest", "--device", "cpu"]) == 0
    bad = str(tmp_path / "bad")
    shutil.copytree(art, bad)
    with np.load(os.path.join(bad, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    key = "hm.out.bias"
    assert key in flat
    flat[key] = flat[key] + 1.0
    np.savez(os.path.join(bad, "weights.npz"), **flat)
    assert serve_main(["--artifact", bad, "--selftest", "--device", "cpu"]) == 3
    assert "MISMATCH" in capsys.readouterr().err
    capsys.readouterr()
    assert serve_main(["--artifact", art, "--images", str(tmp_path / "none" / "*.jpg"),
                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit) as e:
        serve_main(["--artifact", art, "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("posture", ["none", "chain"])
def test_evaluate_artifact_equals_the_direct_eval(setup, tmp_path, posture):
    art = setup["arts"][posture]
    a, d = tmp_path / "a.json", tmp_path / "d.json"
    assert eval_main(["--artifact", art, "--batches", "2", "--device", "cpu",
                      "--json_out", str(a)]) == 0
    flags = ["--fold_bn"] if posture == "none" else ["--quantize", "w8a8_fused_chain"]
    assert eval_main(["--model", "centernet", "--checkpoint_dir", setup["ckdir"],
                      "--pad_hw", "48,48", "--batches", "2", "--device", "cpu",
                      "--json_out", str(d)] + flags) == 0
    ma, md = json.loads(a.read_text()), json.loads(d.read_text())
    assert ma["artifact"] == art and ma["step"] == -1
    for k in ("mAP", "mAP50", "mAP75"):
        assert abs(ma[k] - md[k]) <= 1e-6, k


@pytest.mark.parametrize("extra", [["--tta", "hflip"], ["--fold_bn"], ["--average_last", "2"],
                                   ["--pad_hw", "64,64"], ["--model", "semseg"],
                                   ["--num_classes", "5"]])
def test_evaluate_artifact_refuses_what_the_export_fixed(setup, extra):
    with pytest.raises(SystemExit) as e:
        eval_main(["--artifact", setup["arts"]["none"], "--device", "cpu"] + extra)
    assert e.value.code == 2


@pytest.mark.parametrize("mode", ["bf16", "f32", "int8_out", "int8_in"])
def test_fused_qconv_fake_shapes(mode):
    from torch._subclasses.fake_tensor import FakeTensorMode

    out_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "int8_out": torch.int8,
                 "int8_in": torch.bfloat16}[mode]
    inv_sx = None if mode == "int8_in" else 2.0
    with FakeTensorMode():
        x = torch.empty(2, 5, 7, 24, dtype=torch.int8 if mode == "int8_in" else torch.bfloat16)
        w = torch.empty(3, 3, 24, 40, dtype=torch.int8)
        s = torch.empty(40)
        y = torch.ops.cvm_tpu_torch.fused_qconv(x, w, s, s, None, inv_sx, "silu", out_dtype,
                                                3.0 if mode == "int8_out" else None)
        assert y.shape == (2, 5, 7, 40) and y.dtype == out_dtype
        with pytest.raises(ValueError, match="inv_s_out"):
            torch.ops.cvm_tpu_torch.fused_qconv(x, w, s, s, None, inv_sx, "silu", torch.int8,
                                                None)


def test_export_refuses_dmds_and_3d(setup, tmp_path):
    for q in ("w8a8", "w8a8_fused", "w8a8_fused_chain"):
        with pytest.raises(ValueError, match="not supported for two-frame dmds"):
            export_model("dmds", setup["ckdir"], str(tmp_path / "a"), quantize=q,
                         device="cpu")
    cfg3d = setup["cfg"].replace(with_3d=True)
    ck3d = write_checkpoint(tmp_path / "ck3d", cfg3d,
                            get_model_t("centernet").create_model(cfg3d, "cpu").state_dict())
    with pytest.raises(ValueError, match="with_3d"):
        export_model("centernet", ck3d, str(tmp_path / "b"), tta="hflip", device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        export_model("centernet", setup["ckdir"], str(tmp_path / "c"), quantize="w4",
                     device="cpu")
