"""The port's TensorBoard writer (``train/tensorboard.py``, a copy of the
reference's) and its metrics writers (``train/metrics.py``), on the CPU.

Exact: the same scalars, images and wall times give the same bytes from
both writers (the format's integer arithmetic: CRC32C, varints, PNG);
each reader reads the other's file. ``MultiWriter`` fans out, images to
the TensorBoard writer only; ``MlflowAdapter`` without ``mlflow`` (its
import made to fail) writes nothing, as the reference's. ``cli.train
--tensorboard --eval_images 2`` writes the scalars and two images per eval.
"""

import glob
import json
import os
import time

import numpy as np
import pytest

import cvm_tpu.train.tensorboard as jtb
import cvm_tpu_torch.train.tensorboard as ttb
from cvm_tpu.train.metrics import MlflowAdapter as JMlflowAdapter
from cvm_tpu_torch.train.metrics import JsonlMetricsWriter, MlflowAdapter, MultiWriter


def _write(mod, logdir, rgb):
    w = mod.TensorBoardWriter(str(logdir))
    w.write(3, {"loss": 0.25, "val_mAP": 1.0 / 3.0, "lr": 1e-4})
    w.write(1 << 40, {"big_step": -2.5})
    w.write_image(7, "eval/sample_0", rgb)
    w.close()
    return w.path


def test_same_events_give_the_same_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792000000.125)
    rgb = np.random.default_rng(0).integers(0, 256, (13, 17, 3)).astype(np.uint8)
    a = _write(ttb, tmp_path / "port", rgb)
    b = _write(jtb, tmp_path / "ref", rgb)
    assert os.path.basename(a) == os.path.basename(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    for reader in (ttb.read_scalar_events, jtb.read_scalar_events):
        for path in (a, b):
            ev = reader(path)
            assert ev[0]["file_version"] == "brain.Event:2"
            assert ev[1]["step"] == 3 and ev[1]["scalars"]["loss"] == 0.25
            assert ev[2]["step"] == 1 << 40
            img = ev[3]["images"]["eval/sample_0"]
            assert (img["height"], img["width"], img["colorspace"]) == (13, 17, 3)
            assert all(e["wall_time"] == 1792000000.125 for e in ev)
    data = np.random.default_rng(1).integers(0, 256, 999).astype(np.uint8).tobytes()
    assert ttb._crc32c(data) == jtb._crc32c(data) and ttb._masked_crc(data) == jtb._masked_crc(data)
    assert ttb._png_encode(rgb) == jtb._png_encode(rgb)


def test_png_decodes_to_the_image():
    from io import BytesIO

    from PIL import Image

    rgb = np.random.default_rng(2).integers(0, 256, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(BytesIO(ttb._png_encode(rgb)))), rgb)
    with pytest.raises(ValueError, match="expected"):
        ttb._png_encode(rgb[..., 0])


def test_multi_writer_and_mlflow_adapter(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "mlflow", None)  # `import mlflow` raises ImportError
    jsonl = JsonlMetricsWriter(str(tmp_path / "m.jsonl"))
    tb = ttb.TensorBoardWriter(str(tmp_path / "tb"))
    mlf = MlflowAdapter("exp", params={"lr": 1})
    assert mlf._mlflow is None and JMlflowAdapter("exp")._mlflow is None
    w = MultiWriter(jsonl, tb, mlf, None)
    w.write(5, {"loss": 1.5})
    w.write_image(5, "eval/x", np.zeros((4, 4, 3), np.uint8))
    w.close()
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [(r["step"], r["loss"]) for r in recs] == [(5, 1.5)]
    ev = ttb.read_scalar_events(tb.path)
    assert ev[1]["scalars"] == {"loss": 1.5} and "eval/x" in ev[2]["images"]


def test_cli_train_tensorboard_with_eval_images(tmp_path):
    from cvm_tpu_torch.cli.train import main

    assert main(["--model", "centernet", "--device", "cpu", "--workdir", str(tmp_path),
                 "--steps", "4", "--pad_hw", "96,96", "--input_hw", "64,64",
                 "--backbone", "tiny", "--neck_features", "32", "--head_features", "16",
                 "--num_classes", "3", "--batch_size", "2", "--warmup_steps", "1",
                 "--log_every", "1", "--eval_every", "2", "--eval_batches", "1",
                 "--tensorboard", "--eval_images", "2"]) == 0
    (path,) = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    ev = ttb.read_scalar_events(path)
    assert [e["step"] for e in ev if "loss" in e.get("scalars", {})] == [1, 2, 3, 4]
    assert [e["step"] for e in ev if "val_mAP" in e.get("scalars", {})] == [2, 4]
    images = [(e["step"], tag) for e in ev for tag in e.get("images", {})]
    assert images == [(2, "eval/sample_0"), (2, "eval/sample_1"),
                      (4, "eval/sample_0"), (4, "eval/sample_1")]
    img = ev[-1]["images"]["eval/sample_1"]
    assert img["png"].startswith(b"\x89PNG") and img["height"] > 0
