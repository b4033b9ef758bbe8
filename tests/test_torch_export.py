"""Export -> artifact -> ``ServingModel`` of cvm_tpu_torch on the CPU at a
tiny size (``backbone="tiny"``, 32x32 input, batch 2), against the
reference's ``InferencePipeline`` of the same posture.

One artifact per ``--quantize`` posture, from a checkpoint of converted
reference weights (non-trivial BN statistics): ``none`` (BN folded, RGB),
``int8`` (yuv420), ``w8a8`` (RGB), ``w8a8_fused`` (yuv420) and
``w8a8_fused_chain`` (RGB). Each loads, passes its selftest and carries the
reference's ``artifact.json`` keys. Its outputs agree with the reference
pipeline of its posture (weight-only int8: the dequantized weights; the
W8A8 postures: the port's calibration table, converted) on the same
scenes: decoded scores sorted per image within 0.01, as
``tests/test_torch_slice.py`` holds them (XLA's CPU backend does not round
the reference's bf16 heads). ``w8a8_fused`` is held to the port's eager
pipeline instead, exactly (the reference's fused kernel in interpret mode
is slow on the CPU, and ``w8a8_fused_chain`` already meets it here). The
buckets, the CLIs and the refusals are in ``test_torch_export_cli.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline
from cvm_tpu.infer.quantize import dequantize_params as j_dequantize
from cvm_tpu.infer.quantize import quantize_params as j_quantize
from cvm_tpu.models import get_model
from cvm_tpu_torch.cli.export import calibration_scales, export_model
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.runtime import ServingModel
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.train.loop import Trainer

from test_torch_model import random_bn_stats

CFG = dict(input_hw=(32, 32), num_classes=3, backbone="tiny", neck_features=16,
           head_features=8, top_k=10, batch_size=2)
PAD = (48, 48)
# posture -> input format
POSTURES = {"none": "rgb", "int8": "yuv420", "w8a8": "rgb", "w8a8_fused": "yuv420",
            "w8a8_fused_chain": "rgb"}
META_KEYS = {"model", "input_format", "batch_size", "batch_sizes", "pad_hw", "quantize",
             "fold_bn", "tta", "qat", "params_cfg", "selftest", "torch_version", "device",
             "device_kind"}


def write_checkpoint(directory, cfg, state_dict):
    """A checkpoint of the port's (step 1) holding ``state_dict``."""
    tr = Trainer(cfg, "cpu", checkpoint_dir=str(directory))
    tr.init_state()
    tr.state.model.load_state_dict(state_dict, strict=True)
    tr.state.step = 1
    tr.ckpt.save(1, tr.checkpoint_state(None))
    tr.ckpt.wait()  # the write is asynchronous
    return str(directory)


def flax_path(name):
    """The port's conv module name -> the reference's calibration key."""
    parts = name.split(".")
    return "/".join(["Backbone_0" if p == "backbone" else p for p in parts])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    spec = get_model("centernet")
    jp = spec.params_cls(**CFG)
    jm = spec.create_model(jp)
    variables = random_bn_stats(
        jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=False),
        np.random.default_rng(21))
    cfg = CenternetParams(**CFG)
    root = tmp_path_factory.mktemp("export")
    ckdir = write_checkpoint(root / "ck", cfg, convert_variables(variables))
    arts, served = {}, {}
    for q, fmt in POSTURES.items():
        arts[q] = str(root / f"art_{q}")
        export_model("centernet", ckdir, arts[q], batch_size=2, pad_hw=PAD, quantize=q,
                     input_format=fmt, fold_bn=q == "none", device="cpu")
        served[q] = ServingModel(arts[q], device="cpu")
    tr = Trainer(cfg, "cpu", checkpoint_dir=ckdir)
    tr.init_state()
    scales = calibration_scales(cfg, tr.eval_model(), PAD, 3, 2, "cpu")
    return dict(spec=spec, jp=jp, variables=variables, cfg=cfg, ckdir=ckdir, arts=arts,
                served=served, scales=scales, model=tr.eval_model())


def _batch(fmt, seed=5, n=2):
    b = synthetic_batch(np.random.default_rng(seed), n, PAD, yuv420=fmt == "yuv420")
    keys = ("y", "u", "v", "image_hw") if fmt == "yuv420" else ("image", "image_hw")
    return {k: b[k] for k in keys}


@pytest.mark.parametrize("posture", sorted(POSTURES))
def test_artifact_loads_and_passes_its_selftest(setup, posture):
    art, sm = setup["arts"][posture], setup["served"][posture]
    assert sm.selftest() == []
    meta = json.loads(open(os.path.join(art, "artifact.json")).read())
    assert META_KEYS <= set(meta) and meta["quantize"] == posture
    assert meta["input_format"] == POSTURES[posture] and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__ and meta["fold_bn"] == (posture == "none")
    assert sm.bucket_sizes == [2] and meta["batch_sizes"] == [2]
    assert set(os.listdir(art)) == {"model.pt2", "weights.npz", "params.json", "artifact.json"}
    with np.load(os.path.join(art, "weights.npz")) as z:
        names = set(z.files)
    assert any(n.endswith("/int8") for n in names) == (posture == "int8")
    assert (os.path.getsize(os.path.join(art, "model.pt2"))
            < os.path.getsize(os.path.join(art, "weights.npz")))  # no weights inside


def _reference(setup, posture, fmt):
    spec, jp, variables = setup["spec"], setup["jp"], setup["variables"]
    jscales = {flax_path(k): v for k, v in setup["scales"].items()}
    kw = {"none": dict(fold_bn=True), "int8": {}, "w8a8": dict(w8a8=jscales),
          "w8a8_fused_chain": dict(w8a8=jscales, w8a8_fused=True, w8a8_chain=True)}[posture]
    if posture == "int8":
        qparams, _ = j_quantize(variables["params"])
        variables = {**variables, "params": j_dequantize(qparams)}
    return JPipeline(spec, jp, variables, input_format=fmt, **kw)


@pytest.mark.parametrize("posture", sorted(POSTURES))
def test_artifact_matches_the_reference_pipeline(setup, posture):
    fmt = POSTURES[posture]
    batch = _batch(fmt)
    got = setup["served"][posture].predict_batch(batch)
    if posture == "w8a8_fused":
        eager = InferencePipeline(setup["cfg"], setup["model"], "cpu", input_format=fmt,
                                  w8a8=setup["scales"], w8a8_fused=True)
        for k, v in eager(batch).items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
        return
    want = jax.device_get(_reference(setup, posture, fmt)(batch))
    assert set(got) == {"boxes", "scores", "classes"}
    for k in got:
        assert got[k].shape == np.asarray(want[k]).shape, k
    assert np.isfinite(got["boxes"]).all()
    np.testing.assert_allclose(np.sort(got["scores"], axis=1),
                               np.sort(np.asarray(want["scores"]), axis=1), atol=0.01)
