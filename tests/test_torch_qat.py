"""Quantization-aware training of cvm_tpu_torch (``train/qat.py``) against
the reference's ``cvm_tpu/train/qat.py``, on the CPU at a tiny size.

* ``fake_quant_act`` / ``fake_quant_weight`` equal the reference's on the
  same seeded numbers (bit for bit, float32), and their gradient is the
  identity (the straight-through estimator).
* A Conv under ``fake_quant_training`` against a flax ``nn.Conv`` under the
  reference's context, float32 with a bias and bf16 without: within 1e-6
  relative (float32), one bf16 step (bf16).
* Two ``qat=True`` train steps of the tiny CenterNet on both sides from the
  same converted weights and processed inputs, as
  ``tests/test_torch_zoo_train.py`` holds the dense models: every metric
  within rtol 1e-2, ``grad_norm`` within 5% (bf16 convs round in different
  places on the two sides).
* A ``qat`` config's pipeline and eval step serve the fake-quant convs
  (not with ``w8a8``); ``cli.train --qat true`` resumed from an fp run
  takes the flag and records it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.train import qat as jqat
from cvm_tpu.train.loop import create_train_state as j_create_state
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu.train.optim import make_optimizer as j_make_optimizer
from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models.centernet.loss import centernet_loss
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.models.layers import Conv
from cvm_tpu_torch.ops.heatmap import CenternetTargets
from cvm_tpu_torch.train import qat
from cvm_tpu_torch.train.checkpoints import load_params_cfg
from cvm_tpu_torch.train.loop import create_train_state, make_eval_step, make_train_step
from cvm_tpu_torch.train.optim import make_optimizer

TINY = dict(input_hw=(64, 64), num_classes=3, backbone="tiny", neck_features=32,
            head_features=16, batch_size=2, max_objects=8)
CLI = ["--model", "centernet", "--data", "synthetic", "--device", "cpu", "--pad_hw", "80,96",
       "--input_hw", "64,64", "--backbone", "tiny", "--neck_features", "32",
       "--head_features", "16", "--num_classes", "3", "--batch_size", "2",
       "--warmup_steps", "2", "--log_every", "1", "--checkpoint_every", "2"]


def test_fake_quant_values_match_reference_and_the_gradient_is_the_identity():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (2, 6, 5, 16)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 16, 8)).astype(np.float32)  # HWIO
    np.testing.assert_array_equal(qat.fake_quant_act(torch.from_numpy(x)).numpy(),
                                  np.asarray(jqat.fake_quant_act(jnp.asarray(x))))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()  # OIHW
    np.testing.assert_array_equal(qat.fake_quant_weight(wt).permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jqat.fake_quant_weight(jnp.asarray(w))))
    for fn, t in ((qat.fake_quant_act, torch.from_numpy(x)), (qat.fake_quant_weight, wt)):
        t = t.clone().requires_grad_(True)
        g = torch.from_numpy(rng.normal(0, 1, t.shape).astype(np.float32))
        (fn(t) * g).sum().backward()
        torch.testing.assert_close(t.grad, g, rtol=0, atol=0)
    # the values do move: they are snapped to the int8 grid
    assert not torch.equal(qat.fake_quant_act(torch.from_numpy(x)), torch.from_numpy(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_conv_matches_reference(dtype):
    rng = np.random.default_rng(1)
    bias = dtype == "float32"
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kernel = rng.normal(0, 0.2, (3, 3, 12, 8)).astype(np.float32)
    params = {"kernel": kernel}
    if bias:
        params["bias"] = rng.normal(0, 0.5, (8,)).astype(np.float32)
    x = rng.normal(0, 1.0, (2, 9, 7, 12)).astype(np.float32)
    jm = fnn.Conv(8, (3, 3), strides=(2, 2), use_bias=bias, dtype=jdt, param_dtype=jnp.float32)
    with jqat.fake_quant_training():
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)), np.float32)
    tm = Conv(12, 8, 3, 2, bias=bias, dtype=tdt)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        if bias:
            tm.bias.copy_(torch.from_numpy(params["bias"]))
        with qat.fake_quant_training():
            got = tm(torch.from_numpy(x))
        assert Conv.fake_quant is None and got.dtype == tdt
        plain = tm(torch.from_numpy(x)).float().numpy()
    got = got.float().numpy()
    if bias:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    assert np.abs(got - plain).max() > 0  # the fake-quant path ran


@pytest.fixture(scope="module")
def two_steps():
    kw = dict(TINY, optimizer="sgd", lr_schedule="constant", warmup_steps=1,
              learning_rate=0.05, weight_decay=1e-3, ema_decay=0.9, qat=True)
    spec = j_get_model("centernet")
    jp, tp = spec.params_cls(**kw), CenternetParams(**kw)
    jmodel = spec.create_model(jp)
    raw = synthetic_batch(np.random.default_rng(0), 2, (80, 96), num_classes=3, max_objects=8)
    raw = {k: jnp.asarray(raw[k]) for k in ("image", "image_hw", "boxes", "classes",
                                            "num_objects")}
    inputs, targets = jax.jit(spec.make_processor(jp, train=True))(jax.random.PRNGKey(3), raw)
    tx = j_make_optimizer(jp.learning_rate, jp.total_steps, jp.warmup_steps, jp.weight_decay,
                          lr_schedule="constant", optimizer="sgd")
    state = jax.jit(lambda: j_create_state(jmodel, jp, tx, jnp.zeros((1, 64, 64, 3)),
                                           {"params": jax.random.PRNGKey(1)}))()
    v0 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(j_make_train_step(jmodel, spec.loss_fn, jp, tx,
                                     lambda key, raw: (inputs, targets)))
    jmetrics = []
    for _ in range(2):
        state, m = step(state, raw, jax.random.PRNGKey(0))
        jmetrics.append(jax.device_get(m))
    model = create_model(tp, "cpu")
    model.load_state_dict(convert_variables(v0), strict=True)
    t_in = torch.from_numpy(np.array(inputs))
    t_tg = CenternetTargets(*(torch.from_numpy(np.array(f)) for f in targets[:6]))
    opt = make_optimizer(list(model.parameters()), tp.learning_rate, tp.total_steps,
                         tp.warmup_steps, tp.weight_decay, lr_schedule="constant",
                         optimizer="sgd")
    tstate = create_train_state(model, tp, opt)
    tstep = make_train_step(centernet_loss, tp, lambda gen, raw, rows: (t_in, t_tg))
    tmetrics = []
    for _ in range(2):
        tstate, m = tstep(tstate, None, None)
        tmetrics.append({k: float(val) for k, val in m.items()})
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, tstate=tstate, tp=tp, t_in=t_in,
                t_tg=t_tg)


def test_two_qat_train_steps_match_reference(two_steps):
    assert two_steps["tstate"].step == 2
    for jm, tm in zip(two_steps["jmetrics"], two_steps["tmetrics"]):
        assert set(tm) == set(jm)
        for k in jm:
            rtol = 5e-2 if k == "grad_norm" else 1e-2
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, atol=1e-6, err_msg=k)
    assert Conv.fake_quant is None  # the step's context closed


def test_qat_eval_step_and_pipeline_serve_fake_quant(two_steps, monkeypatch):
    tp, model = two_steps["tp"], two_steps["tstate"].model
    calls = []
    real = qat.fq_conv
    monkeypatch.setattr(qat, "fq_conv", lambda *a: calls.append(1) or real(*a))
    make_eval_step(centernet_loss, tp, lambda gen, raw: (two_steps["t_in"],
                                                         two_steps["t_tg"]))(
        two_steps["tstate"], None)
    n_convs = sum(isinstance(m, Conv) for m in model.modules())
    assert len(calls) == n_convs
    calls.clear()
    batch = synthetic_batch(np.random.default_rng(2), 2, (80, 96), num_classes=3)
    eval_model = model.eval()
    out_q = InferencePipeline(tp, eval_model, "cpu", input_format="rgb")(batch)
    assert len(calls) == n_convs
    calls.clear()
    out_fp = InferencePipeline(tp.replace(qat=False), eval_model, "cpu", input_format="rgb")(
        batch)
    InferencePipeline(tp, eval_model, "cpu", input_format="rgb", w8a8=True)(batch)
    assert not calls  # no fake quant in fp, nor where an int8 path runs
    assert not torch.equal(out_q["scores"], out_fp["scores"])
    model.train()


def test_cli_qat_resumes_an_fp_run_and_records_the_flag(tmp_path, capsys):
    wd = tmp_path / "w"
    assert train_main(CLI + ["--workdir", str(wd), "--steps", "2"]) == 0
    assert not load_params_cfg(str(wd / "checkpoints"), CenternetParams).qat
    assert train_main(CLI + ["--workdir", str(wd), "--steps", "4", "--qat", "true",
                             "--eval_every", "2", "--eval_batches", "1"]) == 0
    assert "params.json updated" in capsys.readouterr().err
    assert load_params_cfg(str(wd / "checkpoints"), CenternetParams).qat
    recs = [json.loads(line) for line in open(wd / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in recs if "val_mAP" in r] == [4]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    # a best checkpoint scored without QAT refuses the flip back under --keep_best
    assert train_main(CLI + ["--workdir", str(tmp_path / "b"), "--steps", "2",
                             "--eval_every", "2", "--eval_batches", "1",
                             "--keep_best", "mAP"]) == 0
    with pytest.raises(SystemExit, match="new workdir"):
        train_main(CLI + ["--workdir", str(tmp_path / "b"), "--steps", "4", "--qat", "true",
                          "--eval_every", "2", "--eval_batches", "1", "--keep_best", "mAP"])
