"""The dense zoo's training slice (cvm_tpu_torch) against the reference, on
the CPU at a tiny size (``backbone="tiny"``, 64x128, batch 2).

* Each processor on the reference's draws (``jax.random`` numbers drawn as
  the reference draws them, injected into the port's deterministic core),
  in eval and in training: images within 1e-6 of the reference's on the
  [-1, 1] scale (the CenterNet processor's test holds 1e-4; these scenes'
  arithmetic agrees to 1e-6), the class mask and the sparse depth
  bit-equal, and multitask's heatmap, centre mask and indices equal.
* Two ``train_step``s per model on both sides from the same converted
  weights and processed inputs (SGD, the first step at learning rate 0):
  every metric within rtol 1e-2, as ``tests/test_torch_train.py`` holds
  CenterNet's (bf16 convs round in different places on the two sides),
  except ``grad_norm``, held within 5%. Two effects move it at this size,
  both measured: XLA's CPU backend sums the reference's bf16 head-conv
  bias gradients in bf16 over the stride-2 map (4,096 pixels; the seg
  head's bias gradient lands 177% of its norm away from the port's, whose
  own float32 run agrees with it to 0.1%), which shifts the reference's
  global norm by 1.6% (semseg); and batch statistics over the 4x8 deepest
  map amplify bf16 noise, so the port's own bf16 and float32 norms differ
  by 1.1% (depth). Measured gaps: 1.9% (semseg), 3.3% (depth).
* ``Trainer.fit`` lowers each model's loss on synthetic scenes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.train.loop import create_train_state as j_create_state
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu.train.optim import make_optimizer as j_make_optimizer
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.data.loader import prefetch_to_device
from cvm_tpu_torch.data.synthetic import SyntheticIterator
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.ops.heatmap import CenternetTargets
from cvm_tpu_torch.pipeline.preprocess import aug_from_params
from cvm_tpu_torch.train.loop import Trainer, create_train_state, make_train_step
from cvm_tpu_torch.train.optim import make_optimizer
from test_torch_processor import jax_draws

HW = (64, 128)
PAD = (80, 160)
TINY = {
    "semseg": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=2),
    "depth": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=2),
    "multitask": dict(input_hw=HW, backbone="tiny", neck_features=32, head_features=16,
                      batch_size=2, num_det_classes=3, max_objects=8),
    "multitask_uw": dict(input_hw=HW, backbone="tiny", neck_features=32, head_features=16,
                         batch_size=2, num_det_classes=3, max_objects=8,
                         uncertainty_weighting=True),
}
KEYS = ("image", "image_hw", "boxes", "classes", "num_objects", "mask", "depth")


def _raw(seed, B=2):
    raw = j_synthetic_batch(np.random.default_rng(seed), B, PAD, num_classes=3, max_objects=8)
    return {k: raw[k] for k in KEYS}


def _to_torch_targets(t):
    if isinstance(t, dict):
        return {k: _to_torch_targets(v) for k, v in t.items()}
    if hasattr(t, "heatmap"):  # the reference's CenternetTargets
        return CenternetTargets(*(torch.from_numpy(np.array(f)) for f in t[:6]))
    return torch.from_numpy(np.array(t))


def _assert_targets_equal(got, ref):
    for k, r in ref.items():
        if k == "det":
            g = got["det"]
            np.testing.assert_allclose(g.heatmap.numpy(), np.asarray(r.heatmap), atol=0,
                                       rtol=0, err_msg="heatmap")
            for f in ("mask", "indices", "valid"):
                np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(r, f)),
                                              err_msg=f)
        else:
            assert got[k].shape == r.shape and got[k].dtype == torch.from_numpy(
                np.asarray(r)).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(r), err_msg=k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["semseg", "depth", "multitask"])
def test_processor_matches_reference_on_given_draws(name, train):
    B = 3
    raw = _raw(len(name) + train, B)
    key = jax.random.PRNGKey(0)
    jp = j_get_model(name).params_cls(**TINY[name])
    tp = get_model(name).params_cls(**TINY[name])
    rimages, rtargets = j_get_model(name).make_processor(jp, train)(
        key if train else None, {k: jnp.asarray(v) for k, v in raw.items()})
    draws = jax_draws(key, B, tp.input_hw, aug_from_params(tp)) if train else None
    if train:
        assert 0 < int(draws.roi.flip.sum()) < B
    images, targets = get_model(name).make_processor(tp, train)(
        None, {k: torch.from_numpy(v) for k, v in raw.items()}, draws=draws)
    np.testing.assert_allclose(images.numpy(), np.asarray(rimages), atol=1e-6, rtol=0)
    _assert_targets_equal(targets, rtargets)
    if "classes" in targets and not train:
        assert (targets["classes"] == tp.ignore_index).any()  # the letterbox bars
    if "depth" in targets and not train:
        assert (targets["depth"] == 0).any() and (targets["depth"] > 0).any()


def _two_steps(case):
    name = case.split("_")[0]
    kw = dict(TINY[case], optimizer="sgd", lr_schedule="constant", warmup_steps=1,
              learning_rate=0.02, weight_decay=1e-3, ema_decay=0.9)
    jspec, tspec = j_get_model(name), get_model(name)
    jp, tp = jspec.params_cls(**kw), tspec.params_cls(**kw)
    jmodel = jspec.create_model(jp)
    raw = {k: jnp.asarray(v) for k, v in _raw(5).items()}
    inputs, targets = jax.jit(jspec.make_processor(jp, train=True))(jax.random.PRNGKey(3), raw)
    tx = j_make_optimizer(jp.learning_rate, jp.total_steps, jp.warmup_steps, jp.weight_decay,
                          lr_schedule="constant", optimizer="sgd")
    state = jax.jit(lambda: j_create_state(jmodel, jp, tx, jnp.zeros((1, *HW, 3)),
                                           {"params": jax.random.PRNGKey(1)}))()
    v0 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(j_make_train_step(jmodel, jspec.loss_fn, jp, tx,
                                     lambda key, raw: (inputs, targets)))
    jmetrics = []
    for _ in range(2):
        state, m = step(state, raw, jax.random.PRNGKey(0))
        jmetrics.append(jax.device_get(m))

    model = tspec.create_model(tp, "cpu")
    model.load_state_dict(convert_variables(v0), strict=True)
    t_in, t_tg = torch.from_numpy(np.array(inputs)), _to_torch_targets(targets)
    opt = make_optimizer(list(model.parameters()), tp.learning_rate, tp.total_steps,
                         tp.warmup_steps, tp.weight_decay, lr_schedule="constant",
                         optimizer="sgd")
    tstate = create_train_state(model, tp, opt)
    tstep = make_train_step(tspec.loss_fn, tp, lambda gen, raw, rows: (t_in, t_tg))
    tmetrics = []
    for _ in range(2):
        tstate, m = tstep(tstate, None, None)
        tmetrics.append({k: float(val) for k, val in m.items()})
    return jmetrics, tmetrics, tstate


@pytest.mark.parametrize("case", sorted(TINY))
def test_two_train_steps_match_reference(case):
    jmetrics, tmetrics, tstate = _two_steps(case)
    assert tstate.step == 2
    for jm, tm in zip(jmetrics, tmetrics):
        assert set(tm) == set(jm)
        for k in jm:
            rtol = 5e-2 if k == "grad_norm" else 1e-2
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, atol=1e-6, err_msg=k)
    if case == "multitask_uw":  # weight decay and the gradient reach task_log_vars
        assert tstate.model.task_log_vars.abs().sum() > 0


def test_unread_disp_heads_train_on_a_zero_gradient(tmp_path):
    """A depth net supervised at fewer than its four scales declares the
    coarse disp heads no loss reads: the step gives them a zero gradient
    (as JAX does) and trains the rest."""
    cfg = get_model("depth").params_cls(**dict(TINY["depth"], num_scales=1, optimizer="sgd",
                                                lr_schedule="constant", warmup_steps=1,
                                                weight_decay=0.0))
    tr = Trainer(cfg, "cpu", seed=0)
    tr.init_state()
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    raw = next(prefetch_to_device([next(SyntheticIterator(0, 2, PAD, num_classes=3))],
                                  torch.device("cpu")))
    for _ in range(2):  # the first step's learning rate is 0
        _, m = tr.train_step(tr.state, raw, torch.Generator().manual_seed(0))
        assert np.isfinite(float(m["loss"]))
    moved = {n.split(".")[0] for n, p in tr.model.named_parameters()
             if not torch.equal(p, before[n])}
    assert {"disp0", "disp1", "disp2"}.isdisjoint(moved) and {"disp3", "up3"} <= moved


@pytest.mark.parametrize("name", ["semseg", "depth", "multitask"])
def test_fit_lowers_the_loss(tmp_path, name):
    cfg = get_model(name).params_cls(**dict(TINY[name], warmup_steps=2))
    tr = Trainer(cfg, "cpu", metrics_path=str(tmp_path / "m.jsonl"), log_every=1, seed=0)
    tr.init_state()
    tr.fit(SyntheticIterator(0, cfg.batch_size, PAD, num_classes=3), 16)
    losses = [json.loads(line)["loss"] for line in open(tmp_path / "m.jsonl")]
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
