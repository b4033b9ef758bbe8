"""The CenterNet training slice of cvm_tpu_torch against the reference, on
the CPU at a tiny size, and the Trainer's own contracts.

* BatchNorm in training mode (the port's one known fault, now repaired):
  one step of a float32 ConvBN on both sides, outputs and ``batch_stats``
  within float32 rounding (1e-5).
* Each block in training mode at float32 on both sides (ConvBN, ResBlock,
  UpBlock, Head): output, parameter and input gradients, ``batch_stats``
  within 1e-4 of each leaf's norm.
* One ``train_step`` of the tiny CenterNet (``backbone="tiny"``, 64x64,
  batch 2) on both sides, from the same converted weights and the same
  processed inputs: loss, per-leaf gradients, updated parameters,
  ``batch_stats`` and EMA. The model computes its convs in bf16, and the
  two sides round in different places (XLA's CPU backend also reduces a
  bf16 bias gradient in bf16); at this size the port's own bf16 and
  float32 gradients differ by up to 11% of a leaf's norm. So the bound is
  30% of each leaf's norm and 15% over all leaves together (gradients and
  parameter updates; measured: 20% and 8%), 10% of the norm of each
  BatchNorm statistic's change, and 1e-2 relative for the loss. A wrong formula (a missing term, a factor of two) moves
  a leaf by 50% or more. SGD is used because Adam's first steps normalise
  each element by its own magnitude and turn bf16 noise in near-zero
  gradients into full-size steps.
* ``Trainer.fit`` lowers the loss; checkpoints resume bit for bit; keep-N,
  ``request_stop``, the EMA/checkpoint reconciliation, and the CLI.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.models import get_model
from cvm_tpu.models import layers as jl
from cvm_tpu.models.centernet.params import CenternetParams as JParams
from cvm_tpu.models.centernet.processor import make_processor as j_make_processor
from cvm_tpu.train.loop import create_train_state as j_create_state
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu.train.optim import make_optimizer as j_make_optimizer
from cvm_tpu_torch.cli.train import main as cli_main
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.data.loader import prefetch_to_device
from cvm_tpu_torch.data.synthetic import SyntheticIterator
from cvm_tpu_torch.models import layers as tl
from cvm_tpu_torch.models.centernet.loss import centernet_loss
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops.heatmap import CenternetTargets
from cvm_tpu_torch.train.checkpoints import BestCheckpoint, CheckpointManager, load_params_cfg
from cvm_tpu_torch.train.loop import (Trainer, create_train_state, make_eval_step,
                                      make_train_step)
from cvm_tpu_torch.train.optim import make_optimizer

TINY = dict(input_hw=(64, 64), num_classes=3, backbone="tiny", neck_features=32,
            head_features=16, batch_size=2, max_objects=8)


@pytest.mark.parametrize("shape", [(2, 6, 5, 8), (8, 4, 4, 8)])
def test_batchnorm_train_step_matches_flax(shape):
    rng = np.random.default_rng(shape[0])
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    jm = jl.ConvBN(16, 3, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = {"params": jax.device_get(v["params"]),
         "batch_stats": {"bn": {"mean": rng.normal(0, 0.3, 16).astype(np.float32),
                                "var": rng.uniform(0.5, 2, 16).astype(np.float32)}}}
    v["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    ref, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = tl.ConvBN(8, 16, 3, dtype=torch.float32)
    tm.load_state_dict(convert_variables(v))
    tm.train()
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=1e-5)
    # torch's own train mode stores the unbiased variance: the fault repaired
    native = nn.BatchNorm2d(16, momentum=0.1)
    native.load_state_dict({k: val for k, val in tm.bn.state_dict().items()})
    native.running_var.copy_(torch.from_numpy(v["batch_stats"]["bn"]["var"]))
    native.running_mean.copy_(torch.from_numpy(v["batch_stats"]["bn"]["mean"]))
    native.train()(tm.conv(torch.from_numpy(x)).permute(0, 3, 1, 2))
    assert not np.allclose(native.running_var.detach().numpy(), tm.bn.running_var.numpy(),
                           rtol=1e-4)


BLOCKS = {
    "convbn_3x3": (lambda: jl.ConvBN(16, 3, dtype=jnp.float32),
                   lambda: tl.ConvBN(8, 16, 3, dtype=torch.float32), [(2, 8, 6, 8)]),
    "convbn_s2": (lambda: jl.ConvBN(16, 3, stride=2, dtype=jnp.float32),
                  lambda: tl.ConvBN(8, 16, 3, stride=2, dtype=torch.float32), [(2, 8, 6, 8)]),
    "resblock_proj": (lambda: jl.ResBlock(24, dtype=jnp.float32),
                      lambda: tl.ResBlock(8, 24, dtype=torch.float32), [(2, 6, 6, 8)]),
    "upblock": (lambda: jl.UpBlock(12, dtype=jnp.float32),
                lambda: tl.UpBlock(16, 8, 12, dtype=torch.float32), [(2, 3, 3, 16), (2, 6, 6, 8)]),
    "head": (lambda: jl.Head(16, 3, -2.19, dtype=jnp.float32),
             lambda: tl.Head(8, 16, 3, -2.19, dtype=torch.float32), [(2, 6, 6, 8)]),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_train_mode_gradients_match_flax_f32(name):
    jmake, tmake, shapes = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    xs = [rng.normal(0.2, 1.5, s).astype(np.float32) for s in shapes]
    jm = jmake()
    v = jax.device_get(jm.init(jax.random.PRNGKey(2), *map(jnp.asarray, xs), train=False))
    out_shape = jax.eval_shape(lambda *a: jm.apply(v, *a, train=True, mutable=["batch_stats"])[0],
                               *map(jnp.asarray, xs)).shape
    w = rng.normal(0, 1, out_shape).astype(np.float32)

    def jloss(params, *x):
        out, mut = jm.apply({**v, "params": params}, *x, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut)

    (_, (ref, mut)), (gp, *gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(1 + len(xs))), has_aux=True))(v["params"], *map(jnp.asarray, xs))
    tm = tmake()
    tm.load_state_dict(convert_variables(v), strict=True)
    tm.train()
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = tm(*tx)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(params.values()) + tx)
    _leaf_close(out.detach().numpy(), ref, 1e-4, "output")
    want = convert_variables({"params": jax.device_get(gp),
                              "batch_stats": jax.device_get(mut.get("batch_stats", {}))})
    for (k, g) in zip(params, grads):
        _leaf_close(g.numpy(), want[k].numpy(), 1e-4, k)
    for g, r in zip(grads[len(params):], gx):
        _leaf_close(g.numpy(), r, 1e-4, "input grad")
    for k, b in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _leaf_close(b.numpy(), want[k].numpy(), 1e-5, k)


def _leaf_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want)
    assert err <= tol * max(np.linalg.norm(want), 1e-8), (what, err, np.linalg.norm(want))


@pytest.fixture(scope="module")
def two_steps():
    """Both sides after two SGD steps (lr 0, then lr > 0) on one processed
    batch, and the gradients of the first step."""
    kw = dict(TINY, optimizer="sgd", lr_schedule="constant", warmup_steps=1,
              learning_rate=0.05, weight_decay=1e-3, ema_decay=0.9)
    jp, tp = JParams(**kw), CenternetParams(**kw)
    spec = get_model("centernet")
    jmodel = spec.create_model(jp)
    raw = synthetic_batch(np.random.default_rng(0), 2, (80, 96), num_classes=3, max_objects=8)
    raw = {k: jnp.asarray(raw[k]) for k in ("image", "image_hw", "boxes", "classes",
                                            "num_objects")}
    inputs, targets = jax.jit(j_make_processor(jp, train=True))(jax.random.PRNGKey(3), raw)
    tx = j_make_optimizer(jp.learning_rate, jp.total_steps, jp.warmup_steps, jp.weight_decay,
                          lr_schedule="constant", optimizer="sgd")
    state = jax.jit(lambda: j_create_state(jmodel, jp, tx, jnp.zeros((1, 64, 64, 3)),
                                           {"params": jax.random.PRNGKey(1)}))()
    v0 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})

    def loss_fn(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": state.batch_stats}, inputs,
                                train=True, mutable=["batch_stats"])
        return spec.loss_fn(out, targets, jp)[0]

    jgrads = jax.device_get(jax.jit(jax.grad(loss_fn))(state.params))
    step = jax.jit(j_make_train_step(jmodel, spec.loss_fn, jp, tx,
                                     lambda key, raw: (inputs, targets)))
    jstates, jmetrics = [], []
    for _ in range(2):
        state, m = step(state, raw, jax.random.PRNGKey(0))
        jstates.append(jax.device_get(state))
        jmetrics.append(jax.device_get(m))

    model = create_model(tp, "cpu")
    model.load_state_dict(convert_variables(v0), strict=True)
    t_in = torch.from_numpy(np.array(inputs))
    t_tg = CenternetTargets(*(torch.from_numpy(np.array(f)) for f in targets[:6]))
    opt = make_optimizer(list(model.parameters()), tp.learning_rate, tp.total_steps,
                         tp.warmup_steps, tp.weight_decay, lr_schedule="constant",
                         optimizer="sgd")
    tstate = create_train_state(model, tp, opt)
    probe = create_model(tp, "cpu")
    probe.load_state_dict(model.state_dict())
    loss = centernet_loss(probe.train()(t_in), t_tg, tp)[0]
    tgrads = dict(zip([n for n, _ in probe.named_parameters()],
                      torch.autograd.grad(loss, list(probe.parameters()))))
    tstep = make_train_step(centernet_loss, tp, lambda gen, raw, rows: (t_in, t_tg))
    tstates, tmetrics = [], []
    for _ in range(2):
        tstate, m = tstep(tstate, None, None)
        sd = {k: val.clone() for k, val in tstate.model.state_dict().items()}
        ema = {n: e.clone() for (n, _), e in zip(tstate.model.named_parameters(), tstate.ema)}
        tstates.append((sd, ema))
        tmetrics.append({k: float(val) for k, val in m.items()})
    return dict(v0=v0, jgrads=jgrads, jstates=jstates, jmetrics=jmetrics, tgrads=tgrads,
                tstates=tstates, tmetrics=tmetrics, step=tstate.step)


def test_train_step_loss_and_metrics_match(two_steps):
    for jm, tm in zip(two_steps["jmetrics"], two_steps["tmetrics"]):
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-2, err_msg=k)
    assert two_steps["step"] == 2


def test_train_step_gradients_match_per_leaf(two_steps):
    want = convert_variables({"params": two_steps["jgrads"]})
    got = two_steps["tgrads"]
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    assert sorted(names) == sorted(got)
    for k in names:
        _leaf_close(got[k].numpy(), want[k].numpy(), 0.3, k)
    _leaf_close(np.concatenate([got[k].numpy().ravel() for k in names]),
                np.concatenate([want[k].numpy().ravel() for k in names]), 0.15, "all leaves")


def test_train_step_updates_batch_stats_and_ema_match(two_steps):
    v0 = convert_variables(two_steps["v0"])
    for i, ((sd, ema), js) in enumerate(zip(two_steps["tstates"], two_steps["jstates"])):
        want = convert_variables({"params": js.params, "batch_stats": js.batch_stats})
        want_ema = convert_variables({"params": js.ema_params})
        deltas = {"params": ([], []), "ema": ([], [])}
        for k, w in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                # statistics of bf16 activations: compare the change
                _leaf_close(sd[k].numpy() - v0[k].numpy(), w.numpy() - v0[k].numpy(), 0.1, k)
                continue
            # parameters and EMA: compare the change each side made
            for what, got, ref in (("params", sd[k], w), ("ema", ema[k], want_ema[k])):
                d_got, d_ref = got.numpy() - v0[k].numpy(), ref.numpy() - v0[k].numpy()
                if i == 0:  # lr 0 on the first step: only EMA rounding moves
                    scale = 1e-6 * float(np.abs(v0[k].numpy()).max())
                    np.testing.assert_allclose(d_got, 0.0, atol=scale, err_msg=f"{what} {k}")
                    np.testing.assert_allclose(d_ref, 0.0, atol=scale, err_msg=f"{what} {k}")
                else:
                    _leaf_close(d_got, d_ref, 0.3, f"{what} {k}")
                deltas[what][0].append(d_got.ravel())
                deltas[what][1].append(d_ref.ravel())
        if i == 1:
            for what, (g, r) in deltas.items():
                _leaf_close(np.concatenate(g), np.concatenate(r), 0.15, what)
    sd, _ = two_steps["tstates"][1]
    moved = [k for k in v0 if not k.endswith("num_batches_tracked")
             and not torch.equal(sd[k], v0[k])]
    assert len(moved) > 0.9 * len(v0) / 2  # the second step moved the parameters


def tiny_trainer(tmp_path, name="run", **kw):
    cfg = CenternetParams(**dict(TINY, warmup_steps=2, **kw))
    return Trainer(cfg, "cpu", checkpoint_dir=str(tmp_path / name / "ckpt"),
                   metrics_path=str(tmp_path / name / "metrics.jsonl"), checkpoint_every=3,
                   log_every=1, seed=0)


def _stream(cfg):
    return SyntheticIterator(0, cfg.batch_size, (80, 96), num_classes=3)


def test_fit_lowers_the_loss(tmp_path):
    tr = tiny_trainer(tmp_path)
    tr.init_state()
    tr.fit(_stream(tr.cfg), 24)
    losses = [json.loads(line)["loss"] for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert len(losses) == 24 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("head,module", [("size", "size"), ("offset", "off")])
def test_train_step_refuses_a_head_the_loss_does_not_reach(tmp_path, head, module):
    """A head the loss stops reading is an error that names its
    parameters, not a zero gradient under which weight decay shrinks it."""
    tr = tiny_trainer(tmp_path)
    tr.init_state()
    step = make_train_step(lambda out, tg, cfg, red: centernet_loss(
        {**out, head: out[head].detach()}, tg, cfg, red), tr.cfg, tr.processor)
    raw = next(prefetch_to_device([next(_stream(tr.cfg))], torch.device("cpu")))
    with pytest.raises(RuntimeError, match=rf"does not reach parameters \['{module}\."):
        step(tr.state, raw, torch.Generator().manual_seed(0))


def test_checkpoint_resume_continues_bit_for_bit(tmp_path):
    straight = tiny_trainer(tmp_path, "a", ema_decay=0.5)
    straight.init_state()
    straight.fit(_stream(straight.cfg), 5)
    first = tiny_trainer(tmp_path, "b", ema_decay=0.5)
    first.init_state()
    first.fit(_stream(first.cfg), 4)          # checkpoints step 3, steps on to 4
    assert first.ckpt.all_steps() == [3]
    resumed = tiny_trainer(tmp_path, "b", ema_decay=0.5)
    resumed.init_state()
    assert resumed.state.step == 3 and resumed.data_state is not None
    it = _stream(resumed.cfg)
    it.load_state_dict(resumed.data_state)
    resumed.fit(it, 2)
    assert resumed.state.step == straight.state.step == 5
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for a, b in zip(straight.eval_params.values(), resumed.eval_params.values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert straight.state.optimizer.count == resumed.state.optimizer.count == 5


def test_request_stop_checkpoints_the_current_step(tmp_path):
    tr = tiny_trainer(tmp_path)
    tr.init_state()
    tr.request_stop()
    tr.fit(_stream(tr.cfg), 10)
    assert tr.stop_requested and tr.state.step == 1
    assert tr.ckpt.latest_step() == 1


def test_ema_checkpoint_reconciliation(tmp_path, capsys):
    plain = tiny_trainer(tmp_path)
    plain.init_state()
    plain.fit(_stream(plain.cfg), 3)
    with_ema = tiny_trainer(tmp_path, ema_decay=0.9)
    with_ema.init_state()
    assert "seeding the EMA" in capsys.readouterr().err
    for a, b in zip(with_ema.eval_params.values(), plain.eval_params.values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with_ema.fit(_stream(with_ema.cfg), 3)     # saves step 6 with a shadow
    back = tiny_trainer(tmp_path)
    back.init_state()
    assert "dropping it" in capsys.readouterr().err and back.state.step == 6


def test_eval_step_uses_the_ema_params(tmp_path):
    tr = tiny_trainer(tmp_path, ema_decay=0.9)
    tr.init_state()
    tr.fit(_stream(tr.cfg), 3)
    raw = {k: torch.from_numpy(v) for k, v in next(_stream(tr.cfg)).items()
           if k in ("image", "image_hw", "boxes", "classes", "num_objects")}
    from cvm_tpu_torch.models.centernet.processor import make_processor

    proc = make_processor(tr.cfg, train=False)
    m_ema = make_eval_step(centernet_loss, tr.cfg, proc)(tr.state, raw)
    m_live = make_eval_step(centernet_loss, CenternetParams(**TINY), proc)(tr.state, raw)
    assert tr.model.training
    assert float(m_ema["loss"]) != float(m_live["loss"])
    eval_model = create_model(tr.cfg, "cpu")
    sd = tr.model.state_dict()
    sd.update(tr.eval_params)
    eval_model.load_state_dict(sd)
    with torch.no_grad():
        out = eval_model(proc(None, raw)[0])
    ref = centernet_loss(out, proc(None, raw)[1], tr.cfg)[0]
    torch.testing.assert_close(m_ema["loss"], ref, rtol=1e-6, atol=1e-6)


def test_checkpoint_manager_keep_n_best_and_params(tmp_path):
    cfg = CenternetParams(**TINY)
    m = CheckpointManager(str(tmp_path / "c"), keep=2, params_cfg=cfg)
    for s in (1, 2, 3, 5, 4):
        m.save(s, {"step": s, "t": torch.full((2,), float(s))})
    m.wait()  # the writes are asynchronous
    assert m.all_steps() == [4, 5] and m.latest_step() == 5
    assert float(m.restore_latest()["t"][0]) == 5.0 and m.restore_step(4)["step"] == 4
    assert not [f for f in os.listdir(tmp_path / "c") if f.endswith(".tmp")]
    assert load_params_cfg(str(tmp_path / "c"), CenternetParams) == cfg
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() is None
    best = BestCheckpoint(str(tmp_path / "best"), "mAP", "max")
    assert best.update(1, {"v": 1}, 0.5) and not best.update(2, {"v": 2}, 0.4)
    assert best.update(3, {"v": 3}, 0.7)
    best.wait()
    again = BestCheckpoint(str(tmp_path / "best"), "mAP", "max")
    assert again.best == 0.7 and again._mngr.all_steps() == [3]


def test_cli_trains_resumes_and_refuses_unported_flags(tmp_path, capsys):
    base = ["--model", "centernet", "--data", "synthetic", "--device", "cpu",
            "--workdir", str(tmp_path / "w"), "--pad_hw", "80,96", "--input_hw", "64,64",
            "--backbone", "tiny", "--neck_features", "32", "--head_features", "16",
            "--num_classes", "3", "--batch_size", "2", "--warmup_steps", "2",
            "--log_every", "1", "--checkpoint_every", "4"]
    assert cli_main(base + ["--steps", "10"]) == 0
    assert cli_main(base + ["--steps", "12"]) == 0
    out = capsys.readouterr().out
    assert "start_step=8" in out and "4 of the --steps total remain" in out
    recs = [json.loads(line) for line in open(tmp_path / "w" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == list(range(1, 11)) + [9, 10, 11, 12]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert cli_main(base + ["--steps", "20", "--max_seconds", "0.001"]) == 0
    assert CheckpointManager(str(tmp_path / "w" / "checkpoints")).latest_step() == 13
    with pytest.raises(SystemExit, match="--dcn_slices is not ported"):
        cli_main(base + ["--dcn_slices", "2"])
    capsys.readouterr()
    # the other multi-process flags get the reference's argument checks
    for extra, message in ((["--model_parallel", "2"], "not divisible by --model_parallel 2"),
                           (["--coordinator", "localhost:1"], "--coordinator requires"),
                           (["--tensor_parallel", "true"], "requires --model_parallel >= 2")):
        with pytest.raises(SystemExit):
            cli_main(base + extra)
        assert message in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        cli_main(base + ["--data", str(tmp_path / "train.cvrec")])
