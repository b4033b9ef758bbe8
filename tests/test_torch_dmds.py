"""DMDS (cvm_tpu_torch, config E) against the reference, on the CPU at a
tiny size (``backbone="tiny"``, 64x128, ``motion_features`` 32, batch 2).

* The forward on converted variables (random BatchNorm statistics, a
  non-zero ``fc2``; ``strict=True`` load, Dense kernels transposed): the
  depth of both frames, the ego-motion and the residual translation field
  of both directions within ``assert_bf16_close``.
* One training-mode forward moves every BatchNorm's running statistics as
  the reference's does: the depth net runs on frame a then b, the motion
  net forward then backward, each call one update (biased variance);
  within 5% of the statistic's movement in that forward (bf16 activations
  move the deepest layers' batch statistics by up to 1.2% of it; a missed
  or extra update moves them by about half).
* ``dmds_loss`` and its gradient with respect to every output, against
  ``jax.value_and_grad``: rtol 1e-4.
* The processor on the reference's draws (one shared ROI, no flip), RGB
  and 4:2:0, eval and training: frames within 1e-6, intrinsics within
  1e-5.
* Two training steps against the reference's: every metric within rtol
  1e-2, ``grad_norm`` within 5% (``tests/test_torch_zoo_train.py``).
* ``evaluate_model`` with the same injected depth: exactly the reference's
  median-scaled depth metrics.
* The fp serving pipeline of both frames against the reference's (depth,
  rotation, translation within ``assert_bf16_close``); hflip and W8A8 are
  refused with the reference's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.train import evaluate as j_eval
from cvm_tpu.train.loop import create_train_state as j_create_state
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu.train.optim import make_optimizer as j_make_optimizer
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.ops.image import RoiDraws
from cvm_tpu_torch.train import evaluate as t_eval
from cvm_tpu_torch.train.loop import create_train_state, make_train_step
from cvm_tpu_torch.train.optim import make_optimizer
from test_torch_model import assert_bf16_close, random_bn_stats

HW = (64, 128)
PAD = (80, 160)
CFG = dict(input_hw=HW, backbone="tiny", decoder_features=16, motion_features=32,
           batch_size=2)
MOTION = ("rotation", "translation", "residual_translation")
T = torch.from_numpy


def _pair(seed=0, **kw):
    jspec, tspec = j_get_model("dmds"), get_model("dmds")
    jp, tp = jspec.params_cls(**CFG, **kw), tspec.params_cls(**CFG, **kw)
    jm = jspec.create_model(jp)
    rng = np.random.default_rng(seed)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 6)), train=False)
    variables = random_bn_stats(v, rng)
    fc2 = variables["params"]["motion"]["fc2"]
    fc2["kernel"] = rng.normal(0, 0.3, fc2["kernel"].shape).astype(np.float32)
    tm = tspec.create_model(tp, "cpu")
    tm.load_state_dict(convert_variables(variables), strict=True)
    return jm, jp, variables, tm, tp


def _frames(seed, B=2):
    return np.random.default_rng(seed).uniform(-1, 1, (B, *HW, 6)).astype(np.float32)


def _assert_outputs_close(got, ref):
    for k in ("depth_a", "depth_b"):
        assert got[k].dtype == torch.float32
        assert_bf16_close(got[k].detach().numpy(), np.asarray(ref[k]))
    for d in ("motion_fwd", "motion_bwd"):
        assert set(got[d]) == set(ref[d]) == set(MOTION)
        for k in MOTION:
            assert got[d][k].dtype == torch.float32, (d, k)
            assert_bf16_close(got[d][k].detach().numpy(), np.asarray(ref[d][k]))


def test_dmds_model_matches_reference():
    jm, _, variables, tm, _ = _pair()
    x = _frames(1)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    assert set(got) == set(ref)
    assert got["depth_a"].shape == (2, *HW, 1)
    assert float(got["motion_fwd"]["rotation"].abs().max()) > 0  # fc2 is not zero here
    _assert_outputs_close(got, ref)


def test_fresh_model_starts_with_zero_ego_motion():
    tm = get_model("dmds").create_model(get_model("dmds").params_cls(**CFG), "cpu")
    assert float(tm.motion.fc2.weight.abs().max()) == 0.0
    assert float(tm.motion.fc1.weight.std()) > 0
    with torch.no_grad():
        out = tm(T(_frames(2)))
    assert float(out["motion_fwd"]["rotation"].abs().max()) == 0.0


def test_train_forward_moves_batch_stats_like_the_reference():
    jm, _, variables, tm, _ = _pair(3)
    x = _frames(4)
    _, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = convert_variables({"params": variables["params"],
                              "batch_stats": jax.device_get(mut["batch_stats"])})
    before = convert_variables(variables)
    with torch.no_grad():
        tm.train()(T(x))
    got = tm.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names and all(k in got for k in names)
    moved = 0
    for k in names:
        g, w, b = got[k].numpy(), want[k].numpy(), before[k].numpy()
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w - b).max() + 1e-6, k
        moved += not np.allclose(w, b)
    assert moved == len(names)  # every BatchNorm ran in training mode
    # Each BatchNorm of the shared nets counts its two calls.
    assert int(got["depth.backbone.stem.bn.num_batches_tracked"]) == 2
    assert int(got["motion.enc0.bn.num_batches_tracked"]) == 2


def _loss_case(seed, B=2, H=24, W=40):
    rng = np.random.default_rng(seed)
    outputs = {"depth_a": rng.uniform(3, 30, (B, H, W, 1)),
               "depth_b": rng.uniform(3, 30, (B, H, W, 1)),
               "motion_fwd": {"rotation": rng.normal(0, 0.01, (B, 3)),
                              "translation": rng.normal(0, 0.3, (B, 3)),
                              "residual_translation": rng.normal(0, 0.05, (B, H, W, 3))},
               "motion_bwd": {"rotation": rng.normal(0, 0.01, (B, 3)),
                              "translation": rng.normal(0, 0.3, (B, 3)),
                              "residual_translation": rng.normal(0, 0.05, (B, H, W, 3))}}
    base = rng.uniform(0, 1, (B, H // 4, W // 4, 6))
    frames = np.repeat(np.repeat(base, 4, 1), 4, 2) + rng.normal(0, 0.02, (B, H, W, 6))
    targets = {"frames": np.clip(frames, 0, 1),
               "intrinsics": np.array([[0.9 * W, 0.9 * W, W / 2, H / 2]] * B)}
    cast = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return cast(outputs), cast(targets)


@pytest.mark.parametrize("object_motion", [True, False])
def test_dmds_loss_and_gradients_match_reference(object_motion):
    outputs, targets = _loss_case(5)
    if not object_motion:
        for d in ("motion_fwd", "motion_bwd"):
            del outputs[d]["residual_translation"]
    kw = dict(predict_object_motion=object_motion, ssim_weight=0.8, weight_cycle=0.3)
    jp = j_get_model("dmds").params_cls(**kw)
    tp = get_model("dmds").params_cls(**kw)
    (jv, jm), jg = jax.value_and_grad(
        lambda o: j_get_model("dmds").loss_fn(o, jax.tree.map(jnp.asarray, targets), jp),
        has_aux=True)(jax.tree.map(jnp.asarray, outputs))
    tout = {k: ({kk: T(vv).requires_grad_() for kk, vv in v.items()} if isinstance(v, dict)
                else T(v).requires_grad_()) for k, v in outputs.items()}
    tv, tm = get_model("dmds").loss_fn(tout, {k: T(v) for k, v in targets.items()}, tp)
    leaves = [(k, kk, t) for k, v in tout.items()
              for kk, t in (v.items() if isinstance(v, dict) else [(None, v)])]
    grads = torch.autograd.grad(tv, [t for *_, t in leaves])
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    for (k, kk, _), g in zip(leaves, grads):
        want = np.asarray(jg[k] if kk is None else jg[k][kk])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"{k}/{kk}")


def _raw(seed, yuv420=False, B=2):
    b = j_synthetic_batch(np.random.default_rng(seed), B, PAD, num_classes=3, two_frame=True,
                          yuv420=yuv420)
    keys = ("y", "u", "v", "y_t1", "u_t1", "v_t1") if yuv420 else ("image", "image_t1")
    return {k: b[k] for k in keys + ("image_hw", "intrinsics", "depth")}


def _dmds_draws(key, B, aug):
    """The ROI numbers the reference's DMDS processor draws from ``key``
    (``make_rois`` -> ``jittered_roi``; no photometric stage)."""
    rows = []
    for k in jax.random.split(key, B):
        k_s, k_y, k_x, k_f = jax.random.split(k, 4)
        rows.append((jax.random.uniform(k_s, (), jnp.float32, *aug.scale_range),
                     jax.random.uniform(k_y, (), jnp.float32, -aug.shift_frac, aug.shift_frac),
                     jax.random.uniform(k_x, (), jnp.float32, -aug.shift_frac, aug.shift_frac),
                     jax.random.bernoulli(k_f, aug.flip_prob)))
    return RoiDraws(*(T(np.stack([np.asarray(r[i]) for r in rows])) for i in range(4)))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("yuv420", [False, True])
def test_dmds_processor_matches_reference_on_given_draws(train, yuv420):
    from cvm_tpu.pipeline.preprocess import aug_from_params as j_aug

    B = 3
    raw = _raw(20 + 2 * train + yuv420, yuv420, B)
    raw.pop("depth")
    key = jax.random.PRNGKey(7)
    jp = j_get_model("dmds").params_cls(**CFG, aug_scale_range=(0.8, 1.3), aug_shift_frac=0.1)
    tp = get_model("dmds").params_cls(**CFG, aug_scale_range=(0.8, 1.3), aug_shift_frac=0.1)
    rin, rt = j_get_model("dmds").make_processor(jp, train)(
        key if train else None, {k: jnp.asarray(v) for k, v in raw.items()})
    draws = _dmds_draws(key, B, j_aug(jp, flip_prob=0.0)) if train else None
    tin, tt = get_model("dmds").make_processor(tp, train)(None, {k: T(v) for k, v in raw.items()},
                                                          draws=draws)
    assert tin.shape == (B, *HW, 6) and set(tt) == {"frames", "intrinsics"}
    np.testing.assert_allclose(tin.numpy(), np.asarray(rin), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt["frames"].numpy(), np.asarray(rt["frames"]), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tt["intrinsics"].numpy(), np.asarray(rt["intrinsics"]),
                               atol=1e-5, rtol=1e-6)
    if train:
        assert not bool(draws.flip.any())


def test_dmds_processor_draws_its_own_jitter():
    proc = get_model("dmds").make_processor(get_model("dmds").params_cls(**CFG), True)
    raw = {k: T(v) for k, v in _raw(3).items()}
    a = proc(torch.Generator().manual_seed(1), raw)
    b = proc(torch.Generator().manual_seed(1), raw)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert torch.isfinite(a[1]["intrinsics"]).all()


def test_two_dmds_train_steps_match_reference():
    kw = dict(CFG, optimizer="sgd", lr_schedule="constant", warmup_steps=1,
              learning_rate=0.02, weight_decay=1e-3, ema_decay=0.9)
    jspec, tspec = j_get_model("dmds"), get_model("dmds")
    jp, tp = jspec.params_cls(**kw), tspec.params_cls(**kw)
    jmodel = jspec.create_model(jp)
    raw = {k: jnp.asarray(v) for k, v in _raw(5).items()}
    inputs, targets = jax.jit(jspec.make_processor(jp, train=True))(jax.random.PRNGKey(3), raw)
    tx = j_make_optimizer(jp.learning_rate, jp.total_steps, jp.warmup_steps, jp.weight_decay,
                          lr_schedule="constant", optimizer="sgd")
    state = jax.jit(lambda: j_create_state(jmodel, jp, tx, jnp.zeros((1, *HW, 6)),
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
    t_in = T(np.array(inputs))
    t_tg = {k: T(np.array(v)) for k, v in targets.items()}
    opt = make_optimizer(list(model.parameters()), tp.learning_rate, tp.total_steps,
                         tp.warmup_steps, tp.weight_decay, lr_schedule="constant",
                         optimizer="sgd")
    tstate = create_train_state(model, tp, opt)
    tstep = make_train_step(tspec.loss_fn, tp, lambda gen, raw, rows: (t_in, t_tg))
    for jm in jmetrics:
        tstate, m = tstep(tstate, None, None)
        tm = {k: float(v) for k, v in m.items()}
        assert set(tm) == set(jm)
        for k in jm:
            rtol = 5e-2 if k == "grad_norm" else 1e-2
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, atol=1e-6, err_msg=k)
    assert tstate.step == 2


def test_evaluate_model_dmds_with_injected_depth_is_exact():
    val = [j_synthetic_batch(np.random.default_rng(s), 2, PAD, num_classes=3, two_frame=True)
           for s in (30, 31)]
    rng = np.random.default_rng(6)
    preds = [{"depth": rng.uniform(0.5, 3.0, (2, *HW, 1)).astype(np.float32)} for _ in val]
    it = iter(preds)
    jcfg = j_get_model("dmds").params_cls(**CFG)
    ref = j_eval.evaluate_model(j_get_model("dmds"), jcfg, None, val,
                                predict_fn=lambda b: next(it))
    it = iter(preds)
    got = t_eval.evaluate_model("dmds", get_model("dmds").params_cls(**CFG), None, val,
                                device="cpu", predict_fn=lambda b: next(it))
    assert set(got) == {"abs_rel", "sq_rel", "rmse", "delta1", "delta2", "delta3"}
    assert got == ref


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_dmds_pipeline_matches_reference_and_refuses(fmt):
    jm, jp, variables, tm, tp = _pair(7)
    raw = _raw(8, yuv420=fmt == "yuv420")
    jres = JPipeline(j_get_model("dmds"), jp, variables, input_format=fmt)(raw)
    pipe = InferencePipeline(tp, tm, "cpu", input_format=fmt)
    got = pipe(raw)
    assert set(got) == set(jres) == {"depth", "rotation", "translation"}
    for k in got:
        assert_bf16_close(got[k].numpy(), np.asarray(jres[k]))
    with pytest.raises(ValueError, match="incompatible with dmds"):
        InferencePipeline(tp, tm, "cpu", tta="hflip")
    for w8a8 in (True, {"motion.enc0.conv": 0.1}):
        with pytest.raises(ValueError, match="not supported for two-frame dmds"):
            InferencePipeline(tp, tm, "cpu", w8a8=w8a8)
