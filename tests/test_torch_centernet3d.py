"""The monocular 3D CenterNet heads (cvm_tpu_torch) against the reference,
on the CPU at a tiny size (``backbone="tiny"``, 64x64, batches of 2-3).

* The extras scatter (depth3d, dims3d, rot at the integer centres) equals
  the reference's exactly where centres do not collide (where two objects
  share a centre, which one lands is unspecified on both sides).
* ``decode_centernet_3d`` on injected logits: the same detections as
  ``decode_centernet`` (and the reference's), ``centers3d``, ``dims`` and
  ``yaw`` within 1e-5.
* The 3D loss terms and their gradients with respect to every head,
  against ``jax.value_and_grad``: rtol 1e-4.
* The 3D model's forward on converted variables (random BatchNorm
  statistics): every head within ``assert_bf16_close``.
* The processor on the reference's draws (flips on some images): images
  within 1e-6 (the eval letterbox) and 1e-4 (training, the photometric
  jitter, as ``tests/test_torch_processor.py``), the GT maps as there, the
  extras exactly where centres are unique (the rotation's sin / cos within
  1e-6: two libraries' sin).
* Two training steps against the reference's: every metric within rtol
  1e-2, ``grad_norm`` within 5% (``tests/test_torch_zoo_train.py``).
* ``evaluate_model`` with the same injected predictions: exactly the
  reference's metrics, the three 3D metrics included.
* The 3D serving postprocess on the reference's heads: boxes, scores,
  classes and the 3D outputs within 1e-5 of the reference's; the fused
  int8 posture makes exactly the reference interceptor's number of K2
  calls (the three 3D heads add one each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvm_tpu.ops.pallas.fused_qconv as j_kernel_mod
from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline, _postprocess
from cvm_tpu.infer.quantize import calibrate_activation_scales as j_calibrate
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.models.centernet import loss as jl
from cvm_tpu.ops import decode as jdecode
from cvm_tpu.ops.heatmap import CenternetTargets as JTargets
from cvm_tpu.ops.heatmap import render_centernet_targets_batch as j_render
from cvm_tpu.pipeline.preprocess import preprocess_image_batch as j_preprocess
from cvm_tpu.train import evaluate as j_eval
from cvm_tpu.train.loop import create_train_state as j_create_state
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu.train.optim import make_optimizer as j_make_optimizer
from cvm_tpu_torch.convert import convert_scales, convert_variables
from cvm_tpu_torch.infer import quantize as t_quantize
from cvm_tpu_torch.infer.pipeline import InferencePipeline, postprocess
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.centernet import loss as tl
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops import decode as tdecode
from cvm_tpu_torch.ops.heatmap import (CenternetTargets, render_centernet_targets,
                                       render_centernet_targets_batch)
from cvm_tpu_torch.pipeline.preprocess import aug_from_params, preprocess_image_batch
from cvm_tpu_torch.train import evaluate as t_eval
from cvm_tpu_torch.train.loop import create_train_state, make_train_step
from cvm_tpu_torch.train.optim import make_optimizer
from test_torch_loss import case
from test_torch_model import assert_bf16_close, random_bn_stats
from test_torch_processor import _unique_centres, assert_processed_close, jax_draws

HW = (64, 64)
PAD = (80, 96)
CFG = dict(input_hw=HW, num_classes=3, backbone="tiny", neck_features=16, head_features=8,
           top_k=10, batch_size=2, max_objects=8, with_3d=True)
KEYS = ("image", "image_hw", "boxes", "classes", "num_objects", "loc3d", "dims3d", "rot_y",
        "intrinsics")
HEADS_3D = ("depth3d", "dims3d", "rot")
T = torch.from_numpy


def _raw(seed, B=2):
    raw = j_synthetic_batch(np.random.default_rng(seed), B, PAD, num_classes=3, max_objects=8,
                            with_3d=True)
    return {k: raw[k] for k in KEYS}


def _torch_targets(t):
    """The reference's CenternetTargets (with extras) as the port's."""
    return CenternetTargets(*(T(np.array(f)) for f in t[:6]),
                            {k: T(np.array(v)) for k, v in t.extras.items()})


def test_extras_scatter_matches_reference_where_centres_are_unique():
    rng = np.random.default_rng(0)
    B, K, hs, ws = 3, 12, 16, 16
    xy = rng.uniform(-1, 15, (B, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 6, (B, K, 2))], -1).astype(np.float32)
    classes = rng.integers(0, 3, (B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) < 0.8
    boxes[0, 1], valid[0, :2] = boxes[0, 0] + 0.1, True  # two objects share a centre
    extra = {"depth3d": rng.uniform(2, 80, (B, K, 1)), "dims3d": rng.uniform(1, 5, (B, K, 3)),
             "rot": rng.uniform(-1, 1, (B, K, 2))}
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    ref = j_render(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid), (hs, ws), 3,
                   0.7, {k: jnp.asarray(v) for k, v in extra.items()})
    got = render_centernet_targets_batch(T(boxes), T(classes), T(valid), (hs, ws), 3, 0.7,
                                         extra_values={k: T(v) for k, v in extra.items()})
    keep = _unique_centres(got)
    assert (~keep).any() and keep.any()  # some centres collide: those are skipped
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    for k in extra:
        g, r = got.extras[k].numpy(), np.asarray(ref.extras[k])
        assert g.shape == r.shape == (B, hs, ws, extra[k].shape[-1])
        np.testing.assert_array_equal(g[keep], r[keep], err_msg=k)
    one = render_centernet_targets(T(boxes[0]), T(classes[0]), T(valid[0]), (hs, ws), 3,
                                   extra_values={k: T(v[0]) for k, v in extra.items()})
    for k in extra:
        torch.testing.assert_close(one.extras[k], got.extras[k][0], rtol=0, atol=0)
    assert render_centernet_targets_batch(T(boxes), T(classes), T(valid), (hs, ws),
                                          3).extras is None


def _heads3d(seed, B=2, hs=16, ws=16, C=3):
    rng = np.random.default_rng(seed)
    heads = {"heatmap": rng.normal(-3, 2, (B, hs, ws, C)),
             "offset": rng.uniform(0, 1, (B, hs, ws, 2)),
             "size": rng.uniform(1, 8, (B, hs, ws, 2)),
             "depth3d": rng.normal(-2, 1, (B, hs, ws, 1)),
             "dims3d": rng.uniform(1, 5, (B, hs, ws, 3)),
             "rot": rng.normal(0, 1, (B, hs, ws, 2))}
    return {k: v.astype(np.float32) for k, v in heads.items()}


def test_decode_centernet_3d_matches_reference():
    h = _heads3d(1)
    intr = np.array([[60.0, 58.0, 31.5, 30.0], [90.0, 90.0, 33.0, 28.5]], np.float32)
    args = [h[k] for k in ("heatmap", "offset", "size") + HEADS_3D]
    got = tdecode.decode_centernet_3d(*map(T, args), T(intr), stride=4, top_k=10)
    ref = jdecode.decode_centernet_3d(*map(jnp.asarray, args), jnp.asarray(intr), stride=4,
                                      top_k=10)
    plain = tdecode.decode_centernet(T(h["heatmap"]), T(h["offset"]), T(h["size"]), stride=4,
                                     top_k=10)
    for f in ("boxes", "scores", "classes"):
        torch.testing.assert_close(getattr(got.det, f), getattr(plain, f), rtol=0, atol=0)
    np.testing.assert_array_equal(got.det.classes.numpy(), np.asarray(ref.det.classes))
    np.testing.assert_allclose(got.det.scores.numpy(), np.asarray(ref.det.scores), atol=1e-6)
    np.testing.assert_allclose(got.det.boxes.numpy(), np.asarray(ref.det.boxes), atol=1e-5)
    for f in ("centers3d", "dims", "yaw"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    ex_got = tdecode.decode_centernet_with_extras(T(h["heatmap"]), T(h["offset"]),
                                                  T(h["size"]), 4, {"rot": T(h["rot"])}, 10)[1]
    ex_ref = jdecode.decode_centernet_with_extras(
        jnp.asarray(h["heatmap"]), jnp.asarray(h["offset"]), jnp.asarray(h["size"]), 4,
        {"rot": jnp.asarray(h["rot"])}, 10)[1]
    np.testing.assert_array_equal(ex_got["rot"].numpy(), np.asarray(ex_ref["rot"]))


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=rel)


def test_3d_loss_terms_and_gradients_match_reference():
    outputs, targets = case(4)
    rng = np.random.default_rng(4)
    B, H, W = targets["mask"].shape
    outputs.update({"depth3d": rng.normal(-2, 1, (B, H, W, 1)).astype(np.float32),
                    "dims3d": rng.normal(2, 1, (B, H, W, 3)).astype(np.float32),
                    "rot": rng.normal(0, 1, (B, H, W, 2)).astype(np.float32)})
    extras = {"depth3d": rng.uniform(2, 60, (B, H, W, 1)).astype(np.float32),
              "dims3d": rng.uniform(1, 5, (B, H, W, 3)).astype(np.float32),
              "rot": rng.uniform(-1, 1, (B, H, W, 2)).astype(np.float32)}
    kw = dict(with_3d=True, weight_depth3d=0.7, weight_dims3d=1.3, weight_rot=0.5)
    jp, tp = j_get_model("centernet").params_cls(**kw), CenternetParams(**kw)
    jt = JTargets(**{k: jnp.asarray(v) for k, v in targets.items()},
                  extras={k: jnp.asarray(v) for k, v in extras.items()})
    tt = CenternetTargets(**{k: T(v) for k, v in targets.items()},
                          extras={k: T(v) for k, v in extras.items()})
    (jv, jm), jg = jax.value_and_grad(lambda o: jl.centernet_loss(o, jt, jp), has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    tout = {k: T(v).requires_grad_() for k, v in outputs.items()}
    tv, tm = tl.centernet_loss(tout, tt, tp)
    grads = torch.autograd.grad(tv, list(tout.values()))
    assert set(tm) == set(jm) == {"loss", "loss_hm", "loss_off", "loss_size", "loss_dep3d",
                                  "loss_dim3d", "loss_rot"}
    for k in jm:
        _close(tm[k].detach().numpy(), jm[k])
    for k, g in zip(tout, grads):
        _close(g.numpy(), jg[k])
    # Without extras in the targets the 3D terms are skipped, as the reference's.
    tv2, tm2 = tl.centernet_loss(tout, tt._replace(extras=None), tp)
    assert "loss_dep3d" not in tm2 and float(tv2.detach()) < float(tv.detach())


def _pair(seed=0):
    jspec = j_get_model("centernet")
    jp = jspec.params_cls(**CFG)
    jm = jspec.create_model(jp)
    rng = np.random.default_rng(seed)
    variables = random_bn_stats(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 3)),
                                        train=False), rng)
    tm = get_model("centernet").create_model(CenternetParams(**CFG), "cpu")
    tm.load_state_dict(convert_variables(variables), strict=True)
    return jspec, jp, jm, variables, tm.eval()


def test_3d_model_matches_reference():
    _, _, jm, variables, tm = _pair()
    x = np.random.default_rng(1).uniform(-1, 1, (2, *HW, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    assert set(got) == set(ref) == {"heatmap", "offset", "size"} | set(HEADS_3D)
    for k in ref:
        assert got[k].dtype == torch.float32
        assert_bf16_close(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("train", [False, True])
def test_3d_processor_matches_reference_on_given_draws(train):
    B = 3
    raw = _raw(11 + train, B)
    key = jax.random.PRNGKey(2)
    jp, tp = j_get_model("centernet").params_cls(**CFG), CenternetParams(**CFG)
    ref = j_get_model("centernet").make_processor(jp, train)(
        key if train else None, {k: jnp.asarray(v) for k, v in raw.items()})
    draws = jax_draws(key, B, tp.input_hw, aug_from_params(tp)) if train else None
    if train:
        assert 0 < int(draws.roi.flip.sum()) < B  # the cosine's sign flips on some
    got = get_model("centernet").make_processor(tp, train)(
        None, {k: T(v) for k, v in raw.items()}, draws=draws)
    if not train:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6, rtol=0)
    assert_processed_close(got, ref)
    keep = _unique_centres(got[1])
    for k in HEADS_3D:
        g, r = got[1].extras[k].numpy(), np.asarray(ref[1].extras[k])
        assert g.shape == r.shape
        np.testing.assert_allclose(g[keep], r[keep], atol=1e-6 if k == "rot" else 0, rtol=0,
                                   err_msg=k)


def test_3d_processor_refuses_rotation_with_the_reference_message():
    with pytest.raises(ValueError, match="aug_rotate_deg is incompatible with with_3d"):
        get_model("centernet").make_processor(CenternetParams(with_3d=True,
                                                              aug_rotate_deg=5.0), True)


def test_two_3d_train_steps_match_reference():
    kw = dict(CFG, optimizer="sgd", lr_schedule="constant", warmup_steps=1,
              learning_rate=0.02, weight_decay=1e-3, ema_decay=0.9)
    jspec = j_get_model("centernet")
    jp, tp = jspec.params_cls(**kw), CenternetParams(**kw)
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

    model = get_model("centernet").create_model(tp, "cpu")
    model.load_state_dict(convert_variables(v0), strict=True)
    t_in, t_tg = T(np.array(inputs)), _torch_targets(targets)
    opt = make_optimizer(list(model.parameters()), tp.learning_rate, tp.total_steps,
                         tp.warmup_steps, tp.weight_decay, lr_schedule="constant",
                         optimizer="sgd")
    tstate = create_train_state(model, tp, opt)
    tstep = make_train_step(tl.centernet_loss, tp, lambda gen, raw, rows: (t_in, t_tg))
    for jm in jmetrics:
        tstate, m = tstep(tstate, None, None)
        tm = {k: float(v) for k, v in m.items()}
        assert set(tm) == set(jm) and "loss_dep3d" in tm
        for k in jm:
            rtol = 5e-2 if k == "grad_norm" else 1e-2
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, atol=1e-6, err_msg=k)


def test_evaluate_model_3d_with_injected_predictions_is_exact():
    val = [j_synthetic_batch(np.random.default_rng(s), 2, PAD, num_classes=3, max_objects=8,
                             with_3d=True) for s in (7, 8)]
    rng = np.random.default_rng(9)
    preds = []
    for b in val:
        B, K = b["boxes"].shape[:2]
        boxes = b["boxes"] + rng.normal(0, 1.5, b["boxes"].shape).astype(np.float32)
        scores = rng.uniform(0.2, 1, (B, K)).astype(np.float32)
        scores[b["num_objects"][:, None] <= np.arange(K)[None]] = 0.01
        classes = np.where(rng.uniform(size=(B, K)) < 0.85, b["classes"], 2).astype(np.int32)
        centers = (b["loc3d"] + rng.normal(0, 0.8, b["loc3d"].shape)).astype(np.float32)
        preds.append({"boxes": boxes, "scores": scores, "classes": classes,
                      "centers3d": centers})
    it = iter(preds)
    jcfg = j_get_model("centernet").params_cls(**CFG)
    ref = j_eval.evaluate_model(j_get_model("centernet"), jcfg, None, val,
                                predict_fn=lambda b: next(it))
    it = iter(preds)
    got = t_eval.evaluate_model("centernet", CenternetParams(**CFG), None, val, device="cpu",
                                predict_fn=lambda b: next(it))
    assert {"center_err_3d_m", "depth3d_abs_rel", "matched_3d_frac", "mAP"} <= set(got)
    assert got == ref and 0 < got["matched_3d_frac"] <= 1


def test_3d_serving_postprocess_matches_reference_on_the_same_heads():
    raw = _raw(13)
    intr = raw["intrinsics"]
    jproc, jrois = j_preprocess(None, jnp.asarray(raw["image"]), jnp.asarray(raw["image_hw"]),
                                HW, train=False)
    h = _heads3d(2, hs=16, ws=16)
    jp = j_get_model("centernet").params_cls(**CFG)
    ref = _postprocess("centernet", jp, {k: jnp.asarray(v) for k, v in h.items()}, jrois,
                       jnp.asarray(intr))
    _, rois = preprocess_image_batch(T(raw["image"]), T(raw["image_hw"]), HW)
    got = postprocess(CenternetParams(**CFG), {k: T(v) for k, v in h.items()}, rois, T(intr))
    assert set(got) == set(ref) == {"boxes", "scores", "classes", "centers3d", "dims", "yaw"}
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(ref["classes"]))
    for k in ("boxes", "scores", "centers3d", "dims", "yaw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_3d_pipeline_postures_and_fused_call_count(monkeypatch):
    jspec, jp, jm, variables, tm = _pair(3)
    rng = np.random.default_rng(4)
    cal = [rng.uniform(-1, 1, (2, *HW, 3)).astype(np.float32) for _ in range(2)]
    jscales = j_calibrate(lambda x: jm.apply(variables, x, train=False),
                          [jnp.asarray(c) for c in cal])
    raw = _raw(14)
    j_calls, t_calls = [], []
    j_real, t_real = j_kernel_mod.fused_qconv, t_quantize.fused_qconv
    monkeypatch.setattr(j_kernel_mod, "fused_qconv",
                        lambda *a, **kw: (j_calls.append(1), j_real(*a, **kw))[1])
    monkeypatch.setattr(t_quantize, "fused_qconv",
                        lambda *a, **kw: (t_calls.append(1), t_real(*a, **kw))[1])
    jpipe = JPipeline(jspec, jp, variables, input_format="rgb", w8a8=jscales, w8a8_fused=True,
                      w8a8_chain=True)
    jres = jpipe({k: raw[k] for k in ("image", "image_hw", "intrinsics")})
    pipe = InferencePipeline(CenternetParams(**CFG), tm, "cpu", input_format="rgb",
                             w8a8=convert_scales(jscales), w8a8_fused=True, w8a8_chain=True)
    res = pipe(raw)
    # The 2D tiny model's 22 calls plus one per 3D head's c1.
    assert pipe.fused_counts["calls"] == len(t_calls) == len(j_calls) == 25
    assert set(res) == set(jres)
    for k, v in res.items():
        assert v.shape == np.asarray(jres[k]).shape and torch.isfinite(v.float()).all(), k
    assert pipe.keys == ("image", "image_hw", "intrinsics")
    fp = InferencePipeline(CenternetParams(**CFG), tm, "cpu", input_format="rgb", fold_bn=True)
    placeholder = fp({k: raw[k] for k in ("image", "image_hw")})  # intrinsics [1, 1, 0, 0]
    assert placeholder["centers3d"].shape == (2, CFG["top_k"], 3)
    with pytest.raises(ValueError, match="with_3d"):
        InferencePipeline(CenternetParams(**CFG), tm, "cpu", tta="hflip")
