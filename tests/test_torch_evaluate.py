"""The evaluation slice of cvm_tpu_torch against the reference, on the CPU at
a tiny size (``backbone="tiny"``, 32x32 input, batches of 2).

* The evaluators are verbatim copies: the same random detections and GT
  give equal metric dicts, with no tolerance.
* ``evaluate_model`` with the same injected predictions (``predict_fn``)
  gives exactly the reference's metrics; with the model, from the same
  weights (a tiny model trained 100 steps here, so that mAP is not 0) and
  the same 16 scenes, in RGB and yuv420 (auto-detected), fp and fold_bn,
  mAP, mAP50 and mAP75 agree within 0.03. XLA's CPU backend does not round
  the reference's bf16 head convs to bf16 while the port does (as the card
  does), so near-equal scores reorder and a box can cross an IoU threshold;
  on this weak model many boxes sit near one (measured: up to 0.016 in
  mAP50, with BN folded, and 0.003 in mAP).
* From ``.cvrec`` shards: the port's and the reference's ``RecordLoader``
  over the same shard feed each side's ``evaluate_model``: exactly equal
  metrics with the same injected predictions, and within 0.03 (as above)
  through the trained model, in RGB and yuv420.
* ``tta="hflip"`` heads within 3% of the head's magnitude (one bf16 step,
  as ``tests/test_torch_slice.py``); the fused int8 posture's heads within
  6% (a bf16 step upstream can move an activation by one lattice step).
* Weight-only int8: int8 values and dequantized weights equal, scales
  within 1e-7 relative, the error metric within 1e-6.
* ``average_checkpoints``: the float64 mean cast back; integers, step and
  optimizer state from the newest checkpoint.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline
from cvm_tpu.infer.quantize import calibrate_activation_scales as j_calibrate
from cvm_tpu.infer.quantize import dequantize_params as j_dequantize
from cvm_tpu.infer.quantize import quantization_error as j_quant_error
from cvm_tpu.infer.quantize import quantize_params as j_quantize
from cvm_tpu.models import get_model
from cvm_tpu.pipeline.preprocess import preprocess_image_batch as j_preprocess
from cvm_tpu.train import evaluate as j_eval
from cvm_tpu_torch.convert import convert_scales, flax_path_to_module_name
from cvm_tpu_torch.data.synthetic import SyntheticIterator, synthetic_batch
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.quantize import dequantize_params, quantization_error, quantize_params
from cvm_tpu_torch.models import get_model as t_get_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.pipeline.preprocess import preprocess_image_batch
from cvm_tpu_torch.train import evaluate as t_eval
from cvm_tpu_torch.train.average import average_checkpoints
from cvm_tpu_torch.train.loop import Trainer

CFG = dict(input_hw=(32, 32), num_classes=3, backbone="tiny", neck_features=16,
           head_features=8, top_k=20, batch_size=2)
PAD = (48, 48)


def to_flax(template, sd):
    """The port's ``state_dict`` as flax variables shaped like ``template``
    (the inverse of ``convert_variables``)."""
    def t(name):
        return np.asarray(sd[name].detach().numpy(), np.float32)

    def params(node, path):
        name = flax_path_to_module_name("/".join(path))
        if "kernel" in node:
            out = {"kernel": t(f"{name}.weight").transpose(2, 3, 1, 0)}
            if "bias" in node:
                out["bias"] = t(f"{name}.bias")
            return out
        if "scale" in node:
            return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}
        return {k: params(v, path + (k,)) for k, v in node.items()}

    def stats(node, path):
        if "mean" in node:
            name = flax_path_to_module_name("/".join(path))
            return {"mean": t(f"{name}.running_mean"), "var": t(f"{name}.running_var")}
        return {k: stats(v, path + (k,)) for k, v in node.items()}

    return {"params": params(template["params"], ()),
            "batch_stats": stats(template["batch_stats"], ())}


@pytest.fixture(scope="module")
def trained():
    """A tiny CenterNet trained 100 steps (mAP50 ~0.4), as the port's eval
    model and as flax variables; the reference's spec and config."""
    cfg = CenternetParams(**dict(CFG, batch_size=4, learning_rate=3e-3, warmup_steps=5,
                                 total_steps=100))
    tr = Trainer(cfg, "cpu", log_every=1000)
    tr.init_state()
    tr.fit(SyntheticIterator(0, 4, PAD, num_classes=3), 100)
    model = tr.eval_model()
    spec = get_model("centernet")
    jp = spec.params_cls(**CFG)
    template = jax.device_get(spec.create_model(jp).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    return spec, jp, CenternetParams(**CFG), model, to_flax(template, model.state_dict())


def random_image(rng, n_gt, n_det, n_classes=4):
    """Detections near (and away from) random GT boxes, xyxy."""
    xy = rng.uniform(0, 200, (n_gt, 2))
    wh = rng.uniform(4, 150, (n_gt, 2))
    gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    gt_c = rng.integers(0, n_classes - 1, n_gt)          # the last class never has GT
    src = rng.integers(0, max(n_gt, 1), n_det)
    near = gt[src] + rng.normal(0, 6, (n_det, 4)) if n_gt else rng.uniform(0, 300, (n_det, 4))
    far = rng.uniform(0, 300, (n_det, 4))
    pick = rng.uniform(size=(n_det, 1)) < 0.7
    det = np.where(pick, near, far).astype(np.float32)
    det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
    det_c = np.where(rng.uniform(size=n_det) < 0.8, gt_c[src] if n_gt else 0,
                     rng.integers(0, n_classes, n_det))
    scores = rng.uniform(0, 1, n_det).astype(np.float32)
    return det, scores, det_c, gt, gt_c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_evaluator_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    pairs = [(j_eval.DetectionEvaluator(4), t_eval.DetectionEvaluator(4)) for _ in range(2)]
    for i in range(6):
        det, scores, det_c, gt, gt_c = random_image(rng, i % 4 * 2, 12)
        ignore = rng.uniform(size=len(gt)) < 0.3
        for (j, t), kw in zip(pairs, ({}, {"gt_ignore": ignore, "det_area_range": (0, 64 ** 2)})):
            j.add_image(det, scores, det_c, gt, gt_c, **kw)
            t.add_image(det, scores, det_c, gt, gt_c, **kw)
    for j, t in pairs:
        for per_class in (False, True):
            assert t.compute(per_class=per_class) == j.compute(per_class=per_class)
        assert t.pr_curves() == j.pr_curves()
        assert 0.0 < t.compute()["mAP"] < 1.0
    np.testing.assert_array_equal(t_eval.box_iou_matrix(det, gt), j_eval.box_iou_matrix(det, gt))


def _replay(outputs):
    it = iter(outputs)
    return lambda batch: next(it)


def test_evaluate_model_with_injected_predictions_is_exact():
    cfg = CenternetParams(**CFG)
    jp = get_model("centernet").params_cls(**CFG)
    rng = np.random.default_rng(3)
    batches, preds = [], []
    for _ in range(3):
        b = synthetic_batch(rng, 2, PAD, num_classes=3)
        out = {"boxes": [], "scores": [], "classes": []}
        for i in range(2):
            n = int(b["num_objects"][i])
            det, scores, det_c, *_ = random_image(rng, 0, 20, 3)
            det[:n] = b["boxes"][i][:n] + rng.normal(0, 1.5, (n, 4))
            det_c[:n] = b["classes"][i][:n]
            for k, v in zip(out, (det, scores, det_c)):
                out[k].append(v)
        batches.append(b)
        preds.append({k: np.stack(v) for k, v in out.items()})
    kw = dict(max_batches=3, per_class=True, size_buckets=True, pr_curves=True)
    stats = {}
    got = t_eval.evaluate_model("centernet", cfg, None, batches, device="cpu",
                                predict_fn=_replay(preds), stats=stats, **kw)
    ref = j_eval.evaluate_model(get_model("centernet"), jp, None, batches,
                                predict_fn=_replay(preds), **kw)
    assert got == ref
    assert stats["batches"] == 3 and stats["predict_s"] >= 0 and stats["evaluator_s"] > 0
    assert 0.02 < got["mAP"] < 1.0 and "mAP_small" in got and got["pr_curves"]["classes"]


@pytest.mark.parametrize("fmt,fold_bn", [("rgb", False), ("rgb", True), ("yuv420", False),
                                         ("yuv420", True)])
def test_evaluate_model_matches_reference(trained, fmt, fold_bn):
    spec, jp, cfg, model, variables = trained
    rng = np.random.default_rng(999)
    val = [j_synthetic_batch(rng, 2, PAD, 3, yuv420=fmt == "yuv420") for _ in range(8)]
    ref = j_eval.evaluate_model(spec, jp, variables, val, fold_bn=fold_bn)
    got = t_eval.evaluate_model("centernet", cfg, model, val, device="cpu", fold_bn=fold_bn)
    assert set(got) == set(ref) == {"mAP", "mAP50", "mAP75"}
    assert got["mAP50"] > 0.15
    for k in ref:
        assert abs(got[k] - ref[k]) <= 0.03, (k, got[k], ref[k])


def _record_loaders(tmp_path, fmt):
    from cvm_tpu.data.loader import RecordLoader as RefLoader
    from cvm_tpu.data.records import RecordDataset as RefDataset
    from cvm_tpu_torch.data.loader import RecordLoader
    from cvm_tpu_torch.data.records import RecordDataset

    from test_torch_records import load_reference_decoder, make_shard

    load_reference_decoder()  # the reference loader's, never its PIL fallback
    path = make_shard(tmp_path / "val.cvrec", [(40, 44), (48, 46), (90, 88), (36, 48)] * 4,
                      seed=12)
    kw = dict(batch_size=2, pad_hw=PAD, shuffle=False, loop=False, max_objects=8,
              output_format=fmt)
    return RecordLoader(RecordDataset([path]), **kw), RefLoader(RefDataset([path]), **kw)


def test_evaluate_model_from_records_with_injected_predictions_is_exact(tmp_path):
    cfg = CenternetParams(**CFG)
    jp = get_model("centernet").params_cls(**CFG)
    port, ref = _record_loaders(tmp_path, "rgb")
    rng = np.random.default_rng(4)
    preds = []
    for b in ref:
        out = {"boxes": [], "scores": [], "classes": []}
        for i in range(2):
            n = int(b["num_objects"][i])
            det, scores, det_c, *_ = random_image(rng, 0, 20, 3)
            det[:n] = b["boxes"][i][:n] + rng.normal(0, 1.5, (n, 4))
            det_c[:n] = b["classes"][i][:n]
            for k, v in zip(out, (det, scores, det_c)):
                out[k].append(v)
        preds.append({k: np.stack(v) for k, v in out.items()})
    got = t_eval.evaluate_model("centernet", cfg, None, port, device="cpu",
                                predict_fn=_replay(preds), per_class=True)
    want = j_eval.evaluate_model(get_model("centernet"), jp, None, ref,
                                 predict_fn=_replay(preds), per_class=True)
    assert got == want and 0.02 < got["mAP"] < 1.0


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_evaluate_model_from_records_matches_reference(trained, tmp_path, fmt):
    spec, jp, cfg, model, variables = trained
    port, ref = _record_loaders(tmp_path, fmt)
    want = j_eval.evaluate_model(spec, jp, variables, ref)
    got = t_eval.evaluate_model("centernet", cfg, model, port, device="cpu")
    assert set(got) == set(want) == {"mAP", "mAP50", "mAP75"}
    assert got["mAP50"] > 0.1
    for k in want:
        assert abs(got[k] - want[k]) <= 0.03, (k, got[k], want[k])


def _reference_heads(spec, jp, variables, proc, **kw):
    pipe = JPipeline(spec, jp, variables, input_format="rgb", **kw)
    return jax.jit(lambda v, x: pipe._apply(v, x, train=False))(pipe._variables, proc)


def _rgb_inputs(jp):
    b = synthetic_batch(np.random.default_rng(7), 2, PAD, num_classes=3)
    jproc, _ = j_preprocess(None, jnp.asarray(b["image"]), jnp.asarray(b["image_hw"]),
                            jp.input_hw, train=False, out_dtype=jnp.bfloat16)
    tproc, _ = preprocess_image_batch(torch.from_numpy(b["image"]),
                                      torch.from_numpy(b["image_hw"]), jp.input_hw,
                                      out_dtype=torch.bfloat16)
    return b, jproc, tproc


def _heads_close(got, ref, tol):
    for k in ("heatmap", "offset", "size"):
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape
        assert np.abs(got[k].numpy() - r).max() <= tol * np.abs(r).max(), k


def test_tta_hflip_heads_match_reference(trained):
    spec, jp, cfg, model, variables = trained
    _, jproc, tproc = _rgb_inputs(jp)
    ref = _reference_heads(spec, jp, variables, jproc, tta="hflip")
    pipe = InferencePipeline(cfg, model, "cpu", input_format="rgb", tta="hflip")
    with torch.no_grad():
        got = pipe.heads(tproc)
        plain = InferencePipeline(cfg, model, "cpu", input_format="rgb").heads(tproc)
    _heads_close(got, ref, 0.03)
    torch.testing.assert_close(got["offset"], plain["offset"], rtol=0, atol=0)
    assert not torch.equal(got["heatmap"], plain["heatmap"])
    with pytest.raises(ValueError, match="none|hflip"):
        InferencePipeline(cfg, model, "cpu", tta="vflip")


def test_w8a8_fused_chain_posture_in_evaluate_model(trained):
    spec, jp, cfg, model, variables = trained
    b, jproc, tproc = _rgb_inputs(jp)
    jscales = j_calibrate(lambda x: spec.create_model(jp).apply(variables, x, train=False),
                          [jproc.astype(jnp.float32)])
    scales = convert_scales(jscales)
    kw = dict(w8a8_fused=True, w8a8_chain=True)
    ref = _reference_heads(spec, jp, variables, jproc, w8a8=jscales, **kw)
    pipe = InferencePipeline(cfg, model, "cpu", input_format="rgb", w8a8=scales, **kw)
    with torch.no_grad():
        _heads_close(pipe.heads(tproc), ref, 0.06)
    m = t_eval.evaluate_model("centernet", cfg, model, [b], device="cpu", w8a8=scales, **kw)
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values())


def test_pipeline_update_variables_and_refusals(trained):
    *_, cfg, model, _ = trained
    b = synthetic_batch(np.random.default_rng(8), 2, PAD, num_classes=3)
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.mul_(0.9)
    pipe = InferencePipeline(cfg, model, "cpu", input_format="rgb")
    pipe.update_variables(fresh.state_dict())
    want = InferencePipeline(cfg, fresh, "cpu", input_format="rgb")(b)
    for k, v in pipe(b).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="rebuild the pipeline"):
        InferencePipeline(cfg, model, "cpu", fold_bn=True).update_variables(fresh.state_dict())
    # The reference's refusals that remain: hflip TTA mirrors a 3D model's
    # yaw and DMDS's motion.
    with pytest.raises(ValueError, match="with_3d"):
        t_eval.evaluate_model("centernet", cfg.replace(with_3d=True), model, [b], device="cpu",
                              tta="hflip")
    dmds = t_get_model("dmds")
    dcfg = dmds.params_cls(input_hw=(64, 64), backbone="tiny", decoder_features=8,
                           motion_features=16, batch_size=2)
    with pytest.raises(ValueError, match="incompatible with dmds"):
        t_eval.evaluate_model("dmds", dcfg, dmds.create_model(dcfg, "cpu"),
                              [synthetic_batch(np.random.default_rng(8), 2, PAD, two_frame=True)],
                              device="cpu", tta="hflip")


def test_weight_only_int8_matches_reference(trained):
    *_, model, variables = trained
    params = dict(model.named_parameters())
    qp, counts = quantize_params(params)
    jqp, jcounts = j_quantize(variables["params"])
    assert counts == jcounts and counts["quantized"] > 10
    deq, jdeq = dequantize_params(qp), jax.device_get(j_dequantize(jqp))
    seen = 0

    def visit(node, jdnode, path):
        nonlocal seen
        for k, v in node.items():
            if isinstance(v, dict) and set(v) == {"int8", "scale"}:
                name = flax_path_to_module_name("/".join(path)) + ".weight"
                got = qp[name]
                np.testing.assert_array_equal(got["int8"].permute(2, 3, 1, 0).numpy(), v["int8"])
                np.testing.assert_allclose(got["scale"].numpy(), v["scale"], rtol=1e-7, atol=0)
                np.testing.assert_array_equal(deq[name].permute(2, 3, 1, 0).numpy(),
                                              np.asarray(jdnode[k]))
                seen += 1
            elif isinstance(v, dict):
                visit(v, jdnode[k], path + (k,))

    visit(jqp, jdeq, ())
    assert seen == counts["quantized"]
    assert abs(quantization_error(params, qp) - j_quant_error(variables["params"], jqp)) <= 1e-6


def test_average_checkpoints(tmp_path):
    cfg = CenternetParams(**dict(CFG, ema_decay=0.5, warmup_steps=1))

    def trainer():
        return Trainer(cfg, "cpu", checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1,
                       log_every=1000)

    tr = trainer()
    tr.init_state()
    tr.fit(SyntheticIterator(0, 2, PAD, num_classes=3), 3)
    cks = [tr.ckpt.restore_step(s) for s in (2, 3)]
    fresh = trainer()
    fresh.init_state()
    assert average_checkpoints(fresh, 2) == (2, 3)
    st = fresh.state
    assert st.step == 3 and st.optimizer.count == cks[1]["optimizer"]["count"]
    moved = 0
    for part, got in (("model", st.model.state_dict()),
                      ("ema", dict(zip(cks[1]["ema"], st.ema)))):
        for k, v in got.items():
            a, b = cks[0][part][k], cks[1][part][k]
            if a.is_floating_point():
                want = ((a.double() + b.double()) / 2).to(a.dtype)
                moved += not torch.equal(a, b)
            else:
                want = b
            torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    assert moved > len(cks[1]["model"])  # most tensors differ between the two steps
    torch.testing.assert_close(st.optimizer.mu[0], cks[1]["optimizer"]["mu"][0], rtol=0, atol=0)
    one = Trainer(cfg, "cpu", checkpoint_dir=str(tmp_path / "one"), checkpoint_every=1)
    one.init_state()
    one.fit(SyntheticIterator(0, 2, PAD, num_classes=3), 1)
    with pytest.raises(ValueError, match=">= 2 retained checkpoints"):
        average_checkpoints(one, 3)
