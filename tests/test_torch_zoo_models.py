"""The dense zoo's models and losses (cvm_tpu_torch) against the reference,
on the CPU at a tiny size (``backbone="tiny"``, 64x128, batch 2).

* Each model's forward on the reference's converted variables (random
  BatchNorm statistics; ``strict=True`` load), every output within
  ``assert_bf16_close`` (max |d| <= 3% and mean <= 0.5% of the output's
  scale, as ``tests/test_torch_model.py``): semseg, depth (every scale),
  multitask with and without ``uncertainty_weighting`` (its
  ``task_log_vars`` converted as a bare leaf); then with BN folded.
  Depth's ``disp_logits`` are held through ``depth_scales``, their image
  under ``sigmoid_to_depth`` (float32 on both sides): an untrained
  one-channel head sums bf16-rounded features into logits near 0, whose
  own scale is then 10-20x below the features' noise floor (measured: 4%
  of a 0.11 scale at stride 8, while the depth there agrees to 0.2%).
* Each loss and its gradient against ``jax.value_and_grad`` on the same
  float32 outputs and targets, rtol 1e-4: semseg with and without label
  smoothing and with an all-ignore mask; depth with berHu (tied maxima
  included), silog and L1 over four scales; multitask with static
  weights and with Kendall weighting; the confusion-matrix mIoU exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.infer.fold_bn import bn_folded_inference, fold_batchnorm as j_fold
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.ops.heatmap import CenternetTargets as JTargets
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.infer.fold_bn import fold_batchnorm
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.ops.heatmap import CenternetTargets
from test_torch_model import assert_bf16_close, random_bn_stats

HW = (64, 128)
TINY = {
    "semseg": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=2),
    "depth": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=2),
    "multitask": dict(input_hw=HW, backbone="tiny", neck_features=32, head_features=16,
                      batch_size=2),
    "multitask_uw": dict(input_hw=HW, backbone="tiny", neck_features=32, head_features=16,
                         batch_size=2, uncertainty_weighting=True),
}


def _pair(case):
    name = case.split("_")[0]
    jspec, tspec = j_get_model(name), get_model(name)
    jp, tp = jspec.params_cls(**TINY[case]), tspec.params_cls(**TINY[case])
    jm = jspec.create_model(jp)
    rng = np.random.default_rng(len(case))
    variables = random_bn_stats(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)),
                                        train=False), rng)
    if "task_log_vars" in variables["params"]:
        variables["params"]["task_log_vars"] = np.array([0.3, -0.2, 0.1], np.float32)
    tm = tspec.create_model(tp, "cpu")
    tm.load_state_dict(convert_variables(variables), strict=True)
    x = rng.uniform(-1, 1, (2, *HW, 3)).astype(np.float32)
    return jm, variables, tm, x


def _close(got, ref):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r)
        return
    assert got.dtype == torch.float32
    assert_bf16_close(got.detach().numpy(), ref)


@pytest.mark.parametrize("case", sorted(TINY))
def test_model_matches_reference(case):
    jm, variables, tm, x = _pair(case)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        if k != "disp_logits":
            _close(got[k], ref[k])
    if "disp_logits" in ref:
        assert [tuple(t.shape) for t in got["disp_logits"]] == \
            [r.shape for r in ref["disp_logits"]]
    if case == "multitask_uw":
        np.testing.assert_array_equal(got["task_log_vars"].detach().numpy(),
                                      variables["params"]["task_log_vars"])


@pytest.mark.parametrize("case", ["semseg", "depth", "multitask"])
def test_folded_model_matches_reference(case):
    jm, variables, tm, x = _pair(case)
    fv, table = j_fold(variables)

    def apply_folded(v, x):
        with bn_folded_inference(table):
            return jm.apply(v, x, train=False)

    ref = jax.jit(apply_folded)(fv, jnp.asarray(x))
    with torch.no_grad():
        got = fold_batchnorm(tm)(torch.from_numpy(x))
    for k in ("logits", "depth", "heatmap"):
        if k in ref:
            _close(got[k], ref[k])


# --- losses and their gradients ------------------------------------------


def _grad_close(name, params_kw, outputs, targets, wrt, jtargets=None):
    """Loss, metrics and d loss / d outputs[wrt] on both sides, rtol 1e-4."""
    jspec, tspec = j_get_model(name), get_model(name)
    jp, tp = jspec.params_cls(**params_kw), tspec.params_cls(**params_kw)
    jt = targets if jtargets is None else jtargets

    def jloss(sel):
        out = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v))
               for k, v in outputs.items()}
        out.update(sel)
        return jspec.loss_fn(out, jax.tree.map(jnp.asarray, jt), jp)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: ([jnp.asarray(a) for a in outputs[k]] if isinstance(outputs[k], list)
             else jnp.asarray(outputs[k])) for k in wrt})
    tout = {k: ([torch.tensor(a, requires_grad=k in wrt) for a in v] if isinstance(v, list)
                else torch.tensor(v, requires_grad=k in wrt)) for k, v in outputs.items()}
    tt = {k: (v if isinstance(v, CenternetTargets) else torch.from_numpy(np.asarray(v)))
          for k, v in targets.items()}
    tl, tm = tspec.loss_fn(tout, tt, tp)
    leaves = [t for k in wrt for t in (tout[k] if isinstance(tout[k], list) else [tout[k]])]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    refs = [g for k in wrt for g in (jg[k] if isinstance(jg[k], list) else [jg[k]])]
    for got, ref in zip(tg, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max() + 1e-12))
    return float(tl.detach())


def _seg_labels(rng, shape, ignore_frac=0.2):
    labels = rng.integers(0, 5, shape).astype(np.int32)
    labels[rng.uniform(size=shape) < ignore_frac] = 255
    return labels


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("all_ignore", [False, True])
def test_semseg_loss_and_gradient_match(smoothing, all_ignore):
    rng = np.random.default_rng(int(smoothing * 10) + all_ignore)
    logits = rng.normal(0, 2, (2, 8, 12, 5)).astype(np.float32)
    labels = _seg_labels(rng, (2, 8, 12), 1.0 if all_ignore else 0.2)
    loss = _grad_close("semseg", dict(label_smoothing=smoothing,
                                      class_weights=(1.0, 2.0, 0.5, 2.0, 1.0)),
                       {"logits": logits}, {"classes": labels}, ["logits"])
    assert (loss == 0.0) == all_ignore


def _depth_case(rng, ties=False):
    gt = np.where(rng.uniform(size=(2, 16, 24, 1)) < 0.4,
                  rng.uniform(2, 60, (2, 16, 24, 1)), 0).astype(np.float32)
    scales = [rng.uniform(1, 70, (2, 16 // 2 ** i, 24 // 2 ** i, 1)).astype(np.float32)
              for i in range(4)]
    if ties:  # two valid pixels share the largest |err| of the finest scale
        gt[0, 0, 0, 0], gt[1, 5, 7, 0] = 50.0, 50.0
        valid = gt > 0
        scales[0] = np.where(valid, np.clip(scales[0], gt - 20, gt + 20), 30.0)
        scales[0][0, 0, 0, 0], scales[0][1, 5, 7, 0] = 1.0, 1.0
        err = np.abs(scales[0] - gt) * valid
        assert (err == err.max()).sum() == 2
    return gt, scales


@pytest.mark.parametrize("loss_type", ["berhu", "berhu_ties", "silog", "l1"])
def test_depth_loss_and_gradient_match(loss_type):
    rng = np.random.default_rng(len(loss_type))
    gt, scales = _depth_case(rng, ties=loss_type == "berhu_ties")
    full = rng.uniform(1, 70, gt.shape).astype(np.float32)
    _grad_close("depth", dict(loss_type=loss_type.split("_")[0], num_scales=4),
                {"depth": full, "depth_scales": scales}, {"depth": gt}, ["depth_scales"])


@pytest.mark.parametrize("kendall", [False, True])
def test_multitask_loss_and_gradient_match(kendall):
    rng = np.random.default_rng(7 + kendall)
    B, (H, W), (hs, ws), C = 2, (16, 32), (4, 8), 3
    det_np = dict(
        heatmap=np.clip(rng.uniform(-0.2, 1.0, (B, hs, ws, C)), 0, 1).astype(np.float32),
        offset=rng.uniform(0, 1, (B, hs, ws, 2)).astype(np.float32),
        size=rng.uniform(1, 5, (B, hs, ws, 2)).astype(np.float32),
        mask=(rng.uniform(size=(B, hs, ws)) < 0.2).astype(np.float32),
        indices=np.zeros((B, 4), np.int32), valid=np.ones((B, 4), bool))
    det_np["heatmap"][det_np["mask"] > 0] = 1.0
    gt, scales = _depth_case(rng)
    gt = np.repeat(np.repeat(gt[:, :H // 2, :W // 2], 2, 1), 2, 2)[:, :H, :W]
    outputs = {"heatmap": rng.normal(-1, 1, (B, hs, ws, C)).astype(np.float32),
               "offset": rng.uniform(0, 1, (B, hs, ws, 2)).astype(np.float32),
               "size": rng.uniform(1, 5, (B, hs, ws, 2)).astype(np.float32),
               "logits": rng.normal(0, 2, (B, H, W, 5)).astype(np.float32),
               "depth": rng.uniform(1, 70, (B, H, W, 1)).astype(np.float32),
               "depth_scales": [rng.uniform(1, 70, (B, H // 2, W // 2, 1)).astype(np.float32)]}
    wrt = ["heatmap", "offset", "size", "logits", "depth_scales"]
    if kendall:
        outputs["task_log_vars"] = np.array([0.2, -0.3, 0.5], np.float32)
        wrt.append("task_log_vars")
    targets = {"det": CenternetTargets(*(torch.from_numpy(v) for v in det_np.values())),
               "classes": _seg_labels(rng, (B, H, W)), "depth": gt}
    jtargets = dict(targets, det=JTargets(*det_np.values()))
    _grad_close("multitask", dict(num_det_classes=C, label_smoothing=0.05,
                                  uncertainty_weighting=kendall),
                outputs, targets, wrt, jtargets)


def test_miou_metric_matches_reference():
    from cvm_tpu.models.semseg.loss import miou_metric as j_miou
    from cvm_tpu_torch.models.semseg.loss import miou_metric

    rng = np.random.default_rng(9)
    pred = rng.integers(0, 4, (2, 9, 11)).astype(np.int32)   # class 4 never predicted
    labels = _seg_labels(rng, (2, 9, 11))
    labels[labels == 3] = 255                                  # class 3 never labelled
    iou, miou = miou_metric(torch.from_numpy(pred), torch.from_numpy(labels), 5)
    jiou, jmiou = j_miou(jnp.asarray(pred), jnp.asarray(labels), 5)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6)
    np.testing.assert_allclose(float(miou), float(jmiou), rtol=1e-6)
