"""Spatial sharding (``cvm_tpu_torch/parallel/spatial.py``,
``models/layers.py::SpatialConv3x3``) against the reference's
(``cvm_tpu/parallel/spatial.py``, ``SemsegNet(mesh=)``) on the conftest's
8-device CPU mesh, the port's ranks as gloo children of
``tests/torch_dist_child.py``.

* ``spatial_conv3x3`` over 2 and 4 ranks (H split over the model axis, the
  reference test's shapes): the slabs put together equal the reference's
  sharded conv within 1e-4 in float32, and the input's and the weight's
  gradients (the weight's summed over the group) equal the unsharded
  ``F.conv2d``'s autograd within 1e-4 (the reference's test only checks
  that its gradient is finite).
* A tiny semseg with ``spatial_shard`` on a (data 1, model 2) mesh, on
  the reference's converted variables: its logits against the reference's
  ``SemsegNet(mesh=)`` applied eagerly (jitted on XLA's CPU mesh, the
  reference's spatial model is 0.38 off its own eager and plain models,
  logits' scale 0.74; ROADMAP, known differences) within the zoo tests'
  bf16 tolerance (``assert_bf16_close``); one training step with every
  conv in float32 gives the unsharded port's loss and metrics within 1e-4
  and its gradients within 1e-4 of each leaf's scale.
* The parameter tree is the plain model's (``convert.py`` is unchanged),
  the int8 postures leave the spatial conv in floating point with the
  reference's calibration keys, and H that does not divide over the model
  axis raises, naming H and the axis.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_child as child
from cvm_tpu.infer.quantize import calibrate_activation_scales as j_calibrate
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.parallel.mesh import make_mesh as j_make_mesh
from cvm_tpu.parallel.spatial import spatial_conv3x3 as j_spatial_conv3x3
from cvm_tpu_torch.convert import convert_scales, convert_variables
from cvm_tpu_torch.infer.quantize import calibrate_activation_scales, swap_fused, swap_int8
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.layers import SpatialConv3x3
from cvm_tpu_torch.models.registry import build_model
from cvm_tpu_torch.parallel.mesh import Mesh, single_mesh

from test_torch_model import assert_bf16_close, random_bn_stats

SEMSEG = dict(input_hw=(64, 128), backbone="tiny", decoder_features=16, batch_size=4)
SEMSEG_CLASSES = get_model("semseg").params_cls(**SEMSEG).num_classes


def _conv_case(ranks):
    """x (NHWC), the HWIO weight, the loss's weights g and the OIHW weight
    of the ``ranks``-rank conv case (tests/test_spatial_sharding.py's
    shapes)."""
    rng = np.random.default_rng(ranks)
    B, H, W, C, Co = 2, 32, 16, 8, 8
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w_hwio = rng.normal(size=(3, 3, C, Co)).astype(np.float32)
    g = rng.normal(size=(B, H, W, Co)).astype(np.float32)
    return x, w_hwio, g, np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))


@pytest.fixture(scope="module")
def semseg_pair():
    """The reference's SemsegNet on a (data 4, model 2) mesh, its variables
    (random BatchNorm statistics) and the port's config."""
    jspec = j_get_model("semseg")
    jp = jspec.params_cls(**SEMSEG, spatial_shard=True)
    jm = jspec.create_model(jp, mesh=j_make_mesh(jax.devices(), model_axis=2))
    init = jax.jit(functools.partial(jm.init, train=False))  # eager init is slower
    variables = random_bn_stats(init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 3))),
                                np.random.default_rng(3))
    return jm, variables, get_model("semseg").params_cls(**SEMSEG, spatial_shard=True)


def _write(path, cfg, sd, inputs, **extra):
    np.savez(path, name=json.dumps("semseg"), cfg=cfg.to_json(), inputs=inputs,
             **{f"sd/{k}": v.numpy() for k, v in sd.items()}, **extra)


def _semseg_inputs():
    """The forward's inputs; the train step's inputs and classes."""
    x = np.random.default_rng(4).uniform(-1, 1, (4, 64, 128, 3)).astype(np.float32)
    rng = np.random.default_rng(5)
    xt = rng.uniform(-1, 1, (4, 64, 128, 3)).astype(np.float32)
    return x, xt, rng.integers(0, SEMSEG_CLASSES, (4, 64, 128)).astype(np.int32)


@pytest.fixture(scope="module")
def two_ranks(semseg_pair, tmp_path_factory):
    """One launch of two ranks over a model axis of 2: the two-rank conv
    case, the spatial semseg's forward and its float32 train step; {case:
    (IN, [rank's (JSON result, arrays)])}."""
    root = tmp_path_factory.mktemp("spatial")
    _, variables, cfg = semseg_pair
    sd = convert_variables(variables)
    x, _, g, w = _conv_case(2)
    fx, tx, classes = _semseg_inputs()
    paths = {case: str(root / f"{case}.npz") for case in ("conv", "forward", "grads")}
    np.savez(paths["conv"], x=x, w=w, g=g)
    _write(paths["forward"], cfg, sd, fx, mode="forward")
    _write(paths["grads"], cfg.replace(optimizer="sgd", lr_schedule="constant",
                                       warmup_steps=1), sd, tx, float32=True, mode="grads",
           **{"t/classes": classes})
    ranks = child.launch(2, ["spatial", "--npz", ",".join(paths.values()), "--model_parallel",
                             2, "--steps", 1], str(root / "r"))
    return {case: (path, [(res["results"][i], {k[len(f"{i}/"):]: v for k, v in arrays.items()
                                               if k.startswith(f"{i}/")})
                          for res, arrays in ranks])
            for i, (case, path) in enumerate(paths.items())}


@pytest.mark.parametrize("ranks", [2, 4])
def test_spatial_conv_matches_reference_and_unsharded_gradients(ranks, two_ranks, tmp_path):
    x, w_hwio, g, w = _conv_case(ranks)
    want = j_spatial_conv3x3(jnp.asarray(x), jnp.asarray(w_hwio),
                             j_make_mesh(jax.devices(), model_axis=ranks), axis="model")
    if ranks == 2:
        res = two_ranks["conv"][1]
    else:
        path = str(tmp_path / "in.npz")
        np.savez(path, x=x, w=w, g=g)
        res = child.launch(ranks, ["spatial", "--npz", path, "--model_parallel", ranks],
                           str(tmp_path / "r"))
    got = {k: np.concatenate([a[k] for _, a in res], axis=1) for k in ("y", "dx")}
    np.testing.assert_allclose(got["y"], np.asarray(want), atol=1e-4)

    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    y = F.conv2d(xt.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got["dx"], xt.grad.numpy(), atol=1e-4)
    for _, a in res:
        np.testing.assert_allclose(a["dw"], wt.grad.numpy(), rtol=1e-5, atol=1e-4)


def test_spatial_semseg_logits_match_reference(semseg_pair, two_ranks):
    jm, variables, cfg = semseg_pair
    x = _semseg_inputs()[0]
    # Eager: jitted on this CPU mesh, the reference's spatial model is 0.38
    # off its own eager and plain models (logits' scale 0.74); eager, its
    # sharded head equals its plain model exactly.
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    plain = get_model("semseg").create_model(cfg.replace(spatial_shard=False), "cpu")
    spatial = build_model(get_model("semseg"), cfg, "cpu", mesh=single_mesh("cpu"))
    assert isinstance(spatial.seg.c1.conv, SpatialConv3x3)
    assert {k: v.shape for k, v in spatial.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    for _, got in two_ranks["forward"][1]:
        assert_bf16_close(got["logits"], ref["logits"])


def test_spatial_semseg_train_step_equals_unsharded(two_ranks):
    path, res = two_ranks["grads"]
    one, grads = child.run_grads(None, "cpu", path, 1)
    for out, got in res:
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(out["metrics"][0][k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=k)
        assert set(got) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(got[name], g, rtol=0,
                                       atol=1e-4 * float(np.abs(g).max() + 1e-12),
                                       err_msg=name)


def test_int8_postures_leave_the_spatial_conv_in_floating_point(semseg_pair):
    jm, variables, cfg = semseg_pair
    x = np.random.default_rng(6).uniform(-1, 1, (4, 64, 128, 3)).astype(np.float32)
    want = convert_scales(j_calibrate(lambda v: jm.apply(variables, v, train=False),
                                      [jnp.asarray(x)]))
    model = build_model(get_model("semseg"), cfg, "cpu", mesh=single_mesh("cpu"))
    model.load_state_dict(convert_variables(variables), strict=True)
    scales = calibrate_activation_scales(model, [torch.from_numpy(x)])
    assert set(scales) == set(want) and "seg.c1.conv" not in scales
    counts = swap_int8(model, scales)
    assert isinstance(model.seg.c1.conv, SpatialConv3x3) and "seg.c1.conv" not in \
        counts["fp_convs"]
    model = build_model(get_model("semseg"), cfg, "cpu", mesh=single_mesh("cpu"))
    from cvm_tpu_torch.infer.quantize import prequantize_fused_weights

    swap_fused(model, dict(scales, **{"seg.c1.conv": 0.05}), prequantize_fused_weights(model))
    assert isinstance(model.seg.c1.conv, SpatialConv3x3)


def test_rows_that_do_not_divide_raise():
    conv = SpatialConv3x3(4, 4, Mesh(1, 2, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match=r"H=5 rows do not divide over the model axis of 2"):
        conv(torch.zeros(1, 5, 8, 4))
