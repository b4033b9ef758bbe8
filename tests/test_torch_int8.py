"""The XLA-composed W8A8 paths of cvm_tpu_torch (``Int8Conv``, dynamic and
static scales) against the reference's ``w8a8_inference`` /
``w8a8_static_inference``, on the CPU at a tiny size.

* Per conv, on the same converted weights and the same seeded input
  (float32 modules, so the output is not rounded to bf16): the input
  lattice, the weight lattice and the int32 sums equal the reference's
  formulas exactly; the output within 1e-6 relative. Cases: 3x3 stride 1
  and stride 2 (SAME pads 0 before, 1 after), 1x1, the stem's 12-channel
  input (K = 108, not a multiple of 8), a head projection with a bias and
  3 output channels, and an odd map.
* The card's product (``int8_conv_mm``: im2col and ``torch._int_mm``,
  zero padded) equals the plain version (float64 sums) exactly; on the CPU
  ``_int_mm`` computes it.
* The whole tiny CenterNet forward through both pipelines, yuv420, BN
  unfolded and folded: decoded scores within 0.01 (ROADMAP's "bf16 head
  rounding": XLA's CPU backend does not round the reference's bf16 heads).
* The swap's counts, the static path's fp convs, and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline
from cvm_tpu.infer.quantize import calibrate_activation_scales as j_calibrate
from cvm_tpu.infer.quantize import w8a8_inference, w8a8_static_inference
from cvm_tpu.models import get_model
from cvm_tpu_torch.convert import convert_scales, convert_variables
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.quantize import (Int8Conv, int8_conv_mm, int8_conv_reference,
                                          swap_int8)
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.models.layers import Conv

from test_torch_model import random_bn_stats

# (Cin, Cout, k, stride, bias, H, W)
CONVS = {
    "3x3": (16, 24, 3, 1, False, 12, 10),
    "3x3-s2": (16, 32, 3, 2, False, 12, 10),
    "1x1": (24, 16, 1, 1, False, 8, 8),
    "stem": (12, 16, 3, 1, False, 16, 16),
    "head": (16, 3, 1, 1, True, 8, 8),
    "odd": (8, 40, 3, 2, True, 7, 9),
}
CFG = dict(input_hw=(32, 32), num_classes=3, backbone="tiny", neck_features=16,
           head_features=8, top_k=10, batch_size=2)
KEYS = ("y", "u", "v", "image_hw")


def _conv_pair(name, seed=0):
    cin, cout, k, s, bias, h, w = CONVS[name]
    rng = np.random.default_rng(seed)
    jm = nn.Conv(cout, (k, k), strides=(s, s), use_bias=bias, dtype=jnp.float32,
                 param_dtype=jnp.float32)
    kernel = rng.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    params = {"kernel": kernel}
    if bias:
        params["bias"] = rng.normal(0, 0.5, (cout,)).astype(np.float32)
    tm = Conv(cin, cout, k, s, bias=bias, dtype=torch.float32)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        if bias:
            tm.bias.copy_(torch.from_numpy(params["bias"]))
    x = rng.normal(0, 1.5, (2, h, w, cin)).astype(np.float32)
    return jm, {"params": params}, tm, x


def _ref_lattices(x, kernel, sx, stride):
    """The reference's quantize formulas (``_int8_conv`` / ``_int8_conv_static``)."""
    xf = jnp.asarray(x, jnp.float32)
    if sx is None:
        sx = jnp.max(jnp.abs(xf)) / 127.0 + 1e-8
    xq = jnp.round(jnp.clip(xf / sx, -127, 127)).astype(jnp.int8)
    kf = jnp.asarray(kernel, jnp.float32)
    sw = jnp.max(jnp.abs(kf), axis=(0, 1, 2)) / 127.0 + 1e-12
    wq = jnp.round(jnp.clip(kf / sw, -127, 127)).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(xq, wq, (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(wq), np.asarray(sw), np.asarray(acc)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_conv_matches_reference(name, static):
    jm, variables, tm, x = _conv_pair(name)
    sx = 0.75 * float(np.abs(x).max()) / 127.0 if static else None  # clips the largest values
    if static:
        with w8a8_static_inference({"": sx}):
            want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    else:
        with w8a8_inference():
            want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    xq_r, wq_r, sw_r, acc_r = _ref_lattices(x, variables["params"]["kernel"], sx,
                                            CONVS[name][3])

    q = Int8Conv(tm, sx)
    xt = torch.from_numpy(x)
    xq, sx_t = q.quantize(xt)
    np.testing.assert_array_equal(xq.numpy(), xq_r)
    np.testing.assert_array_equal(q.weight_oihw.permute(2, 3, 1, 0).numpy(), wq_r)
    np.testing.assert_array_equal(q.sw.numpy(), sw_r)
    acc = int8_conv_reference(q, xq)
    np.testing.assert_array_equal(acc.numpy(), acc_r)
    got = q(xt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CONVS))
def test_int_mm_path_equals_the_plain_sums(name):
    """The card's im2col + ``_int_mm`` product, run on the CPU, against the
    float64 plain version, including M <= 16 (rows padded to 32)."""
    _, _, tm, x = _conv_pair(name, seed=1)
    q = Int8Conv(tm, None)
    assert q.kp % 8 == 0 and q.npad % 8 == 0 and q.kp >= q.k * q.k * q.cin
    for xs in (x, x[:1, :2, :3]):
        xq, _ = q.quantize(torch.from_numpy(np.ascontiguousarray(xs)))
        got, want = int8_conv_mm(q, xq), int8_conv_reference(q, xq)
        assert got.dtype == torch.int32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_conv_refuses_a_device_without_a_product():
    _, _, tm, _ = _conv_pair("3x3")
    q = Int8Conv(tm, None)
    with pytest.raises(ValueError, match="no int8 product"):
        q.int8_conv(torch.zeros(1, 4, 4, 16, dtype=torch.int8, device="meta"))


@pytest.fixture(scope="module")
def tiny():
    spec = get_model("centernet")
    jp = spec.params_cls(**CFG)
    jm = spec.create_model(jp)
    rng = np.random.default_rng(21)
    variables = random_bn_stats(
        jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=False), rng)
    cal = [rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    jscales = j_calibrate(lambda x: jm.apply(variables, x, train=False),
                          [jnp.asarray(c) for c in cal])
    tm = create_model(CenternetParams(**CFG), "cpu")
    tm.load_state_dict(convert_variables(variables), strict=True)
    batch = synthetic_batch(np.random.default_rng(5), 2, (48, 40), yuv420=True)
    return spec, jp, variables, jscales, tm, {k: batch[k] for k in KEYS}


@pytest.mark.parametrize("fold_bn", [False, True], ids=["bn", "fold_bn"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_pipeline_matches_reference(tiny, mode, fold_bn):
    spec, jp, variables, jscales, tm, batch = tiny
    w8a8_j = True if mode == "dynamic" else jscales
    w8a8_t = True if mode == "dynamic" else convert_scales(jscales)
    ref = JPipeline(spec, jp, variables, input_format="yuv420", w8a8=w8a8_j, fold_bn=fold_bn)
    want = jax.device_get(ref(batch))
    pipe = InferencePipeline(CenternetParams(**CFG), tm, "cpu", input_format="yuv420",
                             w8a8=w8a8_t, fold_bn=fold_bn)
    got = {k: v.numpy() for k, v in pipe(batch).items()}
    n_convs = sum(isinstance(m, Conv) for m in tm.modules())
    assert pipe.int8_counts == {"int8": n_convs, "fp": 0, "fp_convs": []}
    assert not any(isinstance(m, Conv) for m in pipe.model.modules())
    assert got["boxes"].shape == want["boxes"].shape
    np.testing.assert_allclose(np.sort(got["scores"], axis=1), np.sort(want["scores"], axis=1),
                               atol=0.01)
    assert np.isfinite(got["boxes"]).all()


def test_static_scales_leave_uncalibrated_convs_fp_and_count_them(tiny):
    _, _, _, jscales, tm, batch = tiny
    scales = convert_scales(jscales)
    dropped = sorted(scales)[:3]
    for k in dropped:
        del scales[k]
    pipe = InferencePipeline(CenternetParams(**CFG), tm, "cpu", input_format="yuv420",
                             w8a8=scales)
    assert pipe.int8_counts["fp"] == 3 and pipe.int8_counts["fp_convs"] == dropped
    assert sum(isinstance(m, Conv) for m in pipe.model.modules()) == 3
    assert np.isfinite(pipe(batch)["scores"].numpy()).all()
    with pytest.raises(ValueError, match="no conv matched"):
        swap_int8(create_model(CenternetParams(**CFG), "cpu"), {"nothing": 0.1})
    with pytest.raises(ValueError, match="w8a8 must be"):
        InferencePipeline(CenternetParams(**CFG), tm, "cpu", w8a8="yes")
