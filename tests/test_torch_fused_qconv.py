"""The fused W8A8 ConvBN path of cvm_tpu_torch against cvm_tpu's.

On the CPU the port's wrapper takes its plain version, which is held here
against the reference's Pallas kernel in interpret mode; the card's kernel
is held against the plain version in tests/test_torch_kernels_cuda.py.
Tolerances: the int32 lattice sums are exact on both sides, so f32 outputs
agree to f32 epilogue rounding (2e-5); an int8 requant may move by one
lattice step where the f32 value sits on a rounding boundary; bf16 outputs
of whole blocks agree to a few bf16 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.infer.quantize import (calibrate_activation_scales as j_calibrate,
                                    prequantize_fused_weights as j_prequantize,
                                    w8a8_fused_inference)
from cvm_tpu.models import get_model
from cvm_tpu.models import layers as jl
from cvm_tpu.ops.pallas.fused_qconv import fused_qconv as j_fused_qconv
from cvm_tpu_torch.convert import convert_scales, convert_variables, flax_path_to_module_name
from cvm_tpu_torch.infer.fold_bn import fold_batchnorm
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.quantize import (ChainedResBlock, FusedConvBN,
                                          calibrate_activation_scales,
                                          prequantize_fused_weights, swap_fused)
from cvm_tpu_torch.models import layers as tl
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops.cuda.fused_qconv import (cin_split, fused_qconv, fused_qconv_reference,
                                                pack_qconv_weights, packed_numel, qconv_plan,
                                                unpack_qconv_weights)

from test_torch_model import assert_bf16_close, random_bn_stats


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kh,B,H,W,cin,cout,act", [
    (1, 2, 8, 16, 32, 64, "silu"),
    (3, 2, 16, 20, 32, 64, "silu"),
    (3, 1, 32, 48, 16, 256, None),
    (3, 1, 8, 96, 8, 32, "relu"),
    (3, 2, 2, 1, 16, 32, "relu"),
])
def test_plain_version_matches_reference_kernel(kh, B, H, W, cin, cout, act):
    rng = np.random.default_rng(kh * 1000 + cout)
    x = rng.normal(0, 1, (B, H, W, cin)).astype(np.float32)
    wq = rng.integers(-127, 128, (kh, kh, cin, cout)).astype(np.int8)
    scale = (rng.uniform(0.5, 2, (cout,)) * 1e-3).astype(np.float32)
    bias = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    ref = j_fused_qconv(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                        jnp.asarray(bias), inv_sx=1 / 0.021, act=act,
                        out_dtype=jnp.float32, interpret=True)
    n0 = fused_qconv.launches
    got = fused_qconv(_t(x), _t(wq), _t(scale), _t(bias), inv_sx=1 / 0.021, act=act,
                      out_dtype=torch.float32)
    assert fused_qconv.launches == n0, "a CPU tensor must not count as a launch"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_plain_version_chain_modes_match_reference_kernel():
    rng = np.random.default_rng(7)
    B, H, W, cin, cmid, cout = 2, 8, 16, 16, 32, 24
    x = rng.normal(0, 1, (B, H, W, cin)).astype(np.float32)
    wq1 = rng.integers(-127, 128, (3, 3, cin, cmid)).astype(np.int8)
    wq2 = rng.integers(-127, 128, (3, 3, cmid, cout)).astype(np.int8)
    sc1 = (rng.uniform(0.5, 2, (cmid,)) * 1e-3).astype(np.float32)
    sc2 = (rng.uniform(0.5, 2, (cout,)) * 1e-3).astype(np.float32)
    b1 = rng.normal(0, 0.1, (cmid,)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    sx1, sx2 = 0.02, 0.015
    jh = j_fused_qconv(jnp.asarray(x), jnp.asarray(wq1), jnp.asarray(sc1), jnp.asarray(b1),
                       inv_sx=1 / sx1, act="silu", out_dtype=jnp.int8, inv_s_out=1 / sx2,
                       interpret=True)
    jy = j_fused_qconv(jh, jnp.asarray(wq2), jnp.asarray(sc2), jnp.asarray(b2), inv_sx=None,
                       act=None, out_dtype=jnp.float32, interpret=True)
    th = fused_qconv(_t(x), _t(wq1), _t(sc1), _t(b1), inv_sx=1 / sx1, act="silu",
                     out_dtype=torch.int8, inv_s_out=1 / sx2)
    assert th.dtype == torch.int8
    d = np.abs(th.numpy().astype(np.int32) - np.asarray(jh).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    # c2 from the reference's own int8 buffer: identical lattice math.
    ty = fused_qconv(_t(jh), _t(wq2), _t(sc2), _t(b2), inv_sx=None, act=None,
                     out_dtype=torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 16, dtype=torch.int8)
    s = torch.ones(16)
    with pytest.raises(ValueError, match="int8"):
        fused_qconv(x, w, s, s, inv_sx=None)
    with pytest.raises(ValueError, match="inv_s_out"):
        fused_qconv(x, w, s, s, inv_sx=1.0, out_dtype=torch.int8)
    with pytest.raises(ValueError, match="1x1/3x3"):
        fused_qconv(x, torch.zeros(5, 5, 8, 16, dtype=torch.int8), s, s, inv_sx=1.0)
    with pytest.raises(TypeError, match="int8"):
        fused_qconv(x, w.float(), s, s, inv_sx=1.0)


def _resblock_pair(rng):
    jmod = jl.ResBlock(24)
    x = rng.uniform(-1, 1, (2, 16, 16, 8)).astype(np.float32)
    variables = random_bn_stats(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                          train=False), rng)
    tmod = tl.ResBlock(8, 24)
    tmod.load_state_dict(convert_variables(variables), strict=True)
    return jmod, variables, tmod.eval(), x


def test_weight_table_bit_identical_to_reference():
    jmod, variables, tmod, _ = _resblock_pair(np.random.default_rng(1))
    jt = j_prequantize(variables)
    tt = prequantize_fused_weights(tmod)
    assert set(tt) == {flax_path_to_module_name(k) for k in jt} == {"c1", "c2", "proj"}
    for k, (wq, sw) in jt.items():
        twq, tsw = tt[flax_path_to_module_name(k)]
        np.testing.assert_array_equal(twq.numpy(), wq)
        np.testing.assert_array_equal(tsw.numpy(), sw)


def test_fused_convbn_and_chained_resblock_match_reference_interceptor():
    rng = np.random.default_rng(2)
    jmod, variables, tmod, x = _resblock_pair(rng)
    jscales = j_calibrate(lambda v: jmod.apply(variables, v, train=False), [jnp.asarray(x)])
    wtab = j_prequantize(variables)
    with w8a8_fused_inference(jscales, interpret=True, weight_table=wtab, chain=True):
        ref_chain = jmod.apply(variables, jnp.asarray(x), train=False)
    scales = convert_scales(jscales)
    ttab = prequantize_fused_weights(tmod)
    chained = ChainedResBlock(tmod, {p: scales[f"{p}.conv"] for p in ("c1", "c2", "proj")},
                              ttab)
    with torch.no_grad():
        got = chained(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got.float().numpy(), ref_chain)

    # One ConvBN body (c1 of the block) against the reference's per-ConvBN path.
    jc1 = jl.ConvBN(24, 3)
    vc1 = {"params": variables["params"]["c1"], "batch_stats": variables["batch_stats"]["c1"]}
    with w8a8_fused_inference({"conv": jscales["c1/conv"]}, interpret=True,
                              weight_table={"": wtab["c1"]}):
        ref = jc1.apply(vc1, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = FusedConvBN(tmod.c1, scales["c1.conv"], ttab["c1"])(torch.from_numpy(x))
    assert_bf16_close(got.float().numpy(), ref)


TINY32 = dict(input_hw=(32, 32), num_classes=3, backbone="tiny", neck_features=16,
              head_features=8)


@pytest.fixture(scope="module")
def tiny32():
    spec = get_model("centernet")
    jm = spec.create_model(spec.params_cls(**TINY32))
    rng = np.random.default_rng(4)
    variables = random_bn_stats(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False), rng)
    tm = create_model(CenternetParams(**TINY32), "cpu")
    tm.load_state_dict(convert_variables(variables), strict=True)
    cal = [rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    return jm, variables, tm, cal


def test_calibration_matches_reference(tiny32):
    """Same keys (29 convs at tiny/32^2). The stem sees the same input on
    both sides, so its scale is equal. Deeper convs see bf16 activations
    that differ by a few bf16 steps, and at tiny/32^2 a conv's input has
    only a few hundred values, so the 99.9th percentile interpolates between
    the two largest: their percentiles agree to 5%."""
    jm, variables, tm, cal = tiny32
    jscales = j_calibrate(lambda v: jm.apply(variables, v, train=False),
                          [jnp.asarray(c) for c in cal])
    got = calibrate_activation_scales(tm, [torch.from_numpy(c) for c in cal])
    ref = convert_scales(jscales)
    assert len(ref) == 29 and set(got) == set(ref)
    assert got["backbone.stem.conv"] == pytest.approx(ref["backbone.stem.conv"], rel=1e-6)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=5e-2), k


def test_swap_fused_counts_and_refusals(tiny32):
    _, _, tm, cal = tiny32
    scales = calibrate_activation_scales(tm, [torch.from_numpy(cal[0])])
    import copy

    m = copy.deepcopy(tm)
    counts = swap_fused(m, scales, prequantize_fused_weights(m), chain=True)
    # stem + 6 chained ResBlocks (12 calls) + 3 UpBlocks x 2 + 3 head c1.
    assert counts == {"convbn": 10, "resblock": 6, "calls": 22}
    assert sum(isinstance(x, ChainedResBlock) for x in m.modules()) == 6
    m = copy.deepcopy(tm)
    assert swap_fused(m, scales, prequantize_fused_weights(m))["calls"] == 22
    table = prequantize_fused_weights(tm)
    del table["backbone.s2b0.c1"]
    with pytest.raises(ValueError, match="weight table"):
        swap_fused(copy.deepcopy(tm), scales, table, chain=True)
    folded = fold_batchnorm(tm)
    with pytest.raises(ValueError, match="folded BN"):
        swap_fused(folded, scales, prequantize_fused_weights(folded))


def test_pipeline_refusals(tiny32):
    _, _, tm, _ = tiny32
    p = CenternetParams(**TINY32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        InferencePipeline(p, tm, "cpu", w8a8={"x": 0.1}, w8a8_fused=True, fold_bn=True)
    with pytest.raises(ValueError, match="calibrated"):
        InferencePipeline(p, tm, "cpu", w8a8_fused=True)
    with pytest.raises(ValueError, match="empty"):
        InferencePipeline(p, tm, "cpu", w8a8={}, w8a8_fused=True)
    with pytest.raises(ValueError, match="w8a8_fused=True"):
        InferencePipeline(p, tm, "cpu", w8a8_chain=True)
    with pytest.raises(ValueError, match="no module matched"):
        InferencePipeline(p, tm, "cpu", w8a8={"nothing.conv": 0.1}, w8a8_fused=True)


# (k, B, H, W, Cin, Cout): the card tests' shapes (1x1, ragged W, Cout 256,
# W = 1, folded stems with Cin 8 / 12, ragged Cin 40 and Cout 72) and
# config-B-like calls at a small map (the stem fold, Cout 512, Cin 768).
PACK_SHAPES = [
    (1, 2, 8, 16, 32, 64), (3, 2, 16, 20, 32, 64), (3, 1, 32, 48, 16, 256),
    (3, 1, 8, 96, 8, 32), (3, 2, 2, 1, 16, 32), (3, 2, 9, 13, 12, 24), (1, 1, 5, 7, 40, 72),
    (3, 1, 16, 16, 12, 32), (3, 1, 4, 4, 512, 512), (3, 1, 4, 8, 768, 128),
]


def _conv_from_image(q, image, k, cin, cout):
    """The kernel's loop in plain PyTorch, reading weights only from the
    packed image: per Cout tile, per Cin chunk and per tap a (bn, 32) K-major
    slab times the shifted input window; folded, one im2col product."""
    p = qconv_plan(k, cin, cout)
    B, H, W, _ = q.shape
    acc = torch.zeros(B, H, W, p.ntiles * p.bn, dtype=torch.float64)
    xp = torch.nn.functional.pad(q.double(), (0, p.nch * 32 - cin, k // 2, k // 2, k // 2, k // 2))
    if p.fold:
        cols = torch.cat([xp[:, dy:dy + H, dx:dx + W, :cin] for dy in range(3) for dx in range(3)], -1)
        cols = torch.nn.functional.pad(cols, (0, p.kf - 9 * cin))
        img = image.view(p.ntiles, p.kf // 16, p.bn, 16).double()
        for t in range(p.ntiles):
            acc[..., t * p.bn:(t + 1) * p.bn] = cols @ img[t].permute(1, 0, 2).reshape(p.bn, p.kf).T
    else:
        img = image.view(p.ntiles, p.nch, k * k, 2, p.bn, 16).double()
        for t in range(p.ntiles):
            for c in range(p.nch):
                for tap in range(k * k):
                    a = xp[:, tap // k:tap // k + H, tap % k:tap % k + W, 32 * c:32 * c + 32]
                    bm = img[t, c, tap].permute(1, 0, 2).reshape(p.bn, 32)
                    acc[..., t * p.bn:(t + 1) * p.bn] += a @ bm.T
    return acc[..., :cout].float()


@pytest.mark.parametrize("shape", PACK_SHAPES)
def test_packed_weight_image_round_trips(shape):
    k, _, _, _, cin, cout = shape
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8))
    image = pack_qconv_weights(w)
    assert image.dtype == torch.int8 and image.dim() == 1
    assert image.numel() == packed_numel(k, cin, cout) and image.numel() % 128 == 0
    assert torch.equal(unpack_qconv_weights(image, k, cin, cout), w)
    # Everything outside the real weights is zero padding.
    assert int(image.abs().sum()) == int(w.abs().sum())


@pytest.mark.parametrize("shape", PACK_SHAPES)
def test_conv_from_packed_image_matches_plain_version(shape):
    k, B, H, W, cin, cout = shape
    rng = np.random.default_rng(k + B + H + W + cin + cout)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 2, (cout,)) * 1e-5).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, (cout,)).astype(np.float32))
    acc = _conv_from_image(x, pack_qconv_weights(w), k, cin, cout)
    got = acc * scale + bias
    ref = fused_qconv_reference(x, w, scale, bias, inv_sx=None, act=None, out_dtype=torch.float32)
    # Integer sums below 2^24 are exact in f32 on both sides.
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_plan_folds_the_stem_and_splits_the_deep_calls():
    assert qconv_plan(3, 12, 32) == (64, 1, 1, True, 128)     # stem: 9*12 = 108 -> 128
    assert qconv_plan(3, 16, 32).fold is False                 # 9*16 > 128
    assert qconv_plan(3, 512, 512)[:3] == (128, 4, 16)
    sms = 132  # an H100 SXM
    split = {name: cin_split(qconv_plan(3, cin, cout), 8, hw, hw, sms)
             for name, hw, cin, cout in [("stem", 256, 12, 32), ("s2", 128, 64, 64),
                                         ("s4", 32, 256, 256), ("s5", 16, 512, 512),
                                         ("up0 c1", 32, 768, 128), ("up0 c2", 32, 128, 128)]}
    assert split == {"stem": 1, "s2": 1, "s4": 1, "s5": 2, "up0 c1": 2, "up0 c2": 2}


def test_fused_convbn_packs_its_weights_once(tiny32):
    _, _, tm, cal = tiny32
    scales = calibrate_activation_scales(tm, [torch.from_numpy(cal[0])])
    m = FusedConvBN(tm.backbone.stem, scales["backbone.stem.conv"],
                    prequantize_fused_weights(tm)["backbone.stem"])
    assert torch.equal(m.wpack, pack_qconv_weights(m.wq))
    assert "wpack" in dict(m.named_buffers())  # moves with the module
