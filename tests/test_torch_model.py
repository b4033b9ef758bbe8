"""cvm_tpu_torch.models against cvm_tpu.models with converted weights.

Each block is built in flax, initialised, given non-trivial BatchNorm
statistics, converted with ``cvm_tpu_torch.convert`` and run on the same
numpy input on both sides. Both compute in bf16 and round each conv output
to bf16 on their own, so outputs agree to a few bf16 steps: the bound is
3% of the output's magnitude at any element, and 0.5% on average.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.infer.fold_bn import bn_folded_inference, fold_batchnorm as j_fold
from cvm_tpu.models import get_model
from cvm_tpu.models import layers as jl
from cvm_tpu.models.backbones import space_to_depth as j_s2d
from cvm_tpu_torch.convert import convert_variables, flax_path_to_module_name
from cvm_tpu_torch.infer.fold_bn import fold_batchnorm
from cvm_tpu_torch.models import layers as tl
from cvm_tpu_torch.models.backbones import space_to_depth
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams


def random_bn_stats(variables, rng):
    """Give every BatchNorm non-trivial scale, bias, mean and var, so that a
    mismatched BN mapping cannot pass."""
    def visit(node, draw):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = (draw(v) if set(v) in ({"scale", "bias"}, {"mean", "var"})
                          else visit(v, draw))
            else:
                out[k] = np.asarray(v)
        return out

    def bn(v):
        a, b = sorted(v)  # (bias, scale) or (mean, var)
        return {a: rng.normal(0, 0.2, np.shape(v[a])).astype(np.float32),
                b: rng.uniform(0.5, 2.0, np.shape(v[b])).astype(np.float32)}

    v = jax.device_get(variables)
    return {"params": visit(v["params"], bn), "batch_stats": visit(v["batch_stats"], bn)}


def assert_bf16_close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-3)
    d = np.abs(got - ref)
    assert d.max() <= 0.03 * scale, (d.max(), scale)
    assert d.mean() <= 0.005 * scale, (d.mean(), scale)


def _load(tmod, variables):
    tmod.load_state_dict(convert_variables(variables), strict=True)
    return tmod.eval()


def test_flax_paths_map_to_module_names():
    assert flax_path_to_module_name("Backbone_0/s2b0/c1/conv") == "backbone.s2b0.c1.conv"
    assert flax_path_to_module_name("hm/out") == "hm.out"


def test_space_to_depth_channel_order():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_s2d(jnp.asarray(x))))


BLOCKS = {
    "convbn_3x3": (lambda: jl.ConvBN(16, 3), lambda: tl.ConvBN(8, 16, 3), (2, 12, 10, 8)),
    "convbn_3x3_s2": (lambda: jl.ConvBN(16, 3, stride=2), lambda: tl.ConvBN(8, 16, 3, stride=2),
                      (2, 12, 10, 8)),
    "convbn_1x1_noact": (lambda: jl.ConvBN(24, 1, act=None),
                         lambda: tl.ConvBN(8, 24, 1, act=None), (2, 6, 6, 8)),
    "resblock_proj": (lambda: jl.ResBlock(24), lambda: tl.ResBlock(8, 24), (2, 8, 8, 8)),
    "resblock": (lambda: jl.ResBlock(16), lambda: tl.ResBlock(16, 16), (2, 8, 8, 16)),
    "head": (lambda: jl.Head(16, 3, -2.19), lambda: tl.Head(8, 16, 3, -2.19), (2, 8, 8, 8)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_reference(name):
    jmake, tmake, shape = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    jmod = jmake()
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    if "batch_stats" in variables:
        variables = random_bn_stats(variables, rng)
    ref = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _load(tmake(), variables)(torch.from_numpy(x))
    assert_bf16_close(got.float().numpy(), ref)


def test_upblock_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 4, 4, 16)).astype(np.float32)
    skip = rng.uniform(-1, 1, (2, 8, 8, 8)).astype(np.float32)
    jmod = jl.UpBlock(12)
    variables = random_bn_stats(
        jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(skip), train=False), rng)
    ref = jmod.apply(variables, jnp.asarray(x), jnp.asarray(skip), train=False)
    with torch.no_grad():
        got = _load(tl.UpBlock(16, 8, 12), variables)(torch.from_numpy(x), torch.from_numpy(skip))
    assert_bf16_close(got.float().numpy(), ref)


TINY = dict(input_hw=(64, 64), num_classes=3, backbone="tiny", neck_features=32,
            head_features=16)


@pytest.fixture(scope="module")
def tiny_pair():
    """(flax model, variables with random BN stats, port model, input)."""
    spec = get_model("centernet")
    jm = spec.create_model(spec.params_cls(**TINY))
    rng = np.random.default_rng(11)
    variables = random_bn_stats(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False), rng)
    tm = create_model(CenternetParams(**TINY), "cpu")
    tm.load_state_dict(convert_variables(variables), strict=True)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return jm, variables, tm, x


def test_centernet_matches_reference(tiny_pair):
    jm, variables, tm, x = tiny_pair
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        assert_bf16_close(got[k].numpy(), ref[k])


def test_fold_bn_matches_unfolded_and_reference(tiny_pair):
    jm, variables, tm, x = tiny_pair
    folded = fold_batchnorm(tm)
    assert not any(isinstance(m, tl.BatchNorm) for m in folded.modules())
    assert any(isinstance(m, tl.BatchNorm) for m in tm.modules()), "input model changed"
    with torch.no_grad():
        got = folded(torch.from_numpy(x))
        unfolded = tm(torch.from_numpy(x))
    fv, table = j_fold(variables)

    def apply_folded(v, x):
        with bn_folded_inference(table):
            return jm.apply(v, x, train=False)

    ref = jax.jit(apply_folded)(fv, jnp.asarray(x))
    for k in ref:
        assert_bf16_close(got[k].numpy(), unfolded[k].numpy())
        assert_bf16_close(got[k].numpy(), ref[k])
