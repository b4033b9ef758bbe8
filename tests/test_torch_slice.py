"""The whole yuv420 serving slice of cvm_tpu_torch against cvm_tpu's
InferencePipeline, at tiny/32^2, in both postures: fp with BN folded, and
W8A8 through the fused kernel with int8-resident ResBlocks.

Both sides get the same converted weights (with non-trivial BN stats), the
same calibration table (the reference's, converted) and the same planes.
Tolerances: XLA's CPU backend does not round the reference's bf16 head
convs to bf16 (its heads are not bf16-representable), while the port's
heads are bf16 as on the card. Heads therefore agree to about one bf16 step
in fp (bound: 3% of the head's magnitude); in int8 a bf16 step upstream can
move an activation across a lattice boundary, one lattice step of that
conv's input (bound: 6%). Decoded scores are compared slot by slot: near
p = 0.11 one bf16 logit step is 1.6e-3 in probability, and equal bf16 logits
give runs of equal scores where the reference's are distinct, so sorted
scores agree to 0.01. For the same reason the order of near-equal
detections, and with it boxes and classes slot by slot, is not compared.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvm_tpu.ops.pallas.fused_qconv as j_kernel_mod
from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline, _postprocess
from cvm_tpu.infer.quantize import calibrate_activation_scales as j_calibrate
from cvm_tpu.models import get_model
from cvm_tpu.pipeline.preprocess import preprocess_yuv420_batch as j_preprocess
from cvm_tpu_torch.convert import convert_scales, convert_variables
from cvm_tpu_torch.infer import quantize as t_quantize
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.server import DynamicBatcher
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch

from test_torch_model import random_bn_stats

CFG = dict(input_hw=(32, 32), num_classes=3, backbone="tiny", neck_features=16,
           head_features=8, top_k=10, batch_size=2)
KEYS = ("y", "u", "v", "image_hw")


@pytest.fixture(scope="module")
def setup():
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


def _run_reference(spec, jp, variables, batch, **kw):
    """The reference pipeline's program, returning its heads too."""
    pipe = JPipeline(spec, jp, variables, input_format="yuv420", **kw)

    def run(v, y, u, vv, hw):
        proc, rois = j_preprocess(None, y, u, vv, hw, jp.input_hw, train=False,
                                  out_dtype=jnp.bfloat16)
        out = pipe._apply(v, proc, train=False)
        return out, _postprocess("centernet", jp, out, rois)

    return jax.jit(run)(pipe._variables, *(jnp.asarray(batch[k]) for k in KEYS))


def _port_heads(pipe, batch):
    args = [torch.from_numpy(batch[k]) for k in KEYS]
    proc, _ = preprocess_yuv420_batch(*args, pipe.cfg.input_hw, out_dtype=torch.bfloat16)
    with torch.no_grad():
        return pipe.model(proc)


def _compare(heads, res, jheads, jres, head_tol):
    """Heads within ``head_tol`` of their magnitude; scores slot by slot."""
    for k in ("heatmap", "offset", "size"):
        ref = np.asarray(jheads[k])
        got = heads[k].numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= head_tol * np.abs(ref).max(), k
    assert res["scores"].shape == (2, CFG["top_k"])
    assert np.isfinite(res["boxes"].numpy()).all()
    np.testing.assert_allclose(res["scores"].numpy(), np.asarray(jres["scores"]), atol=0.01)


def test_slice_fold_bn_matches_reference(setup):
    spec, jp, variables, _, tm, batch = setup
    jheads, jres = _run_reference(spec, jp, variables, batch, fold_bn=True)
    pipe = InferencePipeline(CenternetParams(**CFG), tm, "cpu", fold_bn=True)
    res = pipe(batch)
    _compare(_port_heads(pipe, batch), res, jheads, jres, head_tol=0.03)


def test_slice_w8a8_fused_chain_matches_reference(setup, monkeypatch):
    spec, jp, variables, jscales, tm, batch = setup
    j_calls, t_calls = [], []
    j_real, t_real = j_kernel_mod.fused_qconv, t_quantize.fused_qconv

    def j_count(*a, **kw):
        j_calls.append(kw.get("out_dtype"))
        return j_real(*a, **kw)

    def t_count(*a, **kw):
        t_calls.append(kw.get("out_dtype"))
        return t_real(*a, **kw)

    monkeypatch.setattr(j_kernel_mod, "fused_qconv", j_count)
    monkeypatch.setattr(t_quantize, "fused_qconv", t_count)
    jheads, jres = _run_reference(spec, jp, variables, batch, w8a8=jscales,
                                  w8a8_fused=True, w8a8_chain=True)
    pipe = InferencePipeline(CenternetParams(**CFG), tm, "cpu", w8a8=convert_scales(jscales),
                             w8a8_fused=True, w8a8_chain=True)
    assert pipe.fused_counts == {"convbn": 10, "resblock": 6, "calls": 22}
    res = pipe(batch)
    # One traced forward on the reference side, one eager forward here.
    assert len(j_calls) == len(t_calls) == 22
    assert t_calls.count(torch.int8) == 6 == j_calls.count(jnp.int8)
    _compare(_port_heads(pipe, batch), res, jheads, jres, head_tol=0.06)


def test_dynamic_batcher_round_trip(setup):
    *_, tm, batch = setup
    pipe = InferencePipeline(CenternetParams(**CFG), tm, "cpu", fold_bn=True)
    direct = pipe(batch)
    batcher = DynamicBatcher(lambda *a: pipe(dict(zip(KEYS, a))), batch_size=2,
                             max_wait_ms=50)
    results = [None] * 3
    rows = [0, 1, 1]

    def client(i):
        results[i] = batcher.submit([batch[k][rows[i]:rows[i] + 1] for k in KEYS])

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        batcher.close()
    for i, r in enumerate(results):
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(r[k][0], direct[k][rows[i]].numpy())
    assert batcher.stats()["requests"] == 3
