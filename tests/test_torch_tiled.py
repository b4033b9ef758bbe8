"""Tiled inference (``infer/tiled.py``) against the reference's
(``cvm_tpu/infer/tiled.py``), on the CPU.

Exact (integer arithmetic or the same float32 operations in the same
order): ``tile_positions`` and the Hann window; ``tiled_apply`` of a
per-pixel affine map within 1e-5 (the blend adds tile by tile in the same
order on both sides). ``tiled_predict`` of a tiny semseg and a tiny
multitask (converted weights) over an image that is not a multiple of the
tile, at the models' bf16 tolerance (``test_torch_model.assert_bf16_close``:
max |d| <= 3% and mean |d| <= 0.5% of the largest value), the class maps
agreeing on >= 98% of the pixels (bf16 near-ties); a ``qat`` config
tiles under fake-quant on both sides, held at max |d| <= 10% and mean |d|
<= 2% of the largest logit and >= 90% agreement (an int8 step flips where
the bf16 rounding differs: the same model's untiled fake-quant forward is
6.5% / 1.1% from the reference's, as ``tests/test_torch_qat.py`` allows
for its steps); detection is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.infer import tiled as jtiled
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.infer import tiled
from cvm_tpu_torch.models import get_model
from test_torch_model import assert_bf16_close, random_bn_stats


def test_tile_positions_and_window_are_the_references():
    for full in (1, 31, 64, 65, 100, 257, 640):
        for tile in (32, 64, 256):
            for overlap in (0.0, 0.25, 0.5, 0.9):
                assert tiled.tile_positions(full, tile, overlap) == \
                    jtiled.tile_positions(full, tile, overlap), (full, tile, overlap)
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="overlap"):
            tiled.tile_positions(100, 32, bad)
    for th, tw in ((64, 96), (7, 5)):
        np.testing.assert_array_equal(tiled._hann2d(th, tw), np.asarray(jtiled._hann2d(th, tw)))


@pytest.mark.parametrize("hw,tile,overlap,tile_batch", [((100, 150), (32, 48), 0.25, 4),
                                                       ((20, 30), (32, 48), 0.25, 8),
                                                       ((64, 96), (32, 32), 0.5, 3)])
def test_tiled_apply_matches_reference(hw, tile, overlap, tile_batch):
    rng = np.random.default_rng(sum(hw))
    image = rng.uniform(-1, 1, (*hw, 3)).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)

    def ref_fn(t):
        return t @ jnp.asarray(w) + 0.5

    got = tiled.tiled_apply(lambda t: t @ torch.from_numpy(w) + 0.5, torch.from_numpy(image),
                            tile, overlap, tile_batch)
    want = jtiled.tiled_apply(ref_fn, jnp.asarray(image), tile, overlap, tile_batch)
    assert tuple(got.shape) == (*hw, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # an affine map commutes with the normalized blend
    np.testing.assert_allclose(got.numpy(), image @ w + 0.5, atol=1e-4)


TINY = {"semseg": dict(input_hw=(64, 96), backbone="tiny", decoder_features=16, batch_size=2),
        "multitask": dict(input_hw=(64, 96), backbone="tiny", neck_features=32,
                          head_features=16, batch_size=2, num_det_classes=3),
        "semseg_qat": dict(input_hw=(64, 96), backbone="tiny", decoder_features=16,
                           batch_size=2, qat=True)}


@pytest.mark.parametrize("case", sorted(TINY))
def test_tiled_predict_matches_reference(case):
    """``semseg_qat``: a ``qat`` config tiles under fake-quant on both sides."""
    name = case.split("_")[0]
    jspec, tspec = j_get_model(name), get_model(name)
    jp, tp = jspec.params_cls(**TINY[case]), tspec.params_cls(**TINY[case])
    variables = random_bn_stats(jspec.create_model(jp).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)), train=False),
        np.random.default_rng(5))
    tm = tspec.create_model(tp, "cpu")
    tm.load_state_dict(convert_variables(variables), strict=True)
    yy, xx = np.mgrid[0:101, 0:157]
    image = np.stack([(yy * 3 + xx) % 256, (xx * 5) % 256, (yy * 7 + 2 * xx) % 256],
                     -1).astype(np.uint8)
    ref = jtiled.tiled_predict(jspec, jp, variables, image, overlap=0.25, tile_batch=4)
    got = tiled.tiled_predict(tp, tm, image, overlap=0.25, tile_batch=4)
    assert set(got) == set(ref)
    for k in ("logits", "depth"):
        if k in ref:
            assert tuple(got[k].shape) == (101, 157, ref[k].shape[-1])
            if tp.qat:
                # one int8 step (1/127 of an activation's range) flips where
                # the two sides' bf16 rounding differs, and propagates: this
                # model's untiled fake-quant forward is already 6.5% (max)
                # and 1.1% (mean) of its largest logit from the reference's
                d = np.abs(got[k].numpy() - np.asarray(ref[k]))
                scale = float(np.abs(np.asarray(ref[k])).max())
                assert d.max() <= 0.1 * scale and d.mean() <= 0.02 * scale, (d.max(), scale)
            else:
                assert_bf16_close(got[k].numpy(), np.asarray(ref[k]))
    agree = float((got["class_map"].numpy() == np.asarray(ref["class_map"])).mean())
    assert agree >= (0.9 if tp.qat else 0.98), agree


def test_tiled_predict_refuses_detection():
    cfg = get_model("centernet").params_cls(input_hw=(64, 64), backbone="tiny")
    with pytest.raises(ValueError, match="dense-prediction models, not 'centernet'"):
        tiled.tiled_predict(cfg, torch.nn.Linear(1, 1), np.zeros((8, 8, 3), np.uint8))
