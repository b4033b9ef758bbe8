"""cvm_tpu_torch.ops.image and .pipeline.preprocess against the reference.

Same numpy-made inputs through cvm_tpu (JAX, CPU) and the port (PyTorch,
CPU). The resample is float32 arithmetic in the same order on both sides,
so values agree to float32 rounding (1e-4 on the 0..255 scale, 1e-5 after
normalization to [-1, 1]).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.ops import image as jimage
from cvm_tpu.pipeline.preprocess import preprocess_yuv420_batch as j_preprocess
from cvm_tpu.native import _rgb_to_yuv420_np
from cvm_tpu_torch.data.synthetic import rgb_to_yuv420, synthetic_yuv420_batch
from cvm_tpu_torch.ops.image import (full_roi, letterbox_roi, map_boxes_to_input,
                                     normalize_pm1, sample_bilinear, yuv_to_rgb)
from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch

_G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ops_goldens.npz"))


def _hw(h, w):
    return torch.tensor([float(h)]), torch.tensor([float(w)])


def test_letterbox_matches_golden():
    h, w = _hw(70, 110)
    roi = letterbox_roi(h, w, 48, 64)
    out = sample_bilinear(torch.from_numpy(_G["src_img"])[None], roi, (48, 64),
                          valid_hw=(torch.tensor([70]), torch.tensor([110])))
    np.testing.assert_allclose(out[0].numpy(), _G["letterboxed"], atol=1e-4)


@pytest.mark.parametrize("in_hw,out_hw,valid_hw", [
    ((37, 53), (64, 96), None),
    ((128, 200), (64, 96), None),
    ((40, 60), (24, 32), (31, 45)),   # clamped to the valid extent of a padded buffer
])
def test_full_roi_resample_matches_reference(in_hw, out_hw, valid_hw):
    img = np.random.default_rng(sum(in_hw)).uniform(0, 255, (*in_hw, 3)).astype(np.float32)
    h, w = valid_hw or in_hw
    ref = jimage.sample_bilinear(jnp.asarray(img), jimage.full_roi(h, w, *out_hw), out_hw,
                                 valid_hw=valid_hw)
    roi = full_roi(torch.tensor([float(h)]), torch.tensor([float(w)]), *out_hw)
    vhw = None if valid_hw is None else (torch.tensor([h]), torch.tensor([w]))
    got = sample_bilinear(torch.from_numpy(img)[None], roi, out_hw, valid_hw=vhw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=1e-4)


def test_yuv_to_rgb_and_normalize_match_reference():
    rng = np.random.default_rng(12)
    y, u, v = (rng.uniform(0, 255, (2, 6, 10)).astype(np.float32) for _ in range(3))
    ref = jimage.yuv_to_rgb(*map(jnp.asarray, (y, u, v)))
    got = yuv_to_rgb(*map(torch.from_numpy, (y, u, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(normalize_pm1(got).numpy(),
                               np.asarray(jimage.normalize_pm1(ref)), atol=1e-6)


def test_map_boxes_to_input_inverts_golden_mapping():
    """The golden holds boxes mapped source -> canvas; mapping them back
    must give the source boxes."""
    roi = letterbox_roi(*_hw(70, 110), 48, 64)
    back = map_boxes_to_input(torch.from_numpy(_G["mapped_boxes"])[None], roi)[0]
    src = np.array([[5.0, 10.0, 60.0, 50.0], [30.0, 20.0, 100.0, 65.0]], np.float32)
    np.testing.assert_allclose(back.numpy(), src, atol=1e-4)


def test_map_boxes_to_input_matches_reference():
    rng = np.random.default_rng(3)
    hw = rng.integers(40, 200, (4, 2)).astype(np.int32)
    boxes = rng.uniform(0, 64, (4, 7, 4)).astype(np.float32)
    jrois = jax.vmap(lambda s: jimage.letterbox_roi(s[0], s[1], 64, 96))(jnp.asarray(hw))
    ref = jax.vmap(jimage.map_boxes_to_input)(jnp.asarray(boxes), jrois)
    t_hw = torch.from_numpy(hw)
    got = map_boxes_to_input(torch.from_numpy(boxes),
                             letterbox_roi(t_hw[:, 0], t_hw[:, 1], 64, 96))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("out_hw,pad_hw", [((32, 32), (48, 48)), ((64, 96), (90, 60))])
def test_preprocess_yuv420_matches_reference(out_hw, pad_hw):
    b = synthetic_batch(np.random.default_rng(sum(out_hw)), 3, pad_hw, yuv420=True)
    planes = [b[k] for k in ("y", "u", "v", "image_hw")]
    ref, jrois = j_preprocess(None, *map(jnp.asarray, planes), out_hw, train=False)
    got, rois = preprocess_yuv420_batch(*map(torch.from_numpy, planes), out_hw)
    assert got.shape == (3, *out_hw, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for name in ("src_h", "src_w", "dst_y0", "dst_x0", "dst_h", "dst_w"):
        np.testing.assert_array_equal(getattr(rois, name).numpy(),
                                      np.asarray(getattr(jrois, name)))
    # bf16 serving output: the same values rounded once to bfloat16.
    got_bf, _ = preprocess_yuv420_batch(*map(torch.from_numpy, planes), out_hw,
                                        out_dtype=torch.bfloat16)
    ref_bf, _ = j_preprocess(None, *map(jnp.asarray, planes), out_hw, train=False,
                             out_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got_bf.float().numpy(),
                               np.asarray(ref_bf, np.float32), atol=2 ** -8)


def test_rgb_to_yuv420_matches_reference():
    rgb = np.random.default_rng(8).integers(0, 256, (6, 10, 3)).astype(np.uint8)
    for got, ref in zip(rgb_to_yuv420(rgb), _rgb_to_yuv420_np(rgb)):
        np.testing.assert_array_equal(got, ref)


def test_synthetic_yuv420_batch_preprocesses_like_reference():
    b = synthetic_yuv420_batch(np.random.default_rng(9), 2, (40, 56))
    assert b["y"].shape == (2, 40, 56) and b["u"].shape == (2, 20, 28)
    planes = [b[k] for k in ("y", "u", "v", "image_hw")]
    ref, _ = j_preprocess(None, *map(jnp.asarray, planes), (32, 32), train=False)
    got, _ = preprocess_yuv420_batch(*map(torch.from_numpy, planes), (32, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
