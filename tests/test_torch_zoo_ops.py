"""The dense models' image and decode ops, the registry and the converter's
bare leaves (cvm_tpu_torch) against the reference, on the CPU.

* ``sample_nearest``: bit-equal to the reference on class masks (int32)
  and sparse depth (float32), through letterbox, jittered and flipped
  ROIs, with pad garbage beyond each image's valid extent.
* ``upsample_bilinear`` within 1e-6; ``semseg_argmax`` (first maximum on
  ties) and ``colorize_semseg`` exact.
* ``get_model_zoo()`` names the reference's zoo, every entry registered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.models.registry import get_model_zoo as j_zoo
from cvm_tpu.ops import decode as jdecode
from cvm_tpu.ops import image as jimage
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.models import get_model, get_model_zoo
from cvm_tpu_torch.ops import decode as tdecode
from cvm_tpu_torch.ops import image as timage


def _rois(kind, hw, out_hw):
    """Port Rois with (B,) fields for ``hw`` (B, 2) valid sizes."""
    h, w = hw[:, 0], hw[:, 1]
    if kind == "letterbox":
        return timage.letterbox_roi(h, w, *out_hw)
    if kind == "letterbox_flip":
        return timage.letterbox_roi(h, w, *out_hw, flip_x=True)
    gen = torch.Generator().manual_seed(len(kind))
    draws = timage.draw_roi(gen, hw.shape[0], (0.7, 1.4), 0.1, 0.5)
    if kind == "jittered_flip":
        draws = draws._replace(flip=torch.ones_like(draws.flip))
    return timage.jittered_roi(h, w, *out_hw, draws)


def _ref_nearest(src, roi, out_hw, hw, pad):
    outs = []
    for i in range(src.shape[0]):
        r = jimage.Roi(*(jnp.asarray(f[i].numpy()) for f in roi))
        outs.append(np.asarray(jimage.sample_nearest(
            jnp.asarray(src[i]), r, out_hw, valid_hw=(int(hw[i, 0]), int(hw[i, 1])),
            pad_value=pad)))
    return np.stack(outs)


@pytest.mark.parametrize("kind", ["letterbox", "letterbox_flip", "jittered", "jittered_flip"])
@pytest.mark.parametrize("what", ["mask", "depth", "depth_channels"])
def test_sample_nearest_is_bit_equal_to_reference(kind, what):
    rng = np.random.default_rng(3)
    B, pad_hw, out_hw = 3, (50, 70), (32, 64)
    hw = np.array([[50, 70], [37, 61], [41, 49]], np.int32)
    if what == "mask":
        src, pad = rng.integers(0, 5, (B, *pad_hw)).astype(np.int32), 255
    elif what == "depth":
        src = np.where(rng.uniform(size=(B, *pad_hw)) < 0.3,
                       rng.uniform(1, 80, (B, *pad_hw)), 0).astype(np.float32)
        pad = 0.0
    else:
        src, pad = rng.uniform(0, 9, (B, *pad_hw, 2)).astype(np.float32), 0.0
    for i, (h, w) in enumerate(hw):  # garbage beyond the valid extent
        src[i, h:], src[i, :, w:] = 99, 99
    t_hw = torch.from_numpy(hw)
    roi = _rois(kind, t_hw, out_hw)
    got = timage.sample_nearest(torch.from_numpy(src), roi, out_hw,
                                valid_hw=(t_hw[:, 0], t_hw[:, 1]), pad_value=pad)
    ref = _ref_nearest(src, roi, out_hw, hw, pad)
    assert got.dtype == torch.from_numpy(src).dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not (got.numpy() == 99).any()  # pad garbage never read
    if kind.startswith("letterbox"):
        assert (got.numpy() == pad).any()  # the letterbox bars


def test_upsample_bilinear_matches_reference():
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    for out_hw in ((10, 14), (20, 35), (5, 7)):
        got = tdecode.upsample_bilinear(torch.from_numpy(x), out_hw)
        ref = np.asarray(jdecode.upsample_bilinear(jnp.asarray(x), out_hw))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_semseg_argmax_and_colorize_exact():
    rng = np.random.default_rng(1)
    logits = rng.integers(0, 3, (2, 6, 9, 5)).astype(np.float32)  # many ties
    got = tdecode.semseg_argmax(torch.from_numpy(logits))
    ref = np.asarray(jdecode.semseg_argmax(jnp.asarray(logits)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    palette = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    col = tdecode.colorize_semseg(got, torch.from_numpy(palette))
    np.testing.assert_array_equal(col.numpy(),
                                  np.asarray(jdecode.colorize_semseg(jnp.asarray(ref),
                                                                     jnp.asarray(palette))))


def test_registry_names_the_zoo_and_refuses_dmds():
    assert get_model_zoo() == j_zoo() == ["centernet", "depth", "dmds", "multitask", "semseg"]
    for name in ("centernet", "semseg", "depth", "multitask", "dmds"):
        spec = get_model(name)
        assert spec.name == name and spec.params_cls().name == name
    assert get_model("semseg").decode_fn is tdecode.semseg_argmax
    assert get_model("dmds").decode_fn is None and get_model("dmds").params_cls().input_hw == \
        (192, 640)
    with pytest.raises(KeyError):
        get_model("yolo")


def test_convert_maps_a_bare_leaf_to_a_parameter():
    v = {"params": {"task_log_vars": np.array([0.1, -0.2, 0.3], np.float32),
                    "hm": {"out": {"kernel": np.ones((1, 1, 4, 2), np.float32),
                                   "bias": np.zeros(2, np.float32)}}}}
    sd = convert_variables(jax.device_get(v))
    assert set(sd) == {"task_log_vars", "hm.out.weight", "hm.out.bias"}
    np.testing.assert_array_equal(sd["task_log_vars"].numpy(), v["params"]["task_log_vars"])
