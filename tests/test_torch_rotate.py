"""Rotation augmentation (``ops/image.py::rotate_points/rotate_boxes/
rotate_image``, ``pipeline/preprocess.py::rotate_image_batch``) against the
reference (``cvm_tpu/ops/image.py``, ``cvm_tpu/pipeline/preprocess.py``),
on the CPU.

* The ops on seeded inputs: a quarter turn of a square image exactly (the
  nearest path bit-equal to np.rot90 and to the reference; bilinear within
  1e-5 of the reference, and within 1e-4 of np.rot90 on the 0..255 scale:
  cos(pi/2) is -4.4e-8 in float32 on both sides); other angles bilinear within 1e-5 of the
  reference on the 0..255 scale, nearest identical, points and boxes
  within 1e-5 px.
* Each of the five processors in training with ``aug_rotate_deg > 0``
  and the reference's draws injected (its ROI and photometric numbers, and
  the roll angles ``sample_rotation`` draws from the same key): the image
  within 1e-4 on the [-1, 1] scale (as the CenterNet processor's test
  holds it), the rotated class mask and depth identical, CenterNet's and
  multitask's heatmap (kernel K1's plain version on the CPU) within 1e-5
  with equal centre masks and indices; DMDS ignores the field, as the
  reference's processor does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.ops import image as jimage
from cvm_tpu.pipeline.preprocess import rotate_image_batch as j_rotate_batch
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.ops import image as timage
from cvm_tpu_torch.pipeline.preprocess import aug_from_params, rotate_image_batch
from test_torch_processor import jax_draws

T = torch.from_numpy


def test_quarter_turn_is_exact():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1, 9, 9, 3)).astype(np.uint8)
    a = np.float32([math.pi / 2])
    near = timage.rotate_image(T(img), T(a), method="nearest").numpy()
    # counter-clockwise in image coordinates (y down): np.rot90 clockwise
    np.testing.assert_array_equal(near[0], np.rot90(img[0], k=-1))
    ref = np.asarray(jimage.rotate_image(jnp.asarray(img[0]), a[0], method="nearest"))
    np.testing.assert_array_equal(near[0], ref)
    bil = timage.rotate_image(T(img.astype(np.float32)), T(a)).numpy()
    ref = np.asarray(jimage.rotate_image(jnp.asarray(img[0], jnp.float32), a[0]))
    np.testing.assert_allclose(bil[0], ref, atol=1e-5, rtol=0)
    # float32's cos(pi/2) moves each sample by < 1e-6 px: 255 * 2e-7 at most
    np.testing.assert_allclose(bil[0], np.rot90(img[0], k=-1).astype(np.float32), atol=1e-4)


@pytest.mark.parametrize("shape,dtype", [((3, 17, 23, 3), np.uint8),
                                         ((3, 16, 16), np.int32),
                                         ((3, 20, 12), np.float32)])
def test_rotate_image_matches_reference(shape, dtype):
    rng = np.random.default_rng(len(shape))
    img = (rng.integers(0, 256, shape) if dtype != np.float32
           else rng.uniform(0, 80, shape)).astype(dtype)
    ang = rng.uniform(-0.6, 0.6, shape[0]).astype(np.float32)
    for method, pad in (("bilinear", 0.0), ("nearest", 255 if dtype == np.int32 else 0)):
        got = rotate_image_batch(T(img), T(ang), pad_value=pad, method=method).numpy()
        want = np.asarray(j_rotate_batch(jnp.asarray(img), jnp.asarray(ang), pad, method))
        assert got.dtype == want.dtype and got.shape == want.shape
        if method == "nearest":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rotate_points_and_boxes_match_reference():
    rng = np.random.default_rng(3)
    boxes = np.sort(rng.uniform(0, 60, (4, 5, 4)).astype(np.float32).reshape(4, 5, 2, 2),
                    axis=2).transpose(0, 1, 3, 2).reshape(4, 5, 4)
    boxes = boxes[..., [0, 2, 1, 3]]
    ang = rng.uniform(-1, 1, 4).astype(np.float32)
    center = (31.5, 23.5)
    got = timage.rotate_boxes(T(boxes), T(ang), center).numpy()
    want = np.stack([np.asarray(jimage.rotate_boxes(jnp.asarray(b), a, center))
                     for b, a in zip(boxes, ang)])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    pts = rng.uniform(0, 60, (7, 2)).astype(np.float32)
    np.testing.assert_allclose(timage.rotate_points(T(pts), 0.3, center).numpy(),
                               np.asarray(jimage.rotate_points(jnp.asarray(pts), 0.3, center)),
                               atol=1e-5, rtol=0)


HW = (64, 96)
PAD = (80, 112)
TINY = {
    "centernet": dict(input_hw=(64, 64), num_classes=3, max_objects=8, stride=4),
    "semseg": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=3),
    "depth": dict(input_hw=HW, backbone="tiny", decoder_features=16, batch_size=3),
    "multitask": dict(input_hw=HW, backbone="tiny", neck_features=32, head_features=16,
                      batch_size=3, num_det_classes=3, max_objects=8),
}
KEYS = ("image", "image_hw", "boxes", "classes", "num_objects", "mask", "depth")


def _reference_angles(key, B, rotate_deg):
    r = rotate_deg * jnp.pi / 180.0
    return T(np.array(jax.random.uniform(jax.random.fold_in(key, 0x526F74), (B,),
                                           jnp.float32, -r, r)))


@pytest.mark.parametrize("name", ["centernet", "semseg", "depth", "multitask"])
def test_processors_roll_as_the_reference(name):
    B = 3
    raw = j_synthetic_batch(np.random.default_rng(11), B, PAD, num_classes=3, max_objects=8)
    raw = {k: raw[k] for k in KEYS if k in raw}
    key = jax.random.PRNGKey(4)
    fields = dict(TINY[name], aug_rotate_deg=25.0)
    jp = j_get_model(name).params_cls(**fields)
    tp = get_model(name).params_cls(**fields)
    rimages, rt = j_get_model(name).make_processor(jp, True)(
        key, {k: jnp.asarray(v) for k, v in raw.items()})
    draws = jax_draws(key, B, tp.input_hw, aug_from_params(tp))._replace(
        angle=_reference_angles(key, B, 25.0))
    assert float(draws.angle.abs().min()) > 0.02  # every sample really rolls
    images, tt = get_model(name).make_processor(tp, True)(
        None, {k: T(v) for k, v in raw.items()}, draws=draws)
    np.testing.assert_allclose(images.numpy(), np.asarray(rimages), atol=1e-4, rtol=0)
    det = (tt, rt) if name == "centernet" else (tt.get("det"), rt.get("det"))
    if det[0] is not None:
        got, ref = det
        np.testing.assert_allclose(got.heatmap.numpy(), np.asarray(ref.heatmap), atol=1e-5)
        for f in ("mask", "indices", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)
    for k in ("classes", "depth"):
        if isinstance(tt, dict) and k in tt:
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(rt[k]), err_msg=k)
    if name in ("semseg", "multitask"):
        # corners rotated in from outside carry ignore_index
        assert (tt["classes"] == tp.ignore_index).any()


def test_dmds_processor_ignores_rotation_as_the_reference():
    from test_torch_dmds import CFG, _dmds_draws, _raw

    from cvm_tpu.pipeline.preprocess import aug_from_params as j_aug

    raw = _raw(5, False, 3)
    raw.pop("depth")
    key = jax.random.PRNGKey(9)
    jp = j_get_model("dmds").params_cls(**CFG, aug_rotate_deg=20.0)
    tp = get_model("dmds").params_cls(**CFG, aug_rotate_deg=20.0)
    rin, rt = j_get_model("dmds").make_processor(jp, True)(
        key, {k: jnp.asarray(v) for k, v in raw.items()})
    tin, tt = get_model("dmds").make_processor(tp, True)(
        None, {k: T(v) for k, v in raw.items()}, draws=_dmds_draws(key, 3, j_aug(jp, 0.0)))
    np.testing.assert_allclose(tin.numpy(), np.asarray(rin), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt["frames"].numpy(), np.asarray(rt["frames"]), atol=1e-6)


def test_rotation_draws_from_the_generator():
    """The port's own angles: in [-rotate_deg, rotate_deg], drawn only when
    rotation is on, and a training batch rolls by them."""
    from cvm_tpu_torch.pipeline.preprocess import draw_augmentation

    aug = aug_from_params(get_model("semseg").params_cls(**TINY["semseg"], aug_rotate_deg=10))
    d = draw_augmentation(torch.Generator().manual_seed(0), 2000, (4, 4), aug)
    assert float(d.angle.abs().max()) <= math.radians(10) + 1e-6
    assert abs(float(d.angle.mean())) < 0.01
    off = aug_from_params(get_model("semseg").params_cls(**TINY["semseg"]))
    assert draw_augmentation(torch.Generator().manual_seed(0), 2, (4, 4), off).angle is None
