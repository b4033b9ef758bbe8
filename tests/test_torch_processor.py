"""The CenterNet training processor (cvm_tpu_torch) against the reference.

JAX's random streams cannot be reproduced in torch, so the port draws its
augmentation numbers separately from the deterministic core. Here the
numbers are drawn with ``jax.random`` exactly as the reference draws them
(same key splits) and injected into the port; the reference processor runs
on the same key and batch. Images then agree to float32 rounding (1e-4 on
the [-1, 1] scale), heatmaps to 1e-5, and offset/size wherever no two
objects share a centre. The port's own draws are checked statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.synthetic import synthetic_batch
from cvm_tpu.models.centernet.params import CenternetParams as JParams
from cvm_tpu.models.centernet.processor import make_processor as j_make_processor
from cvm_tpu.ops import image as jimage
from cvm_tpu_torch.data.synthetic import synthetic_yuv420_batch
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.models.centernet.processor import make_processor
from cvm_tpu_torch.ops import image as timage
from cvm_tpu_torch.pipeline.preprocess import (AugDraws, aug_from_params, draw_augmentation,
                                               sample_rotation)

TINY = dict(input_hw=(64, 64), num_classes=3, max_objects=8, stride=4)


def jax_draws(key, B, out_hw, aug) -> AugDraws:
    """The numbers the reference's train preprocess draws from ``key``
    (preprocess_*_batch -> make_rois/jittered_roi, photometric_augment)."""
    key_roi, key_photo = jax.random.split(key)
    roi = []
    for k in jax.random.split(key_roi, B):
        k_s, k_y, k_x, k_f = jax.random.split(k, 4)
        roi.append((jax.random.uniform(k_s, (), jnp.float32, *aug.scale_range),
                    jax.random.uniform(k_y, (), jnp.float32, -aug.shift_frac, aug.shift_frac),
                    jax.random.uniform(k_x, (), jnp.float32, -aug.shift_frac, aug.shift_frac),
                    jax.random.bernoulli(k_f, aug.flip_prob)))
    photo = []
    for k in jax.random.split(key_photo, B):
        kb, kc, ks, kh, kn1, kn2, kbl = jax.random.split(k, 7)
        photo.append((
            jax.random.uniform(kb, (), jnp.float32, -aug.brightness, aug.brightness),
            jax.random.uniform(kc, (), jnp.float32, -aug.contrast, aug.contrast),
            jax.random.uniform(ks, (), jnp.float32, -aug.saturation, aug.saturation),
            jax.random.uniform(kh, (), jnp.float32, -aug.hue, aug.hue),
            jax.random.uniform(kn1, (), jnp.float32, 0.0, aug.noise_std * 255.0),
            jax.random.normal(kn2, (*out_hw, 3), jnp.float32),
            jax.random.uniform(kbl, (), jnp.float32) < aug.blur_prob))

    def col(rows, i):
        return torch.from_numpy(np.stack([np.asarray(r[i]) for r in rows]))

    roi_d = timage.RoiDraws(*(col(roi, i) for i in range(4)))
    ph = timage.PhotoDraws(*(col(photo, i) for i in range(4)))
    if aug.noise_std > 0:
        ph = ph._replace(noise_sigma=col(photo, 4), noise=col(photo, 5))
    if aug.blur_prob > 0:
        ph = ph._replace(blur=col(photo, 6))
    return AugDraws(roi_d, ph)


def _unique_centres(targets):
    B = targets.valid.shape[0]
    n = targets.mask[0].numel()
    counts = np.zeros((B, n), int)
    for b in range(B):
        np.add.at(counts[b], targets.indices[b][targets.valid[b]].numpy(), 1)
    return (counts <= 1).reshape(targets.mask.shape)


def assert_processed_close(got, ref):
    images, t = got
    rimages, rt = ref
    np.testing.assert_allclose(images.numpy(), np.asarray(rimages), atol=1e-4)
    np.testing.assert_allclose(t.heatmap.numpy(), np.asarray(rt.heatmap), atol=1e-5)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(rt.valid))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(rt.indices))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(rt.mask))
    keep = _unique_centres(t)
    for name in ("offset", "size"):
        np.testing.assert_allclose(getattr(t, name).numpy()[keep],
                                   np.asarray(getattr(rt, name))[keep], atol=1e-4,
                                   err_msg=name)


CASES = {
    "rgb_default": (dict(), "rgb"),
    "rgb_noise_blur": (dict(aug_noise_std=0.05, aug_blur_prob=0.5), "rgb"),
    "yuv420_default": (dict(), "yuv420"),
    "rgb_plain_splat": (dict(use_pallas_splat=False), "rgb"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_processor_matches_reference_with_injected_draws(case):
    extra, fmt = CASES[case]
    B = 3
    rng = np.random.default_rng(len(case))
    if fmt == "rgb":
        raw = synthetic_batch(rng, B, (80, 96), num_classes=3, max_objects=8)
        raw = {k: raw[k] for k in ("image", "image_hw", "boxes", "classes", "num_objects")}
    else:
        raw = synthetic_yuv420_batch(rng, B, (80, 96), num_classes=3, max_objects=8)
    key = jax.random.PRNGKey(0)  # mixed flips and blurs across the batch
    jp = JParams(**TINY, **extra)
    ref = j_make_processor(jp, train=True)(key, {k: jnp.asarray(v) for k, v in raw.items()})
    tp = CenternetParams(**TINY, **extra)
    draws = jax_draws(key, B, tp.input_hw, aug_from_params(tp))
    if case == "rgb_noise_blur":
        assert 0 < int(draws.photo.blur.sum()) < B  # both branches of the blur
    assert 0 < int(draws.roi.flip.sum()) < B
    got = make_processor(tp, train=True)(None, {k: torch.from_numpy(v) for k, v in raw.items()},
                                         draws=draws)
    assert_processed_close(got, ref)


def test_eval_processor_matches_reference():
    raw = synthetic_batch(np.random.default_rng(3), 2, (80, 96), num_classes=3, max_objects=8)
    raw = {k: raw[k] for k in ("image", "image_hw", "boxes", "classes", "num_objects")}
    ref = j_make_processor(JParams(**TINY), train=False)(None, {k: jnp.asarray(v)
                                                                 for k, v in raw.items()})
    got = make_processor(CenternetParams(**TINY), train=False)(
        None, {k: torch.from_numpy(v) for k, v in raw.items()})
    assert_processed_close(got, ref)


def test_map_boxes_to_output_broadcasts_batched_rois():
    """(B,) Roi fields against (B, K, 4) boxes, with a different flip per
    image: the port's written-out broadcast equals the reference's vmap."""
    rng = np.random.default_rng(4)
    B, K = 4, 5
    hw = rng.integers(40, 120, (B, 2)).astype(np.float32)
    d = timage.RoiDraws(torch.tensor([0.7, 1.0, 1.3, 0.9]), torch.tensor([0.05, -0.1, 0.0, 0.1]),
                        torch.tensor([-0.02, 0.08, 0.1, -0.1]),
                        torch.tensor([True, False, True, False]))
    boxes = rng.uniform(0, 100, (B, K, 4)).astype(np.float32)
    roi = timage.jittered_roi(torch.from_numpy(hw[:, 0]), torch.from_numpy(hw[:, 1]), 64, 48, d)
    got = timage.map_boxes_to_output(torch.from_numpy(boxes), roi)
    jroi = jimage.Roi(*(jnp.asarray(f.numpy()) for f in roi))
    want = jax.vmap(jimage.map_boxes_to_output)(jnp.asarray(boxes), jroi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(timage.clip_boxes(got, (64, 48)).numpy(),
                               np.asarray(jimage.clip_boxes(want, (64, 48))), atol=1e-4)


def test_own_draws_statistics():
    aug = aug_from_params(CenternetParams(aug_noise_std=0.1, aug_blur_prob=0.3,
                                          aug_rotate_deg=10.0))
    gen = torch.Generator().manual_seed(0)
    n = 20000
    d = draw_augmentation(gen, n, (4, 4), aug)
    r, p = d.roi, d.photo
    assert 0.6 <= float(r.zoom.min()) and float(r.zoom.max()) < 1.4
    assert abs(float(r.zoom.mean()) - 1.0) < 0.01
    for s in (r.shift_y, r.shift_x):
        assert -0.1 <= float(s.min()) and float(s.max()) <= 0.1 and abs(float(s.mean())) < 0.003
    assert abs(float(r.flip.float().mean()) - 0.5) < 0.015
    for v, lim in ((p.brightness, 0.2), (p.contrast, 0.2), (p.saturation, 0.2), (p.hue, 0.05)):
        assert -lim <= float(v.min()) and float(v.max()) <= lim
        assert abs(float(v.mean())) < 0.02 * lim * 2
    assert 0.0 <= float(p.noise_sigma.min()) and float(p.noise_sigma.max()) <= 0.1 * 255
    assert abs(float(p.noise.mean())) < 0.01 and abs(float(p.noise.std()) - 1.0) < 0.01
    assert abs(float(p.blur.float().mean()) - 0.3) < 0.015
    ang = sample_rotation(gen, n, aug)
    assert float(ang.abs().max()) <= np.deg2rad(10.0) + 1e-6
    assert sample_rotation(None, n, aug) is None
    off = draw_augmentation(gen, 8, (4, 4), aug_from_params(CenternetParams()))
    assert off.photo.noise is None and off.photo.blur is None
    # the same generator seed gives the same draws
    a = draw_augmentation(torch.Generator().manual_seed(3), 4, (4, 4), aug)
    b = draw_augmentation(torch.Generator().manual_seed(3), 4, (4, 4), aug)
    torch.testing.assert_close(a.photo.noise, b.photo.noise, rtol=0, atol=0)


def test_train_processor_draws_from_its_generator():
    raw = synthetic_batch(np.random.default_rng(5), 2, (80, 96), num_classes=3, max_objects=8)
    raw = {k: torch.from_numpy(raw[k]) for k in ("image", "image_hw", "boxes", "classes",
                                                  "num_objects")}
    proc = make_processor(CenternetParams(**TINY), train=True)
    a, ta = proc(torch.Generator().manual_seed(1), raw)
    b, tb = proc(torch.Generator().manual_seed(1), raw)
    c, _ = proc(torch.Generator().manual_seed(2), raw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a.shape == (2, 64, 64, 3) and ta.heatmap.shape == (2, 16, 16, 3)


@pytest.mark.parametrize("field,value", [("aug_rotate_deg", 5.0)])
def test_processor_refuses_what_is_not_ported(field, value):
    """Rotation is ported: the processor takes it, and refuses it only where
    the reference does (with the 3D heads)."""
    make_processor(CenternetParams(**{field: value}), train=True)
    with pytest.raises(ValueError, match="incompatible with with_3d"):
        make_processor(CenternetParams(**{field: value}, with_3d=True), train=True)
