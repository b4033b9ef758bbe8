"""cvm_tpu_torch.ops.heatmap and the plain splat of kernel K1 against the
reference (cvm_tpu.ops.heatmap, and the Pallas splat in interpret mode).

Same numpy-made boxes on both sides, CPU. The arithmetic is float32 in the
same order, so radii and centres agree to 1e-5 and the heatmaps to 1e-6
(values lie in [0, 1]; ``exp`` may differ by an ulp between libraries).
Offset, size and mask are compared only where no two valid objects share
a centre: there both sides leave the winner unspecified.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.ops import heatmap as jh
from cvm_tpu.ops.pallas.gaussian_splat import render_heatmap_pallas
from cvm_tpu_torch.ops import heatmap as th
from cvm_tpu_torch.ops.cuda.gaussian_splat import render_heatmap, render_heatmap_reference

_G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ops_goldens.npz"))


def random_boxes(rng, B, K, hs, ws, n_valid):
    """Boxes in map coords: some off the map, some zero-area, NaN padding."""
    boxes = np.full((B, K, 4), np.nan, np.float32)
    valid = np.zeros((B, K), bool)
    for b in range(B):
        for k in range(n_valid):
            x0, y0 = rng.uniform(-4, ws + 2), rng.uniform(-4, hs + 2)
            w, h = rng.uniform(0, 18), rng.uniform(0, 14)
            if k % 5 == 4:
                w = 0.0                                   # zero area: dropped
            boxes[b, k] = [x0, y0, x0 + w, y0 + h]
            valid[b, k] = True
    return boxes, valid


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_gaussian_radius_matches_reference():
    rng = np.random.default_rng(0)
    h = np.concatenate([[0, 0, 1, 3], rng.uniform(0, 60, 40)]).astype(np.float32)
    w = np.concatenate([[0, 5, 1, 0], rng.uniform(0, 60, 40)]).astype(np.float32)
    for mo in (0.7, 0.5):
        np.testing.assert_allclose(th.gaussian_radius(_t(h), _t(w), mo).numpy(),
                                   np.asarray(jh.gaussian_radius(h, w, mo)), rtol=1e-6,
                                   atol=1e-5)


def test_prepare_centers_matches_reference():
    rng = np.random.default_rng(1)
    boxes, valid = random_boxes(rng, 2, 12, 24, 32, 9)
    boxes = np.nan_to_num(boxes)  # the reference's int cast of NaN is undefined
    ref = jh.prepare_centers(jnp.asarray(boxes), jnp.asarray(valid), (24, 32), 0.7)
    got = th.prepare_centers(_t(boxes), _t(valid), (24, 32), 0.7)
    names = ("cx", "cy", "bw", "bh", "valid", "ix", "iy", "radius", "sigma")
    for name, g, r in zip(names, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=name)
    assert got[5].dtype == got[6].dtype == torch.int32
    assert 0 < int(got[4].sum()) < int(valid.sum())  # some dropped, some kept


def _unique_centre_mask(t):
    """(B, Hs*Ws) True at pixels that at most one valid object centres on."""
    B = t.valid.shape[0]
    hs_ws = t.mask[0].numel()
    counts = np.zeros((B, hs_ws), int)
    for b in range(B):
        np.add.at(counts[b], t.indices[b][t.valid[b]].numpy(), 1)
    return counts <= 1


@pytest.mark.parametrize("seed,B,K,hs,ws,C", [(2, 2, 12, 24, 32, 4), (3, 3, 20, 16, 16, 2)])
def test_render_targets_batch_matches_reference(seed, B, K, hs, ws, C):
    rng = np.random.default_rng(seed)
    boxes, valid = random_boxes(rng, B, K, hs, ws, K - 3)
    classes = rng.integers(0, C, (B, K)).astype(np.int32)
    ref = jh.render_centernet_targets_batch(jnp.asarray(np.nan_to_num(boxes)),
                                            jnp.asarray(classes), jnp.asarray(valid),
                                            (hs, ws), C)
    got = th.render_centernet_targets_batch(_t(boxes), _t(classes), _t(valid), (hs, ws), C)
    np.testing.assert_allclose(got.heatmap.numpy(), np.asarray(ref.heatmap), atol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    keep = _unique_centre_mask(got).reshape(B, hs, ws)
    np.testing.assert_allclose(got.offset.numpy()[keep], np.asarray(ref.offset)[keep], atol=1e-6)
    np.testing.assert_allclose(got.size.numpy()[keep], np.asarray(ref.size)[keep], atol=1e-6)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert float(got.heatmap.max()) == 1.0


def test_render_targets_golden():
    t = th.render_centernet_targets(_t(_G["gt_boxes"]), _t(_G["gt_classes"]),
                                    _t(_G["gt_valid"]), (48, 64), 3)
    np.testing.assert_allclose(t.heatmap.numpy(), _G["heatmap"], atol=1e-6)
    np.testing.assert_allclose(t.offset.numpy(), _G["offset"], atol=1e-6)
    np.testing.assert_allclose(t.size.numpy(), _G["size"], atol=1e-6)
    np.testing.assert_array_equal(t.mask.numpy(), _G["mask"])


def _centres(boxes, valid, map_hw):
    _, _, _, _, v, ix, iy, radius, sigma = th.prepare_centers(_t(boxes), _t(valid), map_hw, 0.7)
    return iy, ix, sigma, radius, v


def test_plain_splat_matches_pallas_interpret_and_drops_class_c():
    rng = np.random.default_rng(4)
    B, K, C, hs, ws = 2, 12, 4, 32, 48
    boxes, valid = random_boxes(rng, B, K, hs, ws, 8)
    boxes = np.nan_to_num(boxes)
    classes = rng.integers(0, C, (B, K)).astype(np.int32)
    classes[:, 1] = C                       # out of range: must be dropped
    iy, ix, sigma, radius, v = _centres(boxes, valid, (hs, ws))
    assert bool(v[:, 1].any())              # the class-C objects are otherwise valid
    got = render_heatmap(iy, ix, sigma, radius, _t(classes), v, (hs, ws), C)
    # The Pallas kernel has no bound check (it would index channel C), so it
    # gets the class-C objects marked invalid; the port must drop them itself.
    jvalid = valid.copy()
    jvalid[:, 1] = False
    want = render_heatmap_pallas(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(jvalid),
                                 (hs, ws), C, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.shape == (B, hs, ws, C) and got.dtype == torch.float32
    assert render_heatmap.launches == 0     # CPU tensors never reach the kernel


def test_plain_splat_edge_cases():
    hs, ws, C = 16, 16, 3
    # no valid object -> zeros
    z = torch.zeros(1, 4, dtype=torch.int32)
    out = render_heatmap_reference(z, z, torch.ones(1, 4), torch.ones(1, 4), z,
                                   torch.zeros(1, 4, dtype=torch.bool), (hs, ws), C)
    assert float(out.abs().sum()) == 0.0
    # radius 0: a single 1.0 at the centre; border centre: clipped window
    iy = torch.tensor([[0, 15, 7]], dtype=torch.int32)
    ix = torch.tensor([[0, 15, 7]], dtype=torch.int32)
    radius = torch.tensor([[3.0, 2.0, 0.0]])
    sigma = (2 * radius + 1) / 6
    cls = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    out = render_heatmap_reference(iy, ix, sigma, radius, cls, torch.ones(1, 3, dtype=torch.bool),
                                   (hs, ws), C)[0]
    assert float(out[7, 7, 2]) == 1.0 and int((out[..., 2] > 0).sum()) == 1
    assert int((out[..., 0] > 0).sum()) == 16 and float(out[0, 0, 0]) == 1.0
    assert int((out[..., 1] > 0).sum()) == 9 and float(out[15, 15, 1]) == 1.0
    # two overlapping same-class objects: the per-pixel max of the two
    iy2, ix2 = torch.tensor([[5, 7]], dtype=torch.int32), torch.tensor([[5, 6]], dtype=torch.int32)
    r2 = torch.tensor([[3.0, 3.0]])
    cls2 = torch.zeros(1, 2, dtype=torch.int32)
    both = render_heatmap_reference(iy2, ix2, (2 * r2 + 1) / 6, r2, cls2,
                                    torch.ones(1, 2, dtype=torch.bool), (hs, ws), 1)
    each = [render_heatmap_reference(iy2[:, i:i + 1], ix2[:, i:i + 1], (2 * r2[:, i:i + 1] + 1) / 6,
                                     r2[:, i:i + 1], cls2[:, :1], torch.ones(1, 1, dtype=torch.bool),
                                     (hs, ws), 1) for i in range(2)]
    torch.testing.assert_close(both, torch.maximum(*each), rtol=0, atol=0)


def test_splat_wrapper_checks_dtypes():
    z = torch.zeros(1, 2, dtype=torch.int32)
    f = torch.ones(1, 2)
    ok = torch.ones(1, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="classes"):
        render_heatmap(z, z, f, f, z.long(), ok, (8, 8), 2)
    with pytest.raises(ValueError, match="sigma"):
        render_heatmap(z, z, f.double(), f, z, ok, (8, 8), 2)


def test_render_with_the_wrapper_equals_plain_on_cpu():
    rng = np.random.default_rng(5)
    boxes, valid = random_boxes(rng, 2, 10, 20, 24, 8)
    classes = rng.integers(0, 3, (2, 10)).astype(np.int32)
    a = th.render_centernet_targets_batch(_t(boxes), _t(classes), _t(valid), (20, 24), 3)
    b = th.render_centernet_targets_batch(_t(boxes), _t(classes), _t(valid), (20, 24), 3,
                                          splat=render_heatmap)
    for x, y in zip(a[:6], b[:6]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
