"""DMDS's warp and SSIM (cvm_tpu_torch) against the reference, on the CPU.

* ``euler_to_matrix``, ``scale_intrinsics``, ``bilinear_sample`` (interior,
  integer, fractional and out-of-frame coordinates) and every output of
  ``warp_frame`` (with and without a residual translation field) against
  the reference's 4-tap gather (``method="gather"``): within 1e-5
  (absolute, plus 1e-5 relative: a point behind the camera projects
  thousands of pixels out, where float32's own step is 2.4e-4); the
  in-bounds flags exactly. The TPU's matrix-product sampler ``"mxu"`` is
  refused.
* ``ssim`` within 1e-6.
* The pose-recovery property of ``tests/test_dmds_learning.py`` in
  PyTorch: with depth held at the truth, ``torch.optim.Adam(lr=0.05)`` on
  the photometric loss over the translation, 300 steps, drives the loss
  below 5% of its start and the translation within 0.1 of the truth.
* The two-frame generator's motion is depth-consistent through the
  port's warp, with the reference test's margins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.ops import warp as jwarp
from cvm_tpu.ops.image import Roi as JRoi
from cvm_tpu.ops.ssim import ssim as j_ssim
from cvm_tpu_torch.data.synthetic import _bilinear_np, synthetic_batch
from cvm_tpu_torch.models.dmds.loss import photometric_loss
from cvm_tpu_torch.ops import warp as twarp
from cvm_tpu_torch.ops.image import Roi
from cvm_tpu_torch.ops.ssim import ssim

T = torch.from_numpy


def test_euler_to_matrix_matches_reference():
    a = np.random.default_rng(0).uniform(-0.7, 0.7, (5, 3)).astype(np.float32)
    got = twarp.euler_to_matrix(T(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jwarp.euler_to_matrix(jnp.asarray(a))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.tile(np.eye(3), (5, 1, 1)),
                               atol=1e-5)


def test_scale_intrinsics_matches_reference():
    rng = np.random.default_rng(1)
    k = rng.uniform(20, 300, (4, 4)).astype(np.float32)
    f = [rng.uniform(-20, 80, 4).astype(np.float32) for _ in range(8)]
    f[2], f[3], f[6], f[7] = (np.abs(x) + 10 for x in (f[2], f[3], f[6], f[7]))
    got = twarp.scale_intrinsics(T(k), Roi(*map(T, f), torch.zeros(4, dtype=torch.bool)))
    ref = jwarp.scale_intrinsics(jnp.asarray(k), JRoi(*map(jnp.asarray, f),
                                                      jnp.zeros(4, bool)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)


def test_bilinear_sample_matches_the_gather_oracle():
    rng = np.random.default_rng(2)
    B, H, W, C = 2, 24, 40, 3
    img = rng.uniform(0, 1, (B, H, W, C)).astype(np.float32)
    coords = rng.uniform(-5, np.array([W + 4, H + 4]), (B, 17, 9, 2)).astype(np.float32)
    coords[:, 0, :3] = np.round(coords[:, 0, :3])           # integer taps
    coords[:, 1, 0] = (W - 1, H - 1)                         # the far corner, in bounds
    coords[:, 1, 1] = (W - 1 + 1e-3, 0.0)                    # just past the edge
    out, inb = twarp.bilinear_sample(T(img), T(coords))
    for b in range(B):
        r_out, r_inb = jwarp.bilinear_sample(jnp.asarray(img[b]), jnp.asarray(coords[b]))
        np.testing.assert_allclose(out[b].numpy(), np.asarray(r_out), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(inb[b].numpy(), np.asarray(r_inb))
    assert 0 < float(inb.mean()) < 1


@pytest.mark.parametrize("residual", [False, True])
def test_warp_frame_matches_the_reference(residual):
    rng = np.random.default_rng(3 + residual)
    B, H, W = 2, 24, 40
    src = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(2, 30, (B, H, W, 1)).astype(np.float32)
    rot = rng.normal(0, 0.02, (B, 3)).astype(np.float32)
    trans = rng.normal(0, 0.3, (B, 3)).astype(np.float32)
    # The second frame's camera moves past the whole scene: every point
    # lands behind it (z clamped, the front mask 0). Depths near z = 0 are
    # avoided: there u = X fx / z amplifies any rounding without bound.
    trans[1, 2] = -40.0
    intr = np.array([[30.0, 32.0, 20.0, 12.0], [45.0, 40.0, 19.5, 11.0]], np.float32)
    res = rng.normal(0, 0.1, (B, H, W, 3)).astype(np.float32) if residual else None
    got = twarp.warp_frame(T(src), T(depth), T(rot), T(trans), T(intr),
                           None if res is None else T(res))
    ref = jwarp.warp_frame(jnp.asarray(src), jnp.asarray(depth), jnp.asarray(rot),
                           jnp.asarray(trans), jnp.asarray(intr),
                           None if res is None else jnp.asarray(res), method="gather")
    for name, g, r in zip(ref._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert 0 < float(got.valid[0].mean()) < 1 and float(got.valid[1].max()) == 0


def test_warp_refuses_the_tpu_sampler():
    z = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="mxu"):
        twarp.warp_frame(z, z + 1, torch.zeros(1, 3), torch.zeros(1, 3),
                         torch.ones(1, 4), method="mxu")


def test_ssim_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (2, 12, 17, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    b[0, :4] = a[0, :4]  # identical patches: SSIM 1, the map 0
    got = ssim(T(a), T(b)).numpy()
    assert got.shape == (2, 10, 15, 3)
    np.testing.assert_allclose(got, np.asarray(j_ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6, rtol=0)


def _textured(rng, H, W):
    """Smooth random texture (noise bilinearly upsampled) in [0, 1]."""
    base = rng.uniform(0, 255, (H // 4, W // 4, 3)).astype(np.uint8)
    yy, xx = np.meshgrid(np.linspace(0.0, H // 4 - 1.0, H, dtype=np.float32),
                         np.linspace(0.0, W // 4 - 1.0, W, dtype=np.float32), indexing="ij")
    return _bilinear_np(base, xx, yy).astype(np.float32) / 255.0


def test_pose_recovery_with_known_depth():
    torch.manual_seed(0)
    H, W, Z, fx, shift = 32, 64, 10.0, 32.0, 4
    t_true = torch.tensor([[shift * Z / fx, 0.0, 0.0]])
    # Two crops of one larger textured plane: an exact lateral camera
    # motion with no border-invalid strip, b(u) = a(u - shift).
    big = _textured(np.random.default_rng(0), H, W + 2 * shift)
    img_a, img_b = T(big[None, :, shift:shift + W].copy()), T(big[None, :, :W].copy())
    depth = torch.full((1, H, W, 1), Z)
    intr = torch.tensor([[fx, fx, W / 2.0, H / 2.0]])
    t = torch.zeros(1, 3, requires_grad=True)
    opt = torch.optim.Adam([t], lr=0.05)
    first = None
    for _ in range(300):
        w = twarp.warp_frame(img_b, depth, torch.zeros(1, 3), t, intr)
        loss = photometric_loss(img_a, w.warped, w.valid, alpha=0.5)
        first = float(loss.detach()) if first is None else first
        opt.zero_grad()
        loss.backward()
        opt.step()
    w = twarp.warp_frame(img_b, depth, torch.zeros(1, 3), t, intr)
    last = float(photometric_loss(img_a, w.warped, w.valid, alpha=0.5).detach())
    assert last < first * 0.05, (first, last)
    assert float((t.detach() - t_true).abs().max()) < 0.1, t


def test_synthetic_two_frame_motion_is_depth_consistent():
    """Warping frame t+1 back with the true ego-motion and depth through
    the port's warp beats no motion, the wrong-sign motion and the right
    motion on a vertically flipped depth map (the reference's margins)."""
    b = synthetic_batch(np.random.default_rng(7), 4, (64, 64), vary_sizes=False,
                        two_frame=True)
    img = T(b["image"]).float() / 255.0
    img2 = T(b["image_t1"]).float() / 255.0
    depth = T(b["depth"])[..., None]
    intr = T(b["intrinsics"])
    m = 6

    def mse(dep, t):
        w = twarp.warp_frame(img2, dep, torch.zeros(4, 3), t, intr, method="gather")
        return ((w.warped - img) ** 2)[:, m:-m, m:-m].mean(dim=(1, 2, 3)).numpy()

    t_gt = torch.cat([-T(b["ego_t"]), torch.zeros(4, 1)], -1)
    gt = mse(depth, t_gt)
    assert (mse(depth, torch.zeros(4, 3)) > 1.2 * gt).all()
    assert (mse(depth, -t_gt) > 2.0 * gt).all()
    assert (mse(torch.flip(depth, dims=(1,)), t_gt) > 1.1 * gt).all()
