"""cvm_tpu_torch.models.centernet.loss against the reference: values and
gradients (``torch.autograd`` vs ``jax.grad``) on the same numpy inputs.

Float32 on both sides with sums in different orders: values agree to 1e-5
relative, gradients to 1e-5 of the largest gradient element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.models.centernet import loss as jl
from cvm_tpu.models.centernet.params import CenternetParams as JParams
from cvm_tpu.ops.heatmap import CenternetTargets as JTargets
from cvm_tpu_torch.models.centernet import loss as tl
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops.heatmap import CenternetTargets


def case(seed, B=2, H=16, W=16, C=3, with_peaks=True):
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 0.9, (B, H, W, C)).astype(np.float32) ** 3
    mask = np.zeros((B, H, W), np.float32)
    if with_peaks:
        for b in range(B):
            for _ in range(4):
                y, x, c = rng.integers(0, H), rng.integers(0, W), rng.integers(0, C)
                hm[b, y, x, c] = 1.0
                mask[b, y, x] = 1.0
    outputs = {"heatmap": rng.normal(-2, 2, (B, H, W, C)).astype(np.float32),
               "offset": rng.normal(0, 1, (B, H, W, 2)).astype(np.float32),
               "size": rng.normal(5, 3, (B, H, W, 2)).astype(np.float32)}
    targets = dict(heatmap=hm, offset=rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32),
                   size=rng.uniform(0, 20, (B, H, W, 2)).astype(np.float32), mask=mask,
                   indices=np.zeros((B, 4), np.int32), valid=np.ones((B, 4), bool))
    return outputs, targets


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=rel)


@pytest.mark.parametrize("alpha,beta", [(2.0, 4.0), (1.5, 3.0)])
@pytest.mark.parametrize("with_peaks", [True, False])
def test_focal_loss_value_and_grad(alpha, beta, with_peaks):
    outputs, targets = case(1, with_peaks=with_peaks)
    x, t = outputs["heatmap"], targets["heatmap"]
    jv, jg = jax.value_and_grad(lambda z: jl.penalty_reduced_focal_loss(z, t, alpha, beta))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tv = tl.penalty_reduced_focal_loss(xt, torch.from_numpy(t), alpha, beta)
    (tg,) = torch.autograd.grad(tv, xt)
    _close(tv.detach().numpy(), jv)
    _close(tg.numpy(), jg)


def test_masked_l1_value_and_grad_and_empty_mask():
    outputs, targets = case(2)
    p, t, m = outputs["offset"], targets["offset"], targets["mask"]
    jv, jg = jax.value_and_grad(lambda z: jl.masked_l1_loss(z, t, m))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    tv = tl.masked_l1_loss(pt, torch.from_numpy(t), torch.from_numpy(m))
    (tg,) = torch.autograd.grad(tv, pt)
    _close(tv.detach().numpy(), jv)
    _close(tg.numpy(), jg)
    zero = tl.masked_l1_loss(pt, torch.from_numpy(t), torch.zeros_like(torch.from_numpy(m)))
    assert float(zero.detach()) == 0.0


def test_centernet_loss_value_metrics_and_grads():
    outputs, targets = case(3)
    kw = dict(weight_heatmap=1.0, weight_offset=0.7, weight_size=0.1, focal_alpha=2.0,
              focal_beta=4.0)
    jp, tp = JParams(**kw), CenternetParams(**kw)
    jt = JTargets(**{k: jnp.asarray(v) for k, v in targets.items()})
    tt = CenternetTargets(**{k: torch.from_numpy(v) for k, v in targets.items()})

    def jfn(out):
        return jl.centernet_loss(out, jt, jp)

    (jv, jm), jg = jax.value_and_grad(jfn, has_aux=True)({k: jnp.asarray(v)
                                                         for k, v in outputs.items()})
    tout = {k: torch.from_numpy(v).requires_grad_() for k, v in outputs.items()}
    tv, tm = tl.centernet_loss(tout, tt, tp)
    grads = torch.autograd.grad(tv, list(tout.values()))
    assert set(tm) == set(jm) == {"loss", "loss_hm", "loss_off", "loss_size"}
    for k in jm:
        _close(tm[k].detach().numpy(), jm[k])
    for k, g in zip(tout, grads):
        _close(g.numpy(), jg[k])


def test_centernet_loss_refuses_3d():
    """A ``with_3d`` config whose targets carry no 3D labels (no extras)
    adds no 3D terms: the 2D loss and metrics, as the reference's (the 3D
    terms are held in ``tests/test_torch_centernet3d.py``)."""
    outputs, targets = case(4)
    tt = CenternetTargets(**{k: torch.from_numpy(v) for k, v in targets.items()})
    jt = JTargets(**{k: jnp.asarray(v) for k, v in targets.items()})
    tv, tm = tl.centernet_loss({k: torch.from_numpy(v) for k, v in outputs.items()}, tt,
                               CenternetParams(with_3d=True))
    jv, jm = jl.centernet_loss({k: jnp.asarray(v) for k, v in outputs.items()}, jt,
                               JParams(with_3d=True))
    assert set(tm) == set(jm) == {"loss", "loss_hm", "loss_off", "loss_size"}
    _close(tv.numpy(), jv)
