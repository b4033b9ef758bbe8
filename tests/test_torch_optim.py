"""cvm_tpu_torch.train.optim against optax (cvm_tpu.train.optim).

All four schedules are compared count by count; both optimizers, with
global-norm clipping engaged and with MultiSteps gradient accumulation, are
run for 10+ updates on the same numpy gradients. The schedules are float64
on the host in the port and float32 in optax (1e-5 relative: optax
rounds cos near pi in float32); the updates
are float32 on both sides with the same formulas, so parameters agree to
1e-5 relative after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvm_tpu.train.optim import make_optimizer as j_make_optimizer
from cvm_tpu.train.optim import make_schedule as j_make_schedule
from cvm_tpu_torch.train.optim import global_norm, make_optimizer, make_schedule

SHAPES = [(3, 3, 4, 8), (8,), (8,), (5, 2)]


@pytest.mark.parametrize("kind", ["warmup_cosine", "constant", "step", "poly"])
@pytest.mark.parametrize("warmup,total", [(5, 40), (0, 30), (50, 40)])
def test_schedule_matches_optax(kind, warmup, total):
    js = j_make_schedule(kind, 3e-3, total, warmup)
    ts = make_schedule(kind, 3e-3, total, warmup)
    for count in range(0, total + 10):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"count {count}")
    assert ts(0) == 0.0  # the first update of every warmup schedule has lr 0


def _grads(rng, scale):
    return [(rng.normal(0, 1, s) * scale).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("accum", [1, 3])
@pytest.mark.parametrize("schedule", ["warmup_cosine", "constant"])
def test_optimizer_matches_optax(optimizer, accum, schedule):
    rng = np.random.default_rng(len(optimizer) * 100 + len(schedule) * 10 + accum)
    params = [rng.normal(0, 1, s).astype(np.float32) for s in SHAPES]
    kw = dict(warmup_steps=3, weight_decay=0.05, clip_norm=2.0, grad_accum_steps=accum,
              lr_schedule=schedule, optimizer=optimizer)
    tx = j_make_optimizer(1e-2, 40, **kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = make_optimizer(tp, 1e-2, 40, **kw)
    applied = 0
    for i in range(12 * accum):
        # alternate gradients under and over the clip norm
        g = _grads(rng, 0.05 if i % 2 else 3.0)
        jp, jstate = update([jnp.asarray(x) for x in g], jstate, jp)
        applied += opt.step([torch.from_numpy(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}")
    assert applied == 12 and opt.count == 12
    assert not np.allclose(tp[0].numpy(), params[0])  # the parameters moved


def test_first_update_has_lr_zero_and_decay_is_scheduled():
    p = [torch.ones(4)]
    opt = make_optimizer(p, 1.0, 100, warmup_steps=10, weight_decay=0.5)
    opt.step([torch.ones(4)])
    torch.testing.assert_close(p[0], torch.ones(4), rtol=0, atol=0)  # lr(0) = 0, decay too
    opt.step([torch.zeros(4)])
    assert float(p[0][0]) < 1.0


def test_global_norm_and_clip_factor():
    g = [torch.full((4,), 3.0), torch.full((9,), 4.0 / 3.0)]
    assert abs(float(global_norm(g)) - float(optax.global_norm([np.asarray(x) for x in g]))) < 1e-5
    # clip: g * max/||g|| when ||g|| >= max (no epsilon): sgd with lr 1 shows it
    p = [torch.zeros(4), torch.zeros(9)]
    opt = make_optimizer(p, 1.0, 100, warmup_steps=1, weight_decay=0.0, clip_norm=1.0,
                         lr_schedule="constant", optimizer="sgd")
    opt.step(g)             # lr 0: fills the momentum trace only
    opt.step(g)
    norm = float(global_norm(g))
    want = -(1.0 / norm) * (g[0] * (1 + 0.9 + 0.81))  # g + 0.9 * (g + 0.9 g)
    torch.testing.assert_close(p[0], want, rtol=1e-6, atol=1e-6)


def test_state_dict_roundtrip_continues_identically():
    rng = np.random.default_rng(9)
    params = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for s in SHAPES]
    a_p = [p.clone() for p in params]
    a = make_optimizer(a_p, 1e-2, 40, warmup_steps=2, grad_accum_steps=2)
    gs = [[torch.from_numpy(x) for x in _grads(rng, 1.0)] for _ in range(9)]
    for g in gs[:5]:
        a.step(g)
    b_p = [p.clone() for p in a_p]
    b = make_optimizer(b_p, 1e-2, 40, warmup_steps=2, grad_accum_steps=2)
    b.load_state_dict(a.state_dict())
    for g in gs[5:]:
        a.step(g)
        b.step(g)
    for x, y in zip(a_p, b_p):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="lr_schedule"):
        make_schedule("exp", 1.0, 10, 1)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer([torch.zeros(1)], 1.0, 10, optimizer="lamb")
