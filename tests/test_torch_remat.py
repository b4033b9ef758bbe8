"""Gradient checkpointing (``remat``, ``models/backbones.py``) held as the
reference's ``tests/test_remat.py`` holds it, on the CPU with tiny models:
with and without ``remat`` the same parameters (names and values), the same
outputs, loss and gradients bit for bit (the recompute repeats the same
float32 / bf16 arithmetic on the same inputs), the same BatchNorm running
statistics after a training forward (the recompute's updates are put
back), also under QAT's fake-quant; and the checkpointed backward really
recomputes: each residual block runs its forward again during backward.
"""

import pytest
import torch

from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.layers import ResBlock
from cvm_tpu_torch.models.registry import build_model
from cvm_tpu_torch.train.qat import maybe_fake_quant

CFGS = {
    "centernet": dict(input_hw=(64, 64), num_classes=3, max_objects=8, backbone="tiny",
                      neck_features=32, head_features=16, batch_size=2),
    "semseg": dict(input_hw=(64, 64), backbone="tiny", decoder_features=16, batch_size=2),
    "depth": dict(input_hw=(64, 64), backbone="tiny", decoder_features=16, batch_size=2),
    "multitask": dict(input_hw=(64, 64), backbone="tiny", neck_features=32,
                      head_features=16, batch_size=2, num_det_classes=3),
}


def _model(name, **extra):
    spec = get_model(name)
    cfg = spec.params_cls(**CFGS[name], **extra)
    return build_model(spec, cfg, "cpu", torch.Generator().manual_seed(0)).train(), cfg


def _loss_and_grads(model, cfg, x):
    with maybe_fake_quant(cfg):
        out = model(x)
    loss = sum((o.float() ** 2).sum() for o in out.values() if torch.is_tensor(o))
    # allow_unused: a depth net's coarse disp heads feed no loss (zero
    # gradient in training, as in the reference)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return out, loss, [torch.zeros_like(p) if g is None else g
                       for p, g in zip(model.parameters(), grads)]


@pytest.mark.parametrize("name,qat", [("centernet", False), ("semseg", False),
                                      ("depth", False), ("multitask", False),
                                      ("centernet", True)])
def test_remat_identical_params_outputs_grads(name, qat):
    m0, c0 = _model(name, qat=qat)
    m1, c1 = _model(name, qat=qat, remat=True)
    assert m1.backbone.remat and not m0.backbone.remat
    s0, s1 = m0.state_dict(), m1.state_dict()
    assert list(s0) == list(s1) and all(torch.equal(s0[k], s1[k]) for k in s0)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    o0, l0, g0 = _loss_and_grads(m0, c0, x)
    o1, l1, g1 = _loss_and_grads(m1, c1, x)
    for k in o0:
        if torch.is_tensor(o0[k]):
            assert torch.equal(o0[k], o1[k]), k
    assert torch.equal(l0, l1)
    for (n, _), a, b in zip(m0.named_parameters(), g0, g1):
        assert torch.equal(a, b), n
    for (n, a), b in zip(m0.named_buffers(), m1.buffers()):
        assert torch.equal(a, b), n  # running statistics moved once, not twice
    # eval mode and no-grad forwards take the plain path
    m1.eval()
    with torch.no_grad():
        assert torch.equal(m1(x)[next(iter(o1))], m0.eval()(x)[next(iter(o0))])


def test_remat_recomputes_each_block_in_backward():
    counts = {}

    def run(remat):
        m, cfg = _model("centernet", remat=remat)
        n = [0]
        for mod in m.modules():
            if isinstance(mod, ResBlock):
                # a pre-hook: the recompute stops early, once it has what the
                # backward needs, before a forward hook would run
                mod.register_forward_pre_hook(lambda *a: n.__setitem__(0, n[0] + 1))
        x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
        out = m(x)
        forward = n[0]
        sum((o.float() ** 2).sum() for o in out.values()).backward()
        counts[remat] = (forward, n[0] - forward)

    run(False)
    run(True)
    blocks = 6  # the tiny backbone's (1, 1, 2, 2) residual blocks
    assert counts[False] == (blocks, 0)
    assert counts[True] == (blocks, blocks)


def test_trainer_steps_equal_with_remat(tmp_path):
    from cvm_tpu_torch.data.synthetic import SyntheticIterator
    from cvm_tpu_torch.train.loop import Trainer

    losses = {}
    for remat in (False, True):
        cfg = get_model("centernet").params_cls(**CFGS["centernet"], remat=remat,
                                                warmup_steps=1)
        tr = Trainer(cfg, "cpu", log_every=1)
        tr.init_state()
        m = tr.fit(SyntheticIterator(0, 2, (96, 96), num_classes=3), 3)
        losses[remat] = (m["loss"], m["grad_norm"])
    assert losses[True] == losses[False]
