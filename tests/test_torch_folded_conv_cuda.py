"""The folded conv's epilogue kernel (``csrc/conv_epilogue.cu``) on the card:
``conv_epilogue`` equals PyTorch's eager ops on the same CUDA tensors (the
plain version, ``conv_epilogue_reference``) bit for bit in every mode (bias;
bias and activation; bias, residual and activation; float32 out) at every
shape the benchmark's two fp cells run (recorded from one forward of each
cell's model) and at widths that are not a multiple of 8 or not aligned to
16 bytes; a ``fold_bn`` pipeline of each cell's configuration serves the
same outputs as the same weights folded the old way (``BiasAdd``, a cast of
each weight and bias per call), eagerly and replayed; and a replay counts
as many ``conv_epilogue`` launches as its capture did, one per folded conv
(31 for config B, 29 for semseg A).

These need the card (a CUDA kernel has no CPU mode): on a machine without
one each test skips with a reason. The file imports no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_folded_conv_cuda.py``.
"""

import json
from pathlib import Path

import pytest
import torch

from cvm_tpu_torch.infer import fold_bn
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.ops.cuda import conv_epilogue as ce

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CELLS = {"centernet_b": ("closed_loop_coco_b8", 31), "semseg_a": ("closed_loop_camera", 29)}
MODES = [(act, residual, out) for act in (None, "silu", "relu") for residual in (False, True)
         for out in (torch.bfloat16, torch.float32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the epilogue kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cell(name, dev, seed=2147490011):
    """The cell's program: its configuration and traffic mix, seeded weights,
    and one batch of its frames (``cvbench``, which imports no JAX)."""
    from cvbench import program
    from cvbench.runners.closed_loop_batches import stack
    from cvbench.traffic.generator import frame_pool, stream

    mix_name, _ = CELLS[name]
    with open(ROOT / "cvbench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    with open(ROOT / "cvbench" / "traffic" / f"{mix_name}.json") as f:
        mix = json.load(f)
    cfg = program.cell_config(cfg, mix)
    params, model, _ = program.build(cfg, seed, dev)
    n = int(cfg["params"]["batch_size"])
    pool = frame_pool(stream(seed, 1), dict(mix, pool=2 * n), cfg["params"]["num_classes"])
    return params, model, stack(pool, n)


def _pipelines(params, model, dev, monkeypatch):
    new = InferencePipeline(params, model, dev, input_format="yuv420", fold_bn=True)
    with monkeypatch.context() as m:
        m.setattr(fold_bn, "swap_folded", lambda model: None)
        old = InferencePipeline(params, model, dev, input_format="yuv420", fold_bn=True)
    assert old.folded_counts is None
    return new, old


def _data(pipe, batch):
    return [torch.from_numpy(batch[k]).to(pipe.device) for k in pipe.keys]


def _eager(pipe, data):
    with torch.no_grad():
        return {k: v.clone() for k, v in pipe.run(*data).items()}


def assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _recorded_shapes(pipe, data, monkeypatch):
    """(rows, C) of every conv_epilogue call of one forward, in call order."""
    shapes = []
    real = fold_bn.conv_epilogue

    def record(y, bias, residual=None, **kw):
        shapes.append((y.numel() // y.shape[-1], y.shape[-1]))
        return real(y, bias, residual, **kw)

    with monkeypatch.context() as m:
        m.setattr(fold_bn, "conv_epilogue", record)
        pipe.run(*data)
    return shapes


def _case(rows, C, act, residual, out, dev, g, offset=0):
    y = 3 * torch.randn(rows * C + offset, generator=g, device=dev)
    special = torch.tensor([0.0, -0.0, 1e-30, -88.0, 88.0, 3e38, float("inf"), float("nan")])
    n = min(len(special), rows * C)
    y[offset:offset + n] = special[:n].to(dev)
    y = y.to(torch.bfloat16)[offset:].view(rows, C)  # offset 3: 6 bytes off 16-byte alignment
    bias = torch.randn(C, generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn(rows, C, generator=g, device=dev).to(torch.bfloat16) if residual else None
    got = ce.conv_epilogue(y, bias, res, act=act, out_dtype=out)
    want = ce.conv_epilogue_reference(y, bias, res, act, out)
    assert got.dtype == want.dtype == out
    bad = got.view(-1) != want.view(-1)
    bad &= ~(torch.isnan(got.view(-1)) & torch.isnan(want.view(-1)))
    assert not bool(bad.any()), (rows, C, act, residual, out, int(bad.sum()))


@pytest.mark.parametrize("cell", list(CELLS))
def test_kernel_equals_the_plain_version_at_the_cells_shapes(cuda_device, cell, monkeypatch):
    params, model, batches = _cell(cell, cuda_device)
    pipe = InferencePipeline(params, model, cuda_device, input_format="yuv420", fold_bn=True)
    shapes = _recorded_shapes(pipe, _data(pipe, batches[0]), monkeypatch)
    assert len(shapes) == CELLS[cell][1]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for rows, C in sorted(set(shapes)):
        for act, residual, out in MODES:
            _case(rows, C, act, residual, out, cuda_device, g)


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 80, 1024])
def test_kernel_equals_the_plain_version_at_other_widths(cuda_device, C):
    g = torch.Generator(device=cuda_device).manual_seed(C)
    for rows in (1, 7, 1031):
        for act, residual, out in MODES:
            _case(rows, C, act, residual, out, cuda_device, g)
            _case(rows, C, act, residual, out, cuda_device, g, offset=3)  # unaligned: VEC 1


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    y = torch.zeros((4, 9000), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="wider"):
        ce.conv_epilogue(y, torch.zeros(9000, dtype=torch.bfloat16, device=cuda_device))
    with pytest.raises(ValueError, match="different devices"):
        ce.conv_epilogue(y[:, :8], torch.zeros(8, dtype=torch.bfloat16))


@pytest.mark.parametrize("cell", list(CELLS))
def test_fold_bn_pipeline_equals_the_old_fold_and_counts_its_launches(cuda_device, cell,
                                                                     monkeypatch):
    params, model, batches = _cell(cell, cuda_device)
    new, old = _pipelines(params, model, cuda_device, monkeypatch)
    folded = CELLS[cell][1]
    assert new.folded_counts == {"fused": folded, "kept": 0}
    for batch in batches + batches:  # eager, capture, then replays
        data = _data(new, batch)
        want = _eager(old, data)
        assert_equal(_eager(new, data), want)
        n0 = ce.conv_epilogue.launches
        assert_equal(new.predict(*data), want)
        assert ce.conv_epilogue.launches - n0 == folded
    c = new.graph_counts
    assert (c["first_sighting"], c["captures"]) == (1, 1) and c["replays"] == 2 * len(batches) - 1
