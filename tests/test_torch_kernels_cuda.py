"""Hand-written CUDA kernels of cvm_tpu_torch against their plain versions.

These need the card: a CUDA kernel has no CPU mode, so on a machine without
one each test skips with a reason. The file imports no JAX, so it also runs
on a machine that has none:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from cvm_tpu_torch.ops.cuda.fused_qconv import fused_qconv, fused_qconv_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_kernel_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    """Tolerance by output type. f32: the int32 sums are exact in both, only
    the f32 epilogue rounds (FMA vs mul+add). bf16: one bf16 step (2^-7
    relative) from that f32 difference crossing a rounding boundary. int8:
    the requant may move by one lattice step at a boundary, on at most 0.1%
    of the outputs."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs()
        assert int(d.max()) <= 1
        assert float((d > 0).float().mean()) <= 1e-3
    elif got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7, atol=1e-5)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


# (k, B, H, W, Cin, Cout, act): the shapes of tests/test_fused_qconv.py plus
# a Cin not a multiple of the 32-wide chunk and a ragged Cout.
SHAPES = [
    (1, 2, 8, 16, 32, 64, "silu"),
    (3, 2, 16, 20, 32, 64, "silu"),
    (3, 1, 32, 48, 16, 256, None),
    (3, 1, 8, 96, 8, 32, "relu"),
    (3, 2, 2, 1, 16, 32, "relu"),
    (3, 2, 9, 13, 12, 24, "silu"),
    (1, 1, 5, 7, 40, 72, None),
]
MODES = ["f32_out", "bf16_out", "int8_in", "int8_out", "bf16_in"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_qconv_kernel_matches_plain(cuda_device, shape, mode):
    k, B, H, W, cin, cout, act = shape
    rng = np.random.default_rng(k * 1000 + cout + cin)
    dev = cuda_device
    if mode == "int8_in":
        x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
        inv_sx = None
    else:
        x = torch.from_numpy(rng.normal(0, 1, (B, H, W, cin)).astype(np.float32))
        if mode == "bf16_in":
            x = x.to(torch.bfloat16)
        inv_sx = 1.0 / 0.021
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 2, (cout,)) * 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, (cout,)).astype(np.float32))
    out_dtype = {"bf16_out": torch.bfloat16, "int8_out": torch.int8}.get(mode, torch.float32)
    args = [t.to(dev) for t in (x, wq, scale, bias)]
    inv_s_out = None
    if mode == "int8_out":  # a consumer lattice that spans the output range
        y = fused_qconv_reference(*args, inv_sx=inv_sx, act=act, out_dtype=torch.float32)
        inv_s_out = 127.0 / float(y.abs().max())
    kw = dict(inv_sx=inv_sx, act=act, out_dtype=out_dtype, inv_s_out=inv_s_out)
    n0 = fused_qconv.launches
    got = fused_qconv(*args, **kw)
    torch.cuda.synchronize()
    assert fused_qconv.launches == n0 + 1
    ref = fused_qconv_reference(*args, **kw)
    assert_kernel_close(got, ref)
