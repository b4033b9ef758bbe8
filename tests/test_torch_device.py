"""The port's explicit-device rule: work asked for on the card never runs on
the CPU by accident, and a tensor the kernel wrapper cannot launch on raises.

Without a card every CUDA request must raise; with one it must resolve.
"""

import pytest
import torch

from cvm_tpu_torch.entry import entry
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops.cuda.fused_qconv import fused_qconv
from cvm_tpu_torch.utils.device import resolve_device

TINY = dict(input_hw=(32, 32), num_classes=3, backbone="tiny", neck_features=16,
            head_features=8)


def test_resolve_device_cpu_and_refusals():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="required"):
        resolve_device(None)
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cuda:64"])
def test_resolve_device_cuda(device):
    dev = torch.device(device)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n and (dev.index is None or dev.index < n):
        assert resolve_device(device) == dev
    else:
        with pytest.raises(RuntimeError, match="requested"):
            resolve_device(device)


def test_card_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    p = CenternetParams(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(p, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferencePipeline(p, create_model(p, "cpu"), "cuda", fold_bn=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry("cuda")


def test_fused_qconv_refuses_a_device_without_a_kernel():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    w = torch.zeros(3, 3, 8, 16, dtype=torch.int8, device="meta")
    s = torch.ones(16, device="meta")
    n0 = fused_qconv.launches
    with pytest.raises(ValueError, match="no kernel"):
        fused_qconv(x, w, s, s, inv_sx=1.0)
    assert fused_qconv.launches == n0
