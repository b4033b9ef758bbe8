"""Multi-process serving and spatial sharding on the card: two gloo ranks
(``tests/torch_dist_child.py``) sharing it, as ``chip_smoke.py`` phase 35
runs them.

These need the card and skip without one. The file imports no JAX, so it
runs on a machine that has none:
``python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py``.

* The halo exchange of ``parallel/spatial.py`` on CUDA tensors over gloo
  (which runs no ``send``/``recv`` on them): the slabs put together equal
  the unsharded conv, and the input's and weight's gradients its autograd
  (float32).
* ``InferencePipeline(mesh=)`` under ``w8a8_fused_chain`` over a data axis
  of 2: each rank launches K2 as often per call as one process does per
  forward (its rows only), and the outputs match one process's.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_child as child
from cvm_tpu_torch.cli.export import calibration_scales
from cvm_tpu_torch.models.registry import get_model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks' tensors live on it")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_halo_exchange_on_cuda_tensors_over_gloo(cuda_device, tmp_path):
    rng = np.random.default_rng(0)
    B, H, W, C, Co = 2, 32, 24, 16, 8
    x, g = (rng.normal(size=(B, H, W, c)).astype(np.float32) for c in (C, Co))
    w = rng.normal(size=(Co, C, 3, 3)).astype(np.float32)
    path = str(tmp_path / "in.npz")
    np.savez(path, x=x, w=w, g=g)
    ranks = child.launch(2, ["spatial", "--npz", path, "--model_parallel", 2],
                         str(tmp_path / "r"), device="cuda", timeout=300)
    xt = torch.tensor(x, device=cuda_device, requires_grad=True)
    wt = torch.tensor(w, device=cuda_device, requires_grad=True)
    y = F.conv2d(xt.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1)
    (y * torch.tensor(g, device=cuda_device)).sum().backward()
    got = {k: np.concatenate([a[k] for _, a in ranks], axis=1) for k in ("y", "dx")}
    np.testing.assert_allclose(got["y"], y.detach().cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(got["dx"], xt.grad.cpu().numpy(), atol=1e-4)
    for _, a in ranks:  # the weight's gradient, summed over the group
        np.testing.assert_allclose(a["dw"], wt.grad.cpu().numpy(), rtol=1e-5, atol=1e-3)


def test_k2_launches_per_rank_under_w8a8_fused(cuda_device, tmp_path):
    fields, pad, _ = child.CONFIGS["tiny"]["centernet"]
    spec = get_model("centernet")
    cfg = spec.params_cls(**fields, batch_size=4)
    model = spec.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    scales = calibration_scales(cfg, model, pad, 1, 4, cuda_device)
    rng = np.random.default_rng(0)
    ph, pw = pad
    batch = {"y": rng.integers(0, 255, (4, ph, pw), dtype=np.uint8),
             "u": rng.integers(0, 255, (4, ph // 2, pw // 2), dtype=np.uint8),
             "v": rng.integers(0, 255, (4, ph // 2, pw // 2), dtype=np.uint8),
             "image_hw": np.asarray([[ph, pw], [60, 80], [70, 90], [64, 64]], np.int32)}
    path = str(tmp_path / "in.npz")
    np.savez(path, name=json.dumps("centernet"), cfg=cfg.to_json(), scales=json.dumps(scales),
             opts=json.dumps(dict(input_format="yuv420", w8a8="scales", w8a8_fused=True,
                                  w8a8_chain=True)),
             **{f"sd/{k}": v.cpu().numpy() for k, v in model.state_dict().items()},
             **{f"b/{k}": v for k, v in batch.items()})
    ranks = child.launch(2, ["serve", "--npz", path], str(tmp_path / "r"), device="cuda",
                         timeout=300)
    one, want = child.run_serve(None, cuda_device, path)
    assert one["k2"] > 0 and [r["k2"] for r, _ in ranks] == [one["k2"]] * 2
    for _, got in ranks:
        assert got["boxes"].shape == want["boxes"].shape == (4, cfg.top_k, 4)
        np.testing.assert_allclose(np.sort(got["scores"], axis=1),
                                   np.sort(want["scores"], axis=1), atol=0.01)
