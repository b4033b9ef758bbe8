"""The port's package surface against the reference's (``cvm_tpu/__init__.py``,
``cvm_tpu/models/__init__.py``, ``cvm_tpu/ops/__init__.py``), on the CPU.

``get_model`` / ``create_model`` at the package level, ``register_model``,
the ``ops`` package's names (every one of the reference's but the TPU-only
``bilinear_sample_mxu``), ``letterbox`` within 1e-4 and
``normalize_imagenet`` within 1e-5 of the reference on the same seeded
inputs (float32 on both sides), and the new entry points' default device:
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvm_tpu
import cvm_tpu.ops as jops
import cvm_tpu_torch
import cvm_tpu_torch.ops as tops
from cvm_tpu_torch.models import ModelSpec, get_model, get_model_zoo, register_model
from cvm_tpu_torch.models import registry


def test_package_get_and_create_model():
    spec = cvm_tpu_torch.get_model("semseg")
    assert spec.name == "semseg" == cvm_tpu.get_model("semseg").name
    model, cfg = cvm_tpu_torch.create_model("semseg", device="cpu", input_hw=(32, 32),
                                            backbone="tiny", decoder_features=8)
    assert cfg.input_hw == (32, 32) and not model.training
    with torch.no_grad():
        assert model(torch.zeros(1, 32, 32, 3))["logits"].shape == (1, 32, 32, cfg.num_classes)
    again, same = cvm_tpu_torch.create_model("semseg", params=cfg, device="cpu")
    assert same is cfg and torch.equal(next(again.parameters()), next(model.parameters()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cvm_tpu_torch.create_model("semseg", input_hw=(32, 32), backbone="tiny")


def test_register_model():
    base = get_model("depth")
    spec = ModelSpec("depth_copy", base.params_cls, base.create_model, base.loss_fn,
                     base.make_processor)
    register_model("depth_copy", lambda: spec)
    try:
        assert "depth_copy" in get_model_zoo() and cvm_tpu_torch.get_model("depth_copy") is spec
    finally:
        del registry._REGISTRY["depth_copy"]
    assert get_model_zoo() == sorted(cvm_tpu.models.get_model_zoo())
    with pytest.raises(KeyError, match="unknown model"):
        get_model("depth_copy")


def test_ops_names_are_the_references():
    want = {n for n in vars(jops) if not n.startswith("_") and callable(getattr(jops, n))}
    got = {n for n in vars(tops) if not n.startswith("_") and callable(getattr(tops, n))}
    assert want - got == {"bilinear_sample_mxu"}


def test_letterbox_and_normalize_imagenet_match_reference():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    hw = np.array([[40, 56], [31, 23]], np.int32)
    got, roi = tops.letterbox(torch.from_numpy(img), torch.from_numpy(hw[:, 0]),
                              torch.from_numpy(hw[:, 1]), (32, 48), pad_value=7.0)
    for b in range(2):
        want, wroi = jops.letterbox(jnp.asarray(img[b]), hw[b, 0], hw[b, 1], (32, 48),
                                    pad_value=7.0)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=1e-4, rtol=0)
        np.testing.assert_allclose([float(f[b]) for f in roi], [float(f) for f in wroi],
                                   rtol=1e-6)
    x = rng.uniform(0, 255, (3, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tops.normalize_imagenet(torch.from_numpy(x)).numpy(),
                               np.asarray(jops.normalize_imagenet(jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def test_new_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a card")
    from cvm_tpu_torch.cli import lr_find, video

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lr_find.main(["--model", "centernet", "--num_steps", "4"])
    from test_torch_video import write_clip

    (tmp_path / "ck").mkdir()
    (tmp_path / "ck" / "params.json").write_text("{}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        video.main(["--model", "centernet", "--checkpoint_dir", str(tmp_path / "ck"),
                    "--video", write_clip(tmp_path / "c.mp4", n=2), "--jsonl", "x"])
