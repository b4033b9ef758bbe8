"""The BN-folded conv as it serves (``infer/fold_bn.py::swap_folded``) on the
CPU, where ``conv_epilogue`` runs its plain version: across the zoo (tiny
semseg, CenterNet 2D and 3D, depth, multitask, DMDS) the served forward
with the folded modules equals the ``BiasAdd`` fold's bit for bit on the
same weights, and so does an ``InferencePipeline``'s; a
``SpatialConv3x3`` and the tensor-parallel ``ColumnConv`` / ``RowConv``
keep their modules, and ``folded_counts`` counts both kinds; the plain
version equals PyTorch's eager ops in every mode; a folded model's bf16
tensors go through ``weights.npz`` and back (as bits, or with
``--quantize int8`` as the float32 folds quantized, which the ``BiasAdd``
fold's export served); training and the other postures build no folded
module. The kernel on the card: ``tests/test_torch_folded_conv_cuda.py``.
"""

import copy
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvm_tpu_torch.infer.fold_bn import FoldedConv, fold_batchnorm, swap_folded
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.layers import Conv, SpatialConv3x3, bind_spatial_mesh
from cvm_tpu_torch.models.registry import build_model
from cvm_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue, conv_epilogue_reference

HW = (64, 128)
TINY = {
    "semseg": ("semseg", dict(decoder_features=16)),
    "centernet": ("centernet", dict(neck_features=32, head_features=16, num_classes=3)),
    "centernet_3d": ("centernet", dict(neck_features=32, head_features=16, num_classes=3,
                                       with_3d=True)),
    "depth": ("depth", dict(decoder_features=16)),
    "multitask": ("multitask", dict(neck_features=32, head_features=16, num_det_classes=3)),
    "dmds": ("dmds", dict(decoder_features=16, motion_features=32)),
}


def _convs(model):
    """The model's convs: every one of them folds, as the zoo builds them."""
    return sum(isinstance(m, (Conv, SpatialConv3x3)) for m in model.modules())


def _model(case, mesh=None, **extra):
    name, fields = TINY[case]
    spec = get_model(name)
    cfg = spec.params_cls(input_hw=HW, backbone="tiny", batch_size=2, **fields, **extra)
    model = build_model(spec, cfg, "cpu", torch.Generator().manual_seed(0), mesh=mesh)
    g = torch.Generator().manual_seed(1)  # BatchNorms away from the identity
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return cfg, model.eval()


def _input(case):
    ch = 6 if case == "dmds" else 3
    g = torch.Generator().manual_seed(2)
    return torch.randn((2, *HW, ch), generator=g).to(torch.bfloat16)


def assert_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal(g, w)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", list(TINY))
def test_folded_forward_equals_the_biasadd_fold(case):
    _, model = _model(case)
    folded = fold_batchnorm(model)
    served = copy.deepcopy(folded)
    assert swap_folded(served) == {"fused": _convs(model), "kept": 0}
    x = _input(case)
    with torch.no_grad():
        assert_equal(served(x), folded(x))
    for m in served.modules():
        if isinstance(m, FoldedConv):  # prepared once: bf16, no float32 copy
            assert m.weight.dtype == m.bias.dtype == torch.bfloat16
            assert m.weight.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    assert not any(p.dtype == torch.float32 and p.dim() == 4 for p in served.state_dict().values())


def _frames(pipe, rng):
    n, (h, w) = pipe.cfg.batch_size, (HW[0] + 16, HW[1] + 32)
    return {"y": rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            "u": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            "v": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            "image_hw": np.array([[h, w], [h - 16, w - 32]], np.int32)}


@pytest.mark.parametrize("case", ["semseg", "centernet"])
def test_fold_bn_pipeline_serves_the_biasadd_folds_outputs(case, monkeypatch):
    cfg, model = _model(case)
    pipe = InferencePipeline(cfg, model, "cpu", input_format="yuv420", fold_bn=True)
    assert pipe.folded_counts == {"fused": _convs(model), "kept": 0}
    from cvm_tpu_torch.infer import fold_bn

    monkeypatch.setattr(fold_bn, "swap_folded", lambda m: None)
    old = InferencePipeline(cfg, model, "cpu", input_format="yuv420", fold_bn=True)
    assert not any(isinstance(m, FoldedConv) for m in old.model.modules())
    batch = _frames(pipe, np.random.default_rng(0))
    assert_equal(pipe(batch), old(batch))


def test_spatial_and_tensor_parallel_convs_keep_their_modules():
    # semseg's spatial head: its c1 a SpatialConv3x3 (mesh of one rank: the plain conv)
    _, model = _model("semseg", mesh=types.SimpleNamespace(model=1), spatial_shard=True)
    bind_spatial_mesh(model, None)
    folded = fold_batchnorm(model)
    served = copy.deepcopy(folded)
    assert swap_folded(served) == {"fused": _convs(model) - 2, "kept": 2}
    assert isinstance(served.seg.c1.conv, SpatialConv3x3) and type(served.seg.out) is Conv
    x = _input("semseg")
    with torch.no_grad():
        assert_equal(served(x), folded(x))

    # stage 5's tensor-parallel convs: each s5 ResBlock keeps its module
    from cvm_tpu_torch.models.layers import ResBlock
    from cvm_tpu_torch.parallel.sharding import ColumnConv, RowConv

    mesh = types.SimpleNamespace(model=1, model_index=0, model_group=None)
    _, model = _model("centernet")
    folded = fold_batchnorm(model)
    blocks = [n for n, m in folded.named_modules() if n.split(".")[-1].startswith("s5b")]
    for n in blocks:
        block = folded.get_submodule(n)
        block.c1.conv = ColumnConv(block.c1.conv, mesh)
        block.c2.conv = RowConv(block.c2.conv, mesh)
    counts = swap_folded(folded)
    assert counts == {"fused": _convs(model) - 2 * len(blocks), "kept": 2 * len(blocks)}
    for n in blocks:
        block = folded.get_submodule(n)
        assert type(block) is ResBlock and isinstance(block.c1.conv, ColumnConv) \
            and isinstance(block.c2.conv, RowConv)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "silu", "relu"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [5, 16])
def test_plain_version_is_pytorchs_eager_ops(residual, act, out_dtype, C):
    g = torch.Generator().manual_seed(C)
    y = (4 * torch.randn((2, 3, 5, C), generator=g)).to(torch.bfloat16)
    bias = torch.randn(C, generator=g).to(torch.bfloat16)
    res = torch.randn(y.shape, generator=g).to(torch.bfloat16) if residual else None
    want = y + bias
    if residual:
        want = res + want
    want = {None: lambda v: v, "silu": F.silu, "relu": F.relu}[act](want).to(out_dtype)
    got = conv_epilogue(y, bias, res, act=act, out_dtype=out_dtype)
    assert_equal(got, want)
    assert_equal(conv_epilogue_reference(y, bias, res, act, out_dtype), want)


def test_conv_epilogue_refuses_what_the_kernel_does_not_take():
    y = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    b = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv_epilogue(y.float(), b)
    with pytest.raises(ValueError):
        conv_epilogue(y, b[:4])
    with pytest.raises(ValueError):
        conv_epilogue(y, b, y[:1])
    with pytest.raises(ValueError):
        conv_epilogue(y, b, act="gelu")
    with pytest.raises(TypeError):
        conv_epilogue(y, b, out_dtype=torch.float16)
    fake = torch.ops.cvm_tpu_torch.conv_epilogue(y.to("meta"), b.to("meta"), None, "silu",
                                                 torch.float32)
    assert fake.shape == y.shape and fake.dtype == torch.float32


def _float_folds_int8(model, served):
    """What the ``BiasAdd`` fold's int8 export served for each ``FoldedConv``
    weight of ``served``: the float32 folded weight quantized per output
    channel, dequantized, and cast to bf16 (the ``Conv``'s per-call cast),
    in the served KRSC layout; and the quantization stats."""
    from cvm_tpu_torch.infer.quantize import dequantize_params, quantize_params

    old = fold_batchnorm(model)
    qparams, stats = quantize_params(dict(old.named_parameters()))
    deq = dequantize_params(qparams)
    want = {}
    for name, m in served.named_modules():
        if isinstance(m, FoldedConv):
            key = f"{name}.conv.weight" if f"{name}.conv.weight" in deq else f"{name}.weight"
            want[f"{name}.weight"] = deq[key].to(torch.bfloat16).permute(0, 2, 3, 1)
    return want, stats


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_folded_weights_go_through_weights_npz(quantize, tmp_path):
    from cvm_tpu_torch.cli.export import _flat_weights, served_tensors
    from cvm_tpu_torch.infer.fold_bn import folded_float_weights
    from cvm_tpu_torch.infer.runtime import load_weights

    cfg, model = _model("centernet")
    pipe = InferencePipeline(cfg, model, "cpu", input_format="yuv420", fold_bn=True)
    floats = folded_float_weights(model, pipe.model) if quantize == "int8" else None
    flat, qstats = _flat_weights(pipe.model, quantize, floats)
    np.savez(tmp_path / "weights.npz", **flat)
    got = load_weights(str(tmp_path / "weights.npz"), torch.device("cpu"))
    want = served_tensors(pipe.model)
    assert got.keys() == want.keys()
    if quantize == "int8":  # quantized from the float32 folds, as before the bf16 copies
        int8, stats = _float_folds_int8(model, pipe.model)
        assert any(f"{k}/bf16/int8" in flat for k in int8)  # the small ones stay bf16
        want.update(int8)
        assert qstats["quantized"] == stats["quantized"] == sum(f.endswith("/int8")
                                                                for f in flat)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_int8_export_refuses_a_folded_model_without_its_float32_weights():
    from cvm_tpu_torch.cli.export import _flat_weights
    from cvm_tpu_torch.infer.fold_bn import folded_float_weights

    cfg, model = _model("centernet")
    pipe = InferencePipeline(cfg, model, "cpu", input_format="yuv420", fold_bn=True)
    with pytest.raises(ValueError, match="no float32 weight"):
        _flat_weights(pipe.model, "int8")
    _, other = _model("semseg")
    with pytest.raises((ValueError, KeyError)):
        folded_float_weights(other, pipe.model)


def test_fold_bn_int8_export_quantizes_the_float32_folds(tmp_path):
    from cvm_tpu_torch.cli.export import export_model
    from cvm_tpu_torch.infer.runtime import ServingModel, load_weights
    from cvm_tpu_torch.train.loop import Trainer

    cfg, model = _model("centernet")
    ckdir = str(tmp_path / "ck")
    tr = Trainer(cfg, "cpu", checkpoint_dir=ckdir)
    tr.init_state()
    tr.state.model.load_state_dict(model.state_dict(), strict=True)
    tr.state.step = 1
    tr.ckpt.save(1, tr.checkpoint_state(None))
    tr.ckpt.wait()
    art = str(tmp_path / "art")
    stats = export_model("centernet", ckdir, art, batch_size=2, quantize="int8",
                         input_format="yuv420", fold_bn=True, device="cpu")
    sm = ServingModel(art, device="cpu")
    assert sm.meta["fold_bn"] is True and sm.selftest() == []
    tr = Trainer(cfg, "cpu", checkpoint_dir=ckdir)
    tr.init_state()
    source = tr.eval_model(use_ema=cfg.ema_decay > 0.0)  # what the export read
    pipe = InferencePipeline(cfg, source, "cpu", input_format="yuv420", fold_bn=True)
    want, qstats = _float_folds_int8(source, pipe.model)
    got = load_weights(os.path.join(art, "weights.npz"), torch.device("cpu"))
    assert want and stats["quantized"] == qstats["quantized"]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _scales(model):
    return {n: 0.05 for n, m in model.named_modules() if isinstance(m, Conv)}


POSTURES = {
    "fp": dict(),
    "hflip": dict(tta="hflip"),
    "w8a8_dynamic_fold_bn": dict(w8a8=True, fold_bn=True),
    "w8a8_static_fold_bn": dict(w8a8="scales", fold_bn=True),
    "w8a8_fused": dict(w8a8="scales", w8a8_fused=True),
    "qat_fold_bn": dict(fold_bn=True),
}


@pytest.mark.parametrize("posture", list(POSTURES))
def test_training_and_other_postures_build_no_folded_module(posture):
    cfg, model = _model("centernet", **(dict(qat=True) if posture.startswith("qat") else {}))
    opts = dict(POSTURES[posture])
    if opts.get("w8a8") == "scales":
        opts["w8a8"] = _scales(model)
    pipe = InferencePipeline(cfg, model, "cpu", **opts)
    assert pipe.folded_counts is None
    for m in (model, pipe.model):
        assert not any(isinstance(x, FoldedConv) for x in m.modules())
    from cvm_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, "cpu")
    trainer.init_state()
    assert not any(isinstance(x, FoldedConv) for x in trainer.model.modules())
