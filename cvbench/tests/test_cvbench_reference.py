"""The plain reference agrees with the program (``cvm_tpu_torch``) at a tiny
size on the CPU, given the same weights and frames: the models with the
program's convs in float32, the YUV420 letterbox, the decode, and the
kernel arithmetic."""

import numpy as np
import pytest
import torch

from cvbench import program
from cvbench.reference import model as ref
from cvbench.reference.decode import decode
from cvbench.reference.flops import forward_flops
from cvbench.reference.kernels import k2_bound_s
from cvbench.reference.preprocess import letterbox, preprocess_yuv420
from cvbench.traffic.generator import frame_pool

CPU = torch.device("cpu")
TINY = {
    "centernet": {"model": "centernet", "program": {
        "params": "cvm_tpu_torch.models.centernet.params:CenternetParams",
        "model": "cvm_tpu_torch.models.centernet.model:CenterNet"},
        "weights": {"gain": {"hm.out.weight": 25.0}, "shift": {"size.out.bias": 6.0}},
        "params": {"input_hw": [64, 64], "batch_size": 2, "num_classes": 5, "stride": 4,
                   "backbone": "tiny", "neck_features": 32, "head_features": 16, "top_k": 20}},
    "semseg": {"model": "semseg", "program": {
        "params": "cvm_tpu_torch.models.semseg.params:SemsegParams",
        "model": "cvm_tpu_torch.models.semseg.model:SemsegNet"},
        "params": {"input_hw": [64, 96], "batch_size": 1, "num_classes": 5, "backbone": "tiny",
                   "decoder_features": 16}},
}


def _f32(model):
    for m in model.modules():
        if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
            m.dtype = torch.float32
    return model


@pytest.mark.parametrize("name", ["centernet", "semseg"])
def test_model_matches_the_program(name):
    cfg = TINY[name]
    _, model, w = program.build(cfg, 2 ** 31 + 5, CPU)
    x = torch.randn(2, *cfg["params"]["input_hw"], 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = _f32(model)(x)
        want = ref.forward(w, x.permute(0, 3, 1, 2), program.ref_cfg(cfg))
    if name == "semseg":
        got, want = {"logits": got["logits"]}, {"logits": want}
    for k, v in want.items():
        g = got[k].permute(0, 3, 1, 2)
        assert torch.allclose(g, v, rtol=1e-4, atol=1e-4 * float(v.abs().max())), k


def test_weights_follow_the_seed():
    a = program.build(TINY["semseg"], 3, CPU)[2]
    b = program.build(TINY["semseg"], 3, CPU)[2]
    c = program.build(TINY["semseg"], 4, CPU)[2]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["seg.out.weight"], c["seg.out.weight"])


def test_preprocess_matches_the_program():
    from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch

    mix = {"pool": 4, "buffer_hw": [120, 160], "src_h": [50, 120], "src_w": [50, 160],
           "max_objects": 4}
    frames = frame_pool(np.random.default_rng(3), mix, 5)
    for out_hw in ((64, 64), (64, 96)):
        for f in frames:
            t = {k: torch.from_numpy(f[k]) for k in f}
            got, _ = preprocess_yuv420_batch(t["y"], t["u"], t["v"], t["image_hw"], out_hw)
            h, w = (int(v) for v in f["image_hw"][0])
            want = preprocess_yuv420(t["y"][0], t["u"][0], t["v"][0], h, w, out_hw)
            assert torch.allclose(got[0].permute(2, 0, 1), want, atol=1e-4)


def test_decode_matches_the_program():
    from cvm_tpu_torch.ops.decode import decode_centernet
    from cvm_tpu_torch.ops.image import letterbox_roi, map_boxes_to_input

    g = torch.Generator().manual_seed(1)
    hm, off, sz = (torch.randn(1, 16, 16, c, generator=g) for c in (5, 2, 2))
    det = decode_centernet(hm, off, sz, stride=4, top_k=20)
    hw = torch.tensor([[50.0, 70.0]])
    boxes = map_boxes_to_input(det.boxes, letterbox_roi(hw[:, 0], hw[:, 1], 64, 64))[0]
    b, s, c = decode(hm[0].permute(2, 0, 1), off[0].permute(2, 0, 1), sz[0].permute(2, 0, 1), 4, 20,
                     letterbox(50, 70, 64, 64))
    assert torch.allclose(s, det.scores[0]) and torch.equal(c.int(), det.classes[0])
    assert torch.allclose(b, boxes, atol=1e-4)


def test_flops_and_kernel_arithmetic():
    cfg = program.ref_cfg(TINY["semseg"])
    w = program.build(TINY["semseg"], 1, CPU)[2]
    f1, f2 = forward_flops(w, cfg, 1), forward_flops(w, cfg, 2)
    # the stem alone: 2 * (32 * 48) * 16 * (12 * 9)
    assert f1 > 2 * 32 * 48 * 16 * 12 * 9 and f2 == pytest.approx(2 * f1)
    # a 3x3 64->64 conv at batch 8, 128x128: operations bound it at int8 rates
    assert k2_bound_s(8, 128, 128, 64, 64, 3, 1, 1) == pytest.approx(
        max(2.0 * 8 * 128 * 128 * 9 * 64 * 64 / 1979e12,
            (8 * 128 * 128 * 128 + 9 * 64 * 64 + 512) / 3.35e12))


def test_control_quantizers_are_coarser():
    from cvbench.reference.lowprec import control_quant

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(1, 8, 6, 6, generator=g), torch.randn(4, 8, 3, 3, generator=g)
    err = {n: float((control_quant(n)(x, w)[0] - x).abs().max()) for n in ("int8", "int4")}
    assert 0 < err["int8"] < err["int4"]
    # e4m3 keeps 3 mantissa bits: a relative error of at most 2^-4 at every magnitude
    xq, wq = control_quant("fp8_e4m3")(x, w)
    assert 0 < float(((xq - x).abs() / x.abs()).max()) <= 2 ** -4 + 1e-6
    assert float(((wq - w).abs() / w.abs()).max()) <= 2 ** -4 + 1e-6
    # bfloat16 keeps 7 bits: the program's precision sits far below the control's
    assert float(((x.bfloat16().float() - x).abs() / x.abs()).max()) <= 2 ** -8


def test_static_int8_witness_calibrates_as_the_export():
    """The witness's calibration set is the scenes an int8 export calibrates
    on, and its per-conv scales are the export's, from the same weights."""
    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.data.synthetic import synthetic_batch

    from cvbench.reference.lowprec import StaticInt8, calibration_scene

    pad = (96, 96)
    theirs, mine = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        b = synthetic_batch(theirs, 2, pad, num_classes=5)
        for i in range(2):
            h, w = (int(v) for v in b["image_hw"][i])
            assert np.array_equal(b["image"][i, :h, :w], calibration_scene(mine, pad, 5))
    cfg = TINY["centernet"]
    params, model, w = program.build(cfg, 2 ** 31 + 6, CPU)
    want = calibration_scales(params, _f32(model), pad, 3, 1, CPU)
    q = StaticInt8()
    q.calibrate(w, program.ref_cfg(cfg), CPU, pad)
    assert set(q.scales) == set(want)
    for k, v in want.items():
        assert q.scales[k] == pytest.approx(v, rel=1e-3), k
    x = torch.randn(1, 16, 8, 8)
    k = next(iter(want))
    xq, _ = q(x * 1e3, torch.randn(4, 16, 3, 3), k)
    assert float(xq.abs().max()) == pytest.approx(127 * q.scales[k], rel=1e-6)   # clipped
