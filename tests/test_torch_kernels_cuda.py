"""Hand-written CUDA kernels of cvm_tpu_torch against their plain versions.

These need the card: a CUDA kernel has no CPU mode, so on a machine without
one each test skips with a reason. The file imports no JAX, so it also runs
on a machine that has none:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from cvm_tpu_torch.ops.cuda.fused_qconv import (cin_split, fused_qconv, fused_qconv_reference,
                                                pack_qconv_weights, qconv_plan)
from cvm_tpu_torch.ops.cuda.gaussian_splat import render_heatmap, render_heatmap_reference
from cvm_tpu_torch.ops.heatmap import prepare_centers

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


def _run_case(dev, shape, mode, rng, packed=False):
    k, B, H, W, cin, cout, act = shape
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
    n0, p0 = fused_qconv.launches, fused_qconv.weight_packs
    w_packed = pack_qconv_weights(args[1]) if packed else None
    got = fused_qconv(*args, **kw, w_packed=w_packed)
    torch.cuda.synchronize()
    assert fused_qconv.launches == n0 + 1
    assert fused_qconv.weight_packs == p0 + (0 if packed else 1)
    ref = fused_qconv_reference(*args, **kw)
    assert_kernel_close(got, ref)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_qconv_kernel_matches_plain(cuda_device, shape, mode):
    k, B, H, W, cin, cout, act = shape
    _run_case(cuda_device, shape, mode, np.random.default_rng(k * 1000 + cout + cin))


# The 16 config-B calls of one int8 forward (B 8, 3x3): name -> (H = W, Cin,
# Cout, mode, act), mode as the main path runs them.
MAIN = {
    "stem": (256, 12, 32, "bf16_in", "silu"), "s2_c1": (128, 64, 64, "int8_out", "silu"),
    "s2_c2": (128, 64, 64, "int8_in", None), "s3_c1": (64, 128, 128, "int8_out", "silu"),
    "s3_c2": (64, 128, 128, "int8_in", None), "s4_c1": (32, 256, 256, "int8_out", "silu"),
    "s4_c2": (32, 256, 256, "int8_in", None), "s5_c1": (16, 512, 512, "int8_out", "silu"),
    "s5_c2": (16, 512, 512, "int8_in", None), "up0_c1": (32, 768, 128, "bf16_in", "silu"),
    "up0_c2": (32, 128, 128, "bf16_in", "silu"), "up1_c1": (64, 256, 128, "bf16_in", "silu"),
    "up1_c2": (64, 128, 128, "bf16_in", "silu"), "up2_c1": (128, 192, 128, "bf16_in", "silu"),
    "up2_c2": (128, 128, 128, "bf16_in", "silu"), "head_c1": (128, 128, 64, "bf16_in", "silu"),
}


@pytest.mark.parametrize("name", list(MAIN))
def test_fused_qconv_kernel_main_path_shapes(cuda_device, name):
    hw, cin, cout, mode, act = MAIN[name]
    _run_case(cuda_device, (3, 8, hw, hw, cin, cout, act), mode,
              np.random.default_rng(len(name) + cin), packed=True)


# Batch 16, the flagship's eval batch (cli.evaluate --quantize w8a8_fused
# at 512^2): one call per Cin-split path it takes. The stem keeps its folded
# taps; s5 and up0, whose Cin batch 8 splits over a cluster, run unsplit.
BATCH16 = ["stem", "s5_c1", "up0_c1"]


@pytest.mark.parametrize("name", BATCH16)
def test_fused_qconv_kernel_batch16_paths(cuda_device, name):
    hw, cin, cout, mode, act = MAIN[name]
    plan = qconv_plan(3, cin, cout)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert plan.fold if name == "stem" else cin_split(plan, 16, hw, hw, sms) == 1
    _run_case(cuda_device, (3, 16, hw, hw, cin, cout, act), mode,
              np.random.default_rng(16 + cin), packed=True)


# One case per special path: the folded stem taps, the Cin split over a
# cluster, Cout 512 (four Cout tiles), W not a multiple of the 8-wide tile.
SPECIAL = {
    "stem_fold": ((3, 2, 40, 24, 12, 32, "silu"), "int8_out"),
    "cin_split": ((3, 1, 16, 16, 256, 128, None), "bf16_out"),
    "cout_512": ((3, 1, 16, 24, 64, 512, "relu"), "f32_out"),
    "w_ragged": ((3, 3, 19, 29, 96, 96, "silu"), "int8_in"),
}


@pytest.mark.parametrize("name", list(SPECIAL))
def test_fused_qconv_kernel_special_paths(cuda_device, name):
    shape, mode = SPECIAL[name]
    k, B, H, W, cin, cout, _ = shape
    plan = qconv_plan(k, cin, cout)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert {"stem_fold": plan.fold, "cin_split": cin_split(plan, B, H, W, sms) > 1,
            "cout_512": plan.ntiles == 4, "w_ragged": W % 8 != 0}[name]
    _run_case(cuda_device, shape, mode, np.random.default_rng(len(name)), packed=True)


# The dense models' new paths at 256x640 (config A at batch 1, C and D at
# batch 8): name -> (B, H, W, Cin, Cout, mode, act). Stride 32 gives an 8x20
# map, ragged in both H and W against the 16x8 pixel tile; at batch 1 its
# Cin splits four ways over a cluster. The decoders concatenate skips into
# Cin 160, 192 and 320, and run at stride 2 (128x320).
DENSE = {
    "b1_s5_c1": (1, 8, 20, 512, 512, "int8_out", "silu"),
    "b1_s5_c2": (1, 8, 20, 512, 512, "int8_in", None),
    "b1_up16_c1": (1, 16, 40, 768, 256, "bf16_in", "silu"),
    "b1_stem": (1, 128, 320, 12, 32, "bf16_in", "silu"),
    "b8_s5_c1": (8, 8, 20, 512, 512, "int8_out", "silu"),
    "b8_up16_c1": (8, 16, 40, 768, 256, "bf16_in", "silu"),
    "b8_up4_c1_semseg": (8, 64, 160, 192, 128, "bf16_in", "silu"),
    "b8_up4_c1_multitask": (8, 64, 160, 320, 128, "bf16_in", "silu"),
    "b8_up2_c1": (8, 128, 320, 160, 64, "bf16_in", "silu"),
    "b8_head_c1": (8, 128, 320, 64, 64, "bf16_in", "silu"),
}


@pytest.mark.parametrize("name", list(DENSE))
def test_fused_qconv_kernel_dense_paths(cuda_device, name):
    B, H, W, cin, cout, mode, act = DENSE[name]
    plan = qconv_plan(3, cin, cout)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if name.startswith("b1_s5"):
        assert cin_split(plan, B, H, W, sms) == 4
    _run_case(cuda_device, (3, B, H, W, cin, cout, act), mode,
              np.random.default_rng(len(name) + cin), packed=True)


def splat_case(dev, name):
    """Per-object inputs of the Gaussian splat K1 for one named case."""
    # name -> (B, K, Hs, Ws, C) of the random cases: the main paths' three
    # shapes (multitask's stride-4 map of 256x640), a non-square map, a row length Ws*C that is not a multiple of
    # 4 floats, a 1x1 map with one class, no objects at all, objects that
    # are all invalid, and rows wider than a tile (flat chunks)
    shapes = {"flagship": (16, 8, 128, 128, 10), "config_b": (8, 128, 128, 128, 80),
              "multitask": (8, 128, 64, 160, 10),
              "non_square": (2, 6, 24, 40, 3), "ragged": (3, 7, 13, 17, 5),
              "one_pixel": (2, 3, 1, 1, 1), "k0": (2, 0, 32, 32, 3),
              "all_invalid": (4, 16, 128, 128, 10), "wide_row": (1, 6, 8, 1024, 80)}
    rng = np.random.default_rng(len(name))
    if name in shapes:
        B, K, hs, ws, C = shapes[name]
        x0 = rng.uniform(-8, ws, (B, K)).astype(np.float32)
        y0 = rng.uniform(-8, hs, (B, K)).astype(np.float32)
        w = rng.uniform(1, min(96, ws + 2), (B, K)).astype(np.float32)
        h = rng.uniform(1, min(96, hs + 2), (B, K)).astype(np.float32)
        boxes = np.stack([x0, y0, x0 + w, y0 + h], -1)
        valid = np.arange(K)[None] < rng.integers(0, K + 1, (B, 1))
        if name in ("ragged", "one_pixel", "wide_row"):
            valid = rng.uniform(size=(B, K)) < 0.8
        if name == "all_invalid":
            valid = np.zeros((B, K), bool)
        if name == "one_pixel":  # boxes of several sizes around the one pixel
            half = rng.uniform(0.2, 4, (B, K, 1)).astype(np.float32)
            boxes = np.concatenate([0.5 - half, 0.5 - half, 0.5 + half, 0.5 + half], -1)
        cls = rng.integers(0, C, (B, K))
    else:
        hs, ws, C = 32, 32, 3
        boxes = {  # (x0, y0, x1, y1) per object, map coords
            "empty": [[4, 4, 12, 12], [20, 2, 30, 9]],
            "border": [[-12, -12, 13, 13], [14, 18, 49, 45], [-10, 20, 11, 40]],
            "radius0": [[10, 10, 11.5, 11.5], [3, 20, 4, 21]],
            "overlap": [[6, 6, 22, 20], [9, 8, 25, 24]],
            "class_c": [[6, 6, 22, 20], [9, 8, 25, 24]],
            # a box 40 maps wide centred in the map: its radius exceeds the map
            "huge_radius": [[-624, -624, 656, 656], [3, 20, 9, 27]],
        }[name]
        boxes = np.asarray([boxes], np.float32)
        K = boxes.shape[1]
        valid = np.full((1, K), name != "empty")
        cls = {"class_c": [[C, -1]], "overlap": [[1, 1]]}.get(name, [list(range(K))])
        cls = np.asarray(cls) % (C + 2) if name != "class_c" else np.asarray(cls)
    _, _, _, _, v, ix, iy, radius, sigma = prepare_centers(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev), (hs, ws), 0.7)
    cls = torch.from_numpy(np.asarray(cls, np.int32).reshape(boxes.shape[:2])).to(dev)
    return (iy, ix, sigma, radius, cls, v), (hs, ws), C


SPLAT_CASES = ["flagship", "config_b", "multitask", "empty", "border", "radius0", "overlap", "class_c",
               "non_square", "ragged", "one_pixel", "k0", "all_invalid", "huge_radius",
               "wide_row"]


@pytest.mark.parametrize("name", SPLAT_CASES)
def test_gaussian_splat_kernel_matches_plain(cuda_device, name):
    """Values lie in [0, 1]; the kernel follows the plain version's order of
    operations with accurate expf, so they agree to 1e-6."""
    args, map_hw, C = splat_case(cuda_device, name)
    n0 = render_heatmap.launches
    got = render_heatmap(*args, map_hw, C)
    torch.cuda.synchronize()
    assert render_heatmap.launches == n0 + 1
    ref = render_heatmap_reference(*args, map_hw, C)
    assert got.shape == ref.shape == (args[0].shape[0], *map_hw, C)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    if name in ("empty", "k0", "all_invalid"):
        assert float(got.abs().sum()) == 0.0
    if name == "class_c":  # both objects carry an out-of-range class: dropped
        assert bool(args[5].all()) and float(got.abs().sum()) == 0.0
    if name == "radius0":
        assert int((got > 0).sum()) == 2 and float(got.max()) == 1.0
    if name == "huge_radius":
        assert float(args[3][0, 0]) > max(map_hw) and bool((got[0, ..., 0] > 0).all())
    if name in ("ragged", "one_pixel", "wide_row", "non_square"):
        assert float(got.max()) == 1.0


@pytest.mark.parametrize("name", ["flagship", "ragged", "wide_row"])
def test_gaussian_splat_kernel_writes_every_element(cuda_device, name):
    """The output comes from torch.empty: poison the block the caching
    allocator will hand back with NaN, free it, and find no NaN after the
    call."""
    args, map_hw, C = splat_case(cuda_device, name)
    render_heatmap(*args, map_hw, C)  # builds the kernel; its output is freed
    shape = (args[0].shape[0], *map_hw, C)
    torch.cuda.synchronize()
    poison = torch.full(shape, float("nan"), device=cuda_device)
    ptr = poison.data_ptr()
    del poison
    got = render_heatmap(*args, map_hw, C)
    torch.cuda.synchronize()
    if got.data_ptr() != ptr:
        pytest.skip("the caching allocator did not hand the poisoned block back")
    assert not bool(torch.isnan(got).any())
    torch.testing.assert_close(got, render_heatmap_reference(*args, map_hw, C),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_fused_qconv_op_equals_the_direct_launch(cuda_device, mode):
    """The custom op (what FusedConvBN and the exported programs call)
    launches the same kernel as the op's CUDA implementation called
    directly, once per call, with the same result to the bit."""
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    rng = np.random.default_rng(11)
    shape = (3, 2, 16, 20, 32, 64, "silu")
    k, B, H, W, cin, cout, act = shape
    x = torch.from_numpy(rng.normal(0, 1, (B, H, W, cin)).astype(np.float32)).to(cuda_device)
    inv_sx = 1.0 / 0.021
    if mode == "int8_in":
        x, inv_sx = x.clamp(-3, 3).mul(40).round().to(torch.int8), None
    elif mode == "bf16_in":
        x = x.to(torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)).to(
        cuda_device)
    scale = torch.full((cout,), 1e-3, device=cuda_device)
    bias = torch.zeros(cout, device=cuda_device)
    out_dtype = {"bf16_out": torch.bfloat16, "int8_out": torch.int8}.get(mode, torch.float32)
    inv_s_out = 0.5 if mode == "int8_out" else None
    wp = pack_qconv_weights(wq)
    n0 = fq.fused_qconv.launches
    got = torch.ops.cvm_tpu_torch.fused_qconv(x, wq, scale, bias, wp, inv_sx, act, out_dtype,
                                              inv_s_out)
    direct = fq._launch(x, wq, scale, bias, wp, inv_sx, act, out_dtype, inv_s_out)
    torch.cuda.synchronize()
    assert fq.fused_qconv.launches == n0 + 2
    assert got.dtype == out_dtype and torch.equal(got, direct)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_fused_qconv_fake_shapes_on_the_card(cuda_device, out_dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(8, 64, 64, 128, dtype=torch.bfloat16, device=cuda_device)
        w = torch.empty(3, 3, 128, 96, dtype=torch.int8, device=cuda_device)
        s = torch.empty(96, device=cuda_device)
        y = torch.ops.cvm_tpu_torch.fused_qconv(x, w, s, s, None, 2.0, None, out_dtype,
                                                4.0 if out_dtype == torch.int8 else None)
        assert y.shape == (8, 64, 64, 96) and y.dtype == out_dtype
        assert y.device.type == "cuda"


# (Cin, Cout, k, stride, H, W): the stem's K = 12 * 9 = 108 (padded to
# 112), heads with Cout 2 and 10 (padded to 8 and 16), a stride-2 conv,
# and M = B*H*W <= 16 (rows padded to 32).
INT_MM = {"stem K108": (12, 32, 3, 1, 64, 64), "head Cout2": (64, 2, 1, 1, 32, 32),
          "head Cout10": (64, 10, 1, 1, 32, 32), "s2": (64, 128, 3, 2, 32, 32),
          "M<=16": (24, 40, 3, 1, 1, 3)}


@pytest.mark.parametrize("name", list(INT_MM))
def test_int8_conv_int_mm_equals_the_plain_sums(cuda_device, name):
    from cvm_tpu_torch.infer.quantize import Int8Conv, int8_conv_reference
    from cvm_tpu_torch.models.layers import Conv

    cin, cout, k, s, H, W = INT_MM[name]
    torch.manual_seed(0)
    q = Int8Conv(Conv(cin, cout, k, s).to(cuda_device), None)
    assert q.kp % 8 == 0 and q.npad % 8 == 0
    xq, sx = q.quantize(torch.randn(2, H, W, cin, device=cuda_device) * 3)
    n0 = Int8Conv.mm_launches
    acc = q.int8_conv(xq)
    torch.cuda.synchronize()
    assert Int8Conv.mm_launches == n0 + 1 and acc.dtype == torch.int32
    assert torch.equal(acc, int8_conv_reference(q, xq))


def test_3d_config_b_int8_forward_launches(cuda_device):
    """Config B with the monocular 3D heads, ``w8a8_fused_chain`` at batch
    8: 27 K2 launches per forward (config B's 24, plus each 3D head's 3x3
    128 -> 64 c1, a shape config B's own heads already run), 7 with int8
    output, no weight packing."""
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.centernet.model import create_model
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.models.layers import Conv
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    cfg = CenternetParams(with_3d=True)
    model = create_model(cfg, cuda_device)
    scales = {n: 0.05 for n, m in model.named_modules() if isinstance(m, Conv)}
    pipe = InferencePipeline(cfg, model, cuda_device, input_format="rgb", w8a8=scales,
                             w8a8_fused=True, w8a8_chain=True)
    assert pipe.fused_counts["calls"] == 27
    x = torch.zeros(8, 512, 512, 3, device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad():
        pipe.heads(x)  # warm: nothing is packed per call after the first
        fq.reset_counts()
        out = pipe.heads(x)
    torch.cuda.synchronize()
    assert (fq.fused_qconv.launches, fq.fused_qconv.int8_out_launches,
            fq.fused_qconv.weight_packs) == (27, 7, 0)
    assert set(out) >= {"depth3d", "dims3d", "rot"} and out["rot"].shape == (8, 128, 128, 2)


def test_cli_infer_artifact_launches_k2_24_times_per_batch(cuda_device, tmp_path):
    """``cli.infer --artifact`` over image files, on a config-B
    ``w8a8_fused_chain`` RGB export (batch 8, 768^2) of a fresh checkpoint:
    24 K2 launches per batch-8 call (10 images: two calls, the second
    padded), one JSON line per image."""
    import contextlib
    import io
    import json

    from PIL import Image

    from cvm_tpu_torch.cli.export import main as export_main
    from cvm_tpu_torch.cli.infer import main as infer_main
    from cvm_tpu_torch.data.synthetic import synthetic_sample
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.train.loop import Trainer

    tr = Trainer(CenternetParams(), cuda_device, checkpoint_dir=str(tmp_path / "ck"))
    tr.init_state()
    tr.state.step = 1
    tr.ckpt.save(1, tr.checkpoint_state(None))
    tr.ckpt.wait()  # the write is asynchronous
    art = str(tmp_path / "art")
    assert export_main(["--model", "centernet", "--checkpoint_dir", str(tmp_path / "ck"),
                        "--out", art, "--input_format", "rgb", "--quantize",
                        "w8a8_fused_chain", "--batch_size", "8", "--pad_hw", "768,768"]) == 0
    rng = np.random.default_rng(0)
    (tmp_path / "img").mkdir()
    for i in range(10):
        s = synthetic_sample(rng, (480, 640), num_classes=10)
        Image.fromarray(s["image"]).save(tmp_path / "img" / f"{i}.jpg", quality=90)
    out = io.StringIO()
    fq.reset_counts()
    with contextlib.redirect_stdout(out):
        assert infer_main(["--artifact", art, "--images", str(tmp_path / "img" / "*"),
                           "--score_threshold", "0"]) == 0
    torch.cuda.synchronize()
    assert fq.fused_qconv.launches == 2 * 24
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [x["input"] for x in lines] == [f"{i}.jpg" for i in range(10)]
    assert all(len(x["scores"]) == 100 for x in lines)


def test_warp_and_ssim_on_the_card_match_the_cpu(cuda_device):
    """The warp's sampled frame, valid mask and depth, and the SSIM map,
    within 1e-5 of the CPU's on the same inputs; its projected coordinates
    within 1e-4 px."""
    from cvm_tpu_torch.ops.ssim import ssim
    from cvm_tpu_torch.ops.warp import warp_frame

    rng = np.random.default_rng(3)
    B, H, W = 2, 48, 160
    src = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(3, 30, (B, H, W, 1)).astype(np.float32)
    rot = rng.normal(0, 0.01, (B, 3)).astype(np.float32)
    trans = rng.normal(0, 0.3, (B, 3)).astype(np.float32)
    intr = np.array([[144.0, 144.0, 80.0, 24.0]] * B, np.float32)
    res = rng.normal(0, 0.05, (B, H, W, 3)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (src, depth, rot, trans, intr, res)]
    cpu = warp_frame(*args)
    card = warp_frame(*(a.to(cuda_device) for a in args))
    for name, c, g in zip(cpu._fields, cpu, card):
        # A projected coordinate is u = X fx / z + cx, a sum of terms of a
        # few hundred pixels whose float32 step is 1.5e-5 to 3.1e-5, which
        # the card contracts into FMAs: coordinates are held to 1e-4 px.
        err = float((g.cpu() - c).abs().max())
        print(f"warp_frame {name}: max |card - cpu| {err:.3e}")
        if name == "coords":
            torch.testing.assert_close(g.cpu(), c, rtol=0, atol=1e-4, msg=f"{name}: {err}")
        else:
            torch.testing.assert_close(g.cpu(), c, rtol=1e-5, atol=1e-5, msg=f"{name}: {err}")
    b = np.clip(src + rng.normal(0, 0.1, src.shape), 0, 1).astype(np.float32)
    s_cpu = ssim(torch.from_numpy(src), torch.from_numpy(b))
    s_card = ssim(torch.from_numpy(src).to(cuda_device), torch.from_numpy(b).to(cuda_device))
    torch.testing.assert_close(s_card.cpu(), s_cpu, rtol=0, atol=1e-5)


def test_dmds_loss_gradient_on_the_card_is_finite(cuda_device):
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.models.registry import get_model

    spec = get_model("dmds")
    cfg = spec.params_cls(input_hw=(96, 320), batch_size=2)
    model = spec.create_model(cfg, cuda_device).train()
    b = synthetic_batch(np.random.default_rng(0), 2, (144, 480), two_frame=True)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in b.items()}
    inputs, targets = spec.make_processor(cfg, True)(
        torch.Generator(device=cuda_device).manual_seed(0), batch)
    loss, metrics = spec.loss_fn(model(inputs), targets, cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    assert torch.isfinite(loss) and all(torch.isfinite(v).all() for v in metrics.values())
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


# -- the JPEG decoder of the card's machine (csrc/jpeg_nvjpeg.cu) -----------


def box_mean(P, g, oh, ow):
    """The rounded mean of each g x g block of the plane P, its last row and
    column replicated, over an oh x ow grid (libjpeg's reduced IDCT in
    exact arithmetic; the card's k_rgb_from_planes ``box``)."""
    h, w = P.shape
    ys = np.clip(np.arange(oh * g), 0, h - 1)
    xs = np.clip(np.arange(ow * g), 0, w - 1)
    q = P.astype(np.int64)[ys][:, xs].reshape(oh, g, ow, g).sum((1, 3))
    return (q + g * g // 2) // (g * g)


def ycc_rgb(y, cb, cr):
    """libjpeg's YCbCr -> RGB tables (jdcolor.c, SCALEBITS 16)."""
    xcb, xcr = cb - 128, cr - 128
    r = y + ((91881 * xcr + 32768) >> 16)
    g = y + ((-22554 * xcb + 32768 - 46802 * xcr) >> 16)
    b = y + ((116130 * xcb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def libjpeg_rgb_from_planes(Y, U, V, num):
    """What csrc/jpeg_nvjpeg.cu computes from a 4:2:0 JPEG's component
    planes (libjpeg's raw planes, or nvJPEG's) for the RGB output at scale
    num/8, in numpy: at full scale libjpeg's h2v2 fancy upsampling and
    YCbCr -> RGB tables; at a reduced scale the luma box-averaged by 8/num
    and the chroma by 4/num, without upsampling."""
    H, W = Y.shape
    f = 8 // num
    oh, ow = -(-H // f), -(-W // f)

    def fancy(C):
        ch, cw = C.shape
        C = C.astype(np.int64)
        ys, xs = np.arange(H), np.arange(W)
        if cw <= 2:
            return C[ys >> 1][:, xs >> 1]
        other = np.clip(np.where(ys & 1, (ys >> 1) + 1, (ys >> 1) - 1), 0, ch - 1)
        nb = np.clip(np.where(xs & 1, (xs >> 1) + 1, (xs >> 1) - 1), 0, cw - 1)
        cs = 3 * C[ys >> 1] + C[other]
        return (3 * cs[:, xs >> 1] + cs[:, nb] + np.where(xs & 1, 7, 8)) >> 4

    if f == 1:
        return ycc_rgb(Y.astype(np.int64), fancy(U), fancy(V))
    return ycc_rgb(box_mean(Y, f, oh, ow), box_mean(U, f // 2, oh, ow),
                   box_mean(V, f // 2, oh, ow))


def libjpeg_plan(factors, c, num):
    """libjpeg's plan for component ``c`` of a frame with sampling
    ``factors`` ((h, v) per component) at scale num/8 (jdmaster.c
    jpeg_calc_output_dimensions, jdsample.c jinit_upsampler): its DCT size
    (num, doubled while it stays within 8 and both of the frame's sampling
    ratios stay whole) and the upsampling ratio (rh, rv) onto the output."""
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    h, v = factors[c]
    ssize = num
    while ssize < 8 and (mh * num) % (h * ssize * 2) == 0 and (mv * num) % (v * ssize * 2) == 0:
        ssize *= 2
    return ssize, mh // (h * ssize // num), mv // (v * ssize // num)


def libjpeg_rgb_upsampled(planes, factors, num, out_hw, full_scale_planes):
    """libjpeg's RGB (out_hw) at scale num/8 from a frame's component planes,
    in numpy: each component at its DCT size (``libjpeg_plan``), then
    upsampled as jdsample.c does: "fancy" while num > 1 for the ratios 2:1
    (h2v1, when the plane is wider than 2 samples), 1:2 (h1v2) and 2:2
    (h2v2, wider than 2), each output (3 * nearer + further sample + bias)
    >> 2 (bias 1 for the left or upper, 2 for the right or lower one of a
    pair; h2v2 blends the rows, then across, bias 8 left and 7 right, >> 4),
    the first and last samples replicated beyond the edge; any other whole
    ratio by replication (int_upsample); then its YCbCr -> RGB tables (R =
    G = B = Y for one component). ``full_scale_planes``: the planes are at
    full scale (nvJPEG's) and are first box-averaged by 8 / DCT size, as the
    card does; else they are libjpeg's own at that scale."""
    oh, ow = out_hw
    ys, xs = np.arange(oh), np.arange(ow)
    comps = []
    for c, P in enumerate(planes):
        ssize, rh, rv = libjpeg_plan(factors, c, num)
        if full_scale_planes:
            g = 8 // ssize
            P = box_mean(P, g, -(-P.shape[0] // g), -(-P.shape[1] // g))
        P = P.astype(np.int64)
        cy, cx = ys // rv, xs // rh
        near = P[cy][:, cx]
        wide = P.shape[1] > 2
        if num == 1 or (rh, rv) not in ((2, 1), (1, 2), (2, 2)) or (rh == 2 and not wide):
            comps.append(near)
            continue
        ny = np.clip(np.where(ys & 1, cy + 1, cy - 1), 0, P.shape[0] - 1)
        nx = np.clip(np.where(xs & 1, cx + 1, cx - 1), 0, P.shape[1] - 1)
        if rv == 1:
            comps.append((3 * near + P[cy][:, nx] + np.where(xs & 1, 2, 1)) >> 2)
        elif rh == 1:
            comps.append((3 * near + P[ny][:, cx] + np.where(ys & 1, 2, 1)[:, None]) >> 2)
        else:
            rows = 3 * near + P[ny][:, cx]
            further = 3 * P[cy][:, nx] + P[ny][:, nx]
            comps.append((3 * rows + further + np.where(xs & 1, 7, 8)) >> 4)
    if len(comps) == 1:
        return np.repeat(np.clip(comps[0], 0, 255).astype(np.uint8)[..., None], 3, -1)
    return ycc_rgb(*comps)


LAYOUT_FACTORS = {"4:4:0": ((1, 2), (1, 1), (1, 1)), "4:1:1": ((4, 1), (1, 1), (1, 1)),
                  "4:1:0": ((4, 2), (1, 1), (1, 1)), "4:1:0 v": ((2, 4), (1, 1), (1, 1)),
                  "1x4": ((1, 4), (1, 1), (1, 1)), "3x1": ((3, 1), (1, 1), (1, 1)),
                  "Cr 2x1": ((2, 2), (1, 1), (2, 1))}


def relaid_frames():
    """A 4:4:0 and a 4:1:1 JPEG (``chip_smoke.relayout_jpeg``; odd height
    and width) made from the fixture's subsampling frames: the 4:2:2 JPEG
    re-declared, and the 4:4:4 frame's recorded pixels encoded as 4:2:0
    (PIL, quality 90) and re-declared."""
    import io

    import chip_smoke
    from PIL import Image

    frames = {name: (data, scales) for name, data, scales in other_subsamplings()}
    buf = io.BytesIO()
    Image.fromarray(frames["444"][1][8][2]).save(buf, format="JPEG", quality=90,
                                                 subsampling=2)
    return {"4:4:0": chip_smoke.relayout_jpeg(frames["422"][0], "4:4:0"),
            "4:1:1": chip_smoke.relayout_jpeg(buf.getvalue(), "4:1:1")}


def whole_ratio_frames():
    """Three-component JPEGs whose chroma libjpeg upsamples by replication
    (int_upsample) or with mixed ratios, odd-sized, made from the fixture's
    4:4:4 frame's recorded pixels: a 1x4 luma (a PIL 4:2:0 JPEG re-declared
    by ``chip_smoke.relayout_jpeg``), and 4:1:0, its vertical twin, a 3x1
    luma and a 4:2:0 frame whose Cr is 2x1 (``chip_smoke.encode_jpeg``;
    no encoder at hand writes them). {name: jpeg}, sampling factors in
    ``LAYOUT_FACTORS``."""
    import io

    import chip_smoke
    from PIL import Image

    frames = {name: (data, scales) for name, data, scales in other_subsamplings()}
    rgb = frames["444"][1][8][2]
    src = io.BytesIO()
    Image.fromarray(rgb).save(src, format="JPEG", quality=90, subsampling=2)
    out = {"1x4": chip_smoke.relayout_jpeg(src.getvalue(), "1x4")}
    odd = rgb[:rgb.shape[0] - 1 + rgb.shape[0] % 2, :rgb.shape[1] - 1 + rgb.shape[1] % 2]
    for name in ("4:1:0", "4:1:0 v", "3x1", "Cr 2x1"):
        out[name] = chip_smoke.encode_jpeg(odd, LAYOUT_FACTORS[name])
    return out


def feeder_yuv_from_rgb(rgb):
    """jpeg_feeder.cc's RGB -> planar 4:2:0 (its path for scaled or
    non-4:2:0 sources; k_yuv_from_rgb on the card), in numpy: fixed-point Y
    per pixel, chroma from the rounded 2x2 average of RGB, an odd last row
    or column paired with itself."""
    p = rgb.astype(np.int64)
    h, w, _ = p.shape
    y = (77 * p[..., 0] + 150 * p[..., 1] + 29 * p[..., 2] + 128) >> 8
    ys = np.minimum(np.arange(0, h, 2)[:, None] + np.arange(2), h - 1)
    xs = np.minimum(np.arange(0, w, 2)[:, None] + np.arange(2), w - 1)
    m = (p[ys[:, :, None, None], xs[None, None]].sum((1, 3)) + 2) >> 2
    r, g, b = m[..., 0], m[..., 1], m[..., 2]
    u = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128
    v = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128
    return tuple(np.clip(c, 0, 255).astype(np.uint8) for c in (y, u, v))


def yuv_follows_rgb(jpegs, device, threads=(1, 4)):
    """Each frame at the reduced scales 1/2, 1/4, 1/8 (an even pad around
    the scaled extent, so the scale choice lands on it and the decoder
    converts RGB to 4:2:0): the planes equal ``feeder_yuv_from_rgb`` of the
    same decoder's RGB at that scale; the pad stays Y 0, U/V 128."""
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420
    from cvm_tpu_torch.data.images import jpeg_size

    for i, data in enumerate(jpegs):
        h, w = jpeg_size(data)
        for num in (4, 2, 1):
            oh, ow = -(-h * num // 8), -(-w * num // 8)
            ph, pw = oh + oh % 2, ow + ow % 2
            for t in threads:
                rgb, hw = decode_jpeg_batch([data] * 2, ph, pw, t, device=device)
                Y, U, V, yhw = decode_jpeg_batch_yuv420([data] * 2, ph, pw, t, device=device)
                assert hw.tolist() == yhw.tolist() == [[oh, ow]] * 2, (i, num, hw, yhw)
                ch, cw = (oh + 1) // 2, (ow + 1) // 2
                for k in range(2):
                    want = feeder_yuv_from_rgb(rgb[k, :oh, :ow])
                    for got, wnt, pad in ((Y[k], want[0], 0), (U[k], want[1], 128),
                                          (V[k], want[2], 128)):
                        np.testing.assert_array_equal(got[:wnt.shape[0], :wnt.shape[1]], wnt,
                                                      err_msg=f"frame {i} num {num}")
                        rest = got.copy()
                        rest[:wnt.shape[0], :wnt.shape[1]] = pad
                        assert (rest == pad).all(), (i, num)
                assert (ch, cw) == want[1].shape


def test_jpeg_decoder_holds_to_the_fixture(cuda_device):
    """Frame by frame: the full-scale frames within IDCT rounding of the
    reference's libjpeg, the 1/2-scale frame within the reference's own
    fallback gap on that frame (chip_smoke.fixture_decode_check)."""
    import chip_smoke

    res = chip_smoke.fixture_decode_check(cuda_device)
    print(res)
    assert res["case"].startswith("b")
    assert res["no_target rgb"]["bound"] == ["idct"] * 7 + ["fallback"]


def test_jpeg_decoder_converts_rgb_to_yuv420_as_the_feeder(cuda_device):
    """k_yuv_from_rgb exactly: the card's planes against jpeg_feeder.cc's
    integer formulas applied to the card's own RGB, with 1 and 4 threads."""
    import chip_smoke

    jpegs, _ = chip_smoke.fixture_jpegs()
    yuv_follows_rgb(jpegs, cuda_device)


def other_subsamplings():
    """The fixture's 4:4:4, 4:2:2 and grayscale JPEGs with the reference
    decoder's RGB at each scale (``scripts/make_torch_record_fixture.py``):
    [(name, jpeg, {num: (hw, sha256, pixels, fallback gap)})]."""
    import lzma

    import chip_smoke

    from cvm_tpu_torch.data.records import RecordDataset

    ds = RecordDataset([f"{chip_smoke.FIXTURE_DIR}/subsamplings.cvrec"])
    out = []
    for k in range(len(ds)):
        meta, blobs = ds.get(k)
        flat = np.frombuffer(lzma.decompress(blobs["rgb"]), np.uint8)
        scales, at = {}, 0
        for num in (8, 4, 2, 1):
            d = meta["decoded"][str(num)]
            size = d["hw"][0] * d["hw"][1] * 3
            scales[num] = (d["hw"], d["sha256"], flat[at:at + size].reshape(*d["hw"], 3),
                           d["fallback_gap"])
            at += size
        assert at == flat.size
        out.append((meta["id"], blobs["jpeg"], scales))
    return out


def check_other_subsamplings(device):
    """Each of the fixture's 4:4:4, 4:2:2 and grayscale JPEGs at each scale
    (a pad of exactly the scaled extent), with 1 and 4 threads, against the
    reference decoder's recorded RGB: ``hw`` equal, and the pixels
    identical on the CPU (the same libjpeg). Elsewhere, at full scale,
    within what IDCT rounding can do (``chip_smoke.IDCT_GAP``; 1 for
    grayscale, R = G = B = Y); at a reduced scale, where the box average of
    the clipped full-scale IDCT is not libjpeg's clipped reduced IDCT,
    within the reference's own fallback gap at that scale. Then the YUV420
    output of the same JPEGs follows their RGB. Returns the readings
    {name: {num: (mean |d|, max |d|)}}."""
    import hashlib

    import chip_smoke

    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch

    exact = torch.device(device).type == "cpu"
    readings = {}
    jpegs = []
    for name, data, scales in other_subsamplings():
        jpegs.append(data)
        for num, (hw, sha, want, fallback) in scales.items():
            for threads in (1, 4):
                out, ohw = decode_jpeg_batch([data] * 2, *hw, threads, device=device)
                assert ohw.tolist() == [hw] * 2, (name, num, ohw)
                assert (out[0] == out[1]).all()
                if exact:
                    assert hashlib.sha256(out[0].tobytes()).hexdigest() == sha, (name, num)
                d = np.abs(out[0].astype(int) - want)
                readings.setdefault(name, {})[num] = (float(d.mean()), int(d.max()))
                bound = dict(chip_smoke.IDCT_GAP["rgb"]) if num == 8 else fallback
                if num == 8 and name == "gray":
                    bound["max_abs"] = 1
                assert d.mean() <= bound["mean_abs"] and d.max() <= bound["max_abs"], (
                    name, num, readings[name], bound)
    yuv_follows_rgb(jpegs, device)
    return readings


def test_jpeg_decoder_other_subsamplings_follow_libjpeg(cuda_device):
    """4:4:4, 4:2:2 and grayscale on the card (k_rgb_from_planes' other
    branches, and k_yuv_from_rgb at full scale) against libjpeg's recorded
    decode, at every scale."""
    print(check_other_subsamplings(cuda_device))


def check_layouts(frames, device):
    """Each frame of ``frames`` ({layout: jpeg}, sampling factors in
    ``LAYOUT_FACTORS``; odd height and width) decoded by ``device``'s
    decoder, RGB: at full scale within what IDCT rounding can do of
    libjpeg's (PIL's) decode (``chip_smoke.IDCT_GAP``); at every scale
    identical to ``libjpeg_rgb_upsampled`` applied to the decoder's own
    planes (``decode_jpeg_planes``: the card's at full scale, libjpeg's on
    the CPU at that scale), with 1 and 4 threads; then their YUV420 output
    follows their RGB. Returns {layout: (mean |d|, max |d|) against PIL at
    full scale}."""
    import io

    import chip_smoke
    from PIL import Image

    from cvm_tpu_torch.data.images import jpeg_size
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_planes

    on_card = torch.device(device).type != "cpu"
    readings = {}
    for layout, data in frames.items():
        H, W = jpeg_size(data)
        assert H % 2 == 1 and W % 2 == 1, (layout, H, W)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        for num in (8, 4, 2, 1):
            oh, ow = -(-H * num // 8), -(-W * num // 8)
            planes = decode_jpeg_planes(data, 8 if on_card else num, device=device)
            want = libjpeg_rgb_upsampled(planes, LAYOUT_FACTORS[layout], num, (oh, ow),
                                         full_scale_planes=on_card)
            for threads in (1, 4):
                out, hw = decode_jpeg_batch([data] * 2, oh, ow, threads, device=device)
                assert hw.tolist() == [[oh, ow]] * 2, (layout, num, hw)
                np.testing.assert_array_equal(out[0], want, err_msg=f"{layout} num {num}")
                np.testing.assert_array_equal(out[1], want)
            if num == 8:
                d = np.abs(out[0].astype(int) - pil)
                readings[layout] = (float(d.mean()), int(d.max()))
                bound = chip_smoke.IDCT_GAP["rgb"]
                assert d.mean() <= bound["mean_abs"] and d.max() <= bound["max_abs"], (
                    layout, readings[layout], bound)
    yuv_follows_rgb(list(frames.values()), device)
    return readings


def check_440_411(device):
    """``check_layouts`` on the 4:4:0 and 4:1:1 frames of ``relaid_frames``."""
    return check_layouts(relaid_frames(), device)


def test_jpeg_decoder_440_and_411_follow_libjpeg(cuda_device):
    """4:4:0 and 4:1:1 on the card (k_rgb_from_planes' h1v2 and 4:1:1
    branches): within the IDCT gap of libjpeg (PIL) at full scale, and
    exactly libjpeg's upsampling and color arithmetic applied to nvJPEG's
    planes at every scale."""
    print(check_440_411(cuda_device))


def color_space_frames():
    """Three-component 4:4:4 JPEGs whose color space libjpeg guesses from
    their markers (jdapimin.c): {name: (jpeg, "rgb" or "ycc")}. PIL writes
    the fixture's 4:4:4 frame's recorded pixels with ``keep_rgb`` (an Adobe
    marker with transform 0, component ids 'R', 'G', 'B', no JFIF marker);
    then the same bytes with the Adobe transform set to 1, with the Adobe
    marker cut (the ids decide), and with a JFIF marker put first (JFIF
    means YCbCr whatever follows)."""
    import io

    from PIL import Image

    frames = {name: (data, scales) for name, data, scales in other_subsamplings()}
    buf = io.BytesIO()
    Image.fromarray(frames["444"][1][8][2]).save(buf, format="JPEG", quality=90,
                                                 keep_rgb=True, subsampling=0)
    data = buf.getvalue()
    assert b"JFIF" not in data
    at = data.index(b"\xff\xee")  # APP14
    end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    assert data[at + 4:at + 9] == b"Adobe" and data[at + 15] == 0
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    return {"adobe 0": (data, "rgb"),
            "adobe 1": (data[:at + 15] + b"\x01" + data[at + 16:], "ycc"),
            "ids RGB": (data[:at] + data[end:], "rgb"),
            "JFIF, adobe 0": (data[:2] + jfif + data[2:], "ycc")}


def check_color_spaces(device):
    """Each frame of ``color_space_frames`` decoded by ``device``'s decoder
    at every scale, with 1 and 4 threads: exactly its planes
    (``decode_jpeg_planes``: the card's at full scale, box-averaged by
    8/num as the card does; libjpeg's own at that scale on the CPU) taken
    as R, G, B, or through libjpeg's YCbCr tables, as libjpeg guesses the
    color space; at full scale within the IDCT gap of PIL's (libjpeg's)
    decode. Then their YUV420 follows their RGB (a 4:4:4 frame has no raw
    4:2:0 planes to hand over). Returns {name: (mean |d|, max |d|) against
    PIL at full scale}."""
    import io

    import chip_smoke
    from PIL import Image

    from cvm_tpu_torch.data.images import jpeg_size
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_planes

    on_card = torch.device(device).type != "cpu"
    readings = {}
    frames = color_space_frames()
    for name, (data, space) in frames.items():
        H, W = jpeg_size(data)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        for num in (8, 4, 2, 1):
            f = 8 // num
            oh, ow = -(-H // f), -(-W // f)
            planes = decode_jpeg_planes(data, 8 if on_card else num, device=device)
            if on_card:
                planes = [box_mean(P, f, oh, ow) for P in planes]
            want = (np.stack(planes, -1).astype(np.uint8) if space == "rgb"
                    else ycc_rgb(*(P.astype(np.int64) for P in planes)))
            for threads in (1, 4):
                out, hw = decode_jpeg_batch([data] * 2, oh, ow, threads, device=device)
                assert hw.tolist() == [[oh, ow]] * 2, (name, num, hw)
                np.testing.assert_array_equal(out[0], want, err_msg=f"{name} num {num}")
                np.testing.assert_array_equal(out[1], want)
            if num == 8:
                d = np.abs(out[0].astype(int) - pil)
                readings[name] = (float(d.mean()), int(d.max()))
                bound = chip_smoke.IDCT_GAP["rgb"]
                assert d.mean() <= bound["mean_abs"] and d.max() <= bound["max_abs"], (
                    name, readings[name], bound)
    yuv_follows_rgb([data for data, _ in frames.values()], device)
    return readings


def test_jpeg_decoder_follows_libjpegs_color_space(cuda_device):
    """RGB and YCbCr 4:4:4 JPEGs as libjpeg tells them apart (Adobe
    transform, component ids, JFIF): k_rgb_from_planes converts the YCbCr
    ones and hands the RGB ones over as they are, exactly as libjpeg does
    with the card's planes, and within the IDCT gap of PIL."""
    print(check_color_spaces(cuda_device))


def refused_frames():
    """The fixture's 4:4:4 frame's recorded pixels as a CMYK JPEG (PIL):
    {"cmyk": jpeg}."""
    import io

    from PIL import Image

    frames = {name: (data, scales) for name, data, scales in other_subsamplings()}
    cmyk = io.BytesIO()
    Image.fromarray(frames["444"][1][8][2]).convert("CMYK").save(cmyk, format="JPEG", quality=90)
    return {"cmyk": cmyk.getvalue()}


def check_refused_layouts(device):
    """The CMYK JPEG of ``refused_frames`` is unreadable to both decoders,
    as to libjpeg, which cannot convert it to RGB: the zero frame, hw
    (1, 1), no fault. Returns {name: hw at full scale}."""
    from cvm_tpu_torch.data.images import jpeg_size
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420

    hws = {}
    for name, data in refused_frames().items():
        H, W = jpeg_size(data)
        H, W = H + H % 2, W + W % 2
        out, hw = decode_jpeg_batch([data], H, W, device=device)
        Y, U, V, yhw = decode_jpeg_batch_yuv420([data], H, W, device=device)
        hws[name] = hw[0].tolist()
        assert hw.tolist() == yhw.tolist() == [[1, 1]], (name, hw, yhw)
        assert not out.any() and not Y.any() and (U == 128).all() and (V == 128).all()
    return hws


def check_whole_ratios(device):
    """``check_layouts`` on ``whole_ratio_frames``: 1x4, 4:1:0 (and its
    vertical twin), 3x1 and a Cr of its own ratio."""
    return check_layouts(whole_ratio_frames(), device)


def test_jpeg_decoder_refuses_the_layouts_it_does_not_model(cuda_device):
    """A CMYK JPEG on the card: the zero frame and hw (1, 1), and no fault
    of the decoder raised. The layouts the card refused before it modelled
    libjpeg's whole-ratio upsampling (1x4, 4:1:0) decode now, as libjpeg
    decodes them (``check_whole_ratios``)."""
    assert check_refused_layouts(cuda_device) == {"cmyk": [1, 1]}
    print(check_whole_ratios(cuda_device))


def test_jpeg_decoder_scales_follow_the_planes(cuda_device):
    """Each frame at each scale (a pad of exactly its scaled extent, so the
    scale choice lands on it): the RGB equals the numpy model applied to
    the card's own full-scale planes (its YUV420 raw path), with 1 and 4
    threads."""
    import chip_smoke

    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420

    jpegs, _ = chip_smoke.fixture_jpegs()
    Y, U, V, hw = decode_jpeg_batch_yuv420(jpegs, 1152, 1152, device=cuda_device)
    for i, (h, w) in enumerate(hw.tolist()):
        planes = (Y[i, :h, :w], U[i, :(h + 1) // 2, :(w + 1) // 2],
                  V[i, :(h + 1) // 2, :(w + 1) // 2])
        for num in (8, 4, 2, 1):
            oh, ow = -(-h * num // 8), -(-w * num // 8)
            want = libjpeg_rgb_from_planes(*planes, num)
            for threads in (1, 4):
                out, ohw = decode_jpeg_batch([jpegs[i]] * 2, oh, ow, threads,
                                             device=cuda_device)
                assert ohw.tolist() == [[oh, ow]] * 2, (i, num, ohw)
                np.testing.assert_array_equal(out[0], want, err_msg=f"frame {i} num {num}")
                np.testing.assert_array_equal(out[1], want)


def test_jpeg_decoder_marks_corrupt_bytes(cuda_device):
    """Bytes that are not a JPEG, and JPEGs cut short or with corrupt
    entropy data, are the image's fault: a zero frame with hw (1, 1) or
    what nvJPEG recovers, never a raise; the good frames beside them
    decode."""
    import chip_smoke

    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420

    jpegs, _ = chip_smoke.fixture_jpegs()
    flipped = bytearray(jpegs[2])
    flipped[len(flipped) // 2:len(flipped) // 2 + 64] = bytes(64)
    batch = [jpegs[0], b"not a jpeg", jpegs[1][:200], b"", b"\xff\xd8", jpegs[3][:1000],
             jpegs[4][:len(jpegs[4]) // 2], bytes(flipped), b"\xff\xd8" + bytes(500)]
    not_jpeg = [1, 2, 3, 4, 8]  # no frame header: nothing to recover
    out, hw = decode_jpeg_batch(batch, 768, 768, device=cuda_device)
    print("rgb hw", hw.tolist())
    for i in not_jpeg:
        assert hw[i].tolist() == [1, 1] and not out[i].any(), i
    assert hw[0].tolist() != [1, 1]
    Y, U, V, yhw = decode_jpeg_batch_yuv420(batch, 768, 768, device=cuda_device)
    print("yuv420 hw", yhw.tolist())
    for i in not_jpeg:
        assert yhw[i].tolist() == [1, 1] and not Y[i].any() and (U[i] == 128).all(), i
    assert yhw[0].tolist() != [1, 1]


def test_jpeg_decoder_raises_on_a_fault_of_its_own(cuda_device, tmp_path, monkeypatch):
    """A decoder that cannot run on the card raises and names the fault; it
    does not hand out the corrupt-image zero frames. A fresh copy of the
    library (its own handle) is pointed at a card that does not exist."""
    import shutil

    import chip_smoke

    from cvm_tpu_torch.data import jpeg

    built = jpeg.get_lib(cuda_device)
    shutil.copy(built._name, tmp_path / "jpeg_nvjpeg_copy.so")
    lib = jpeg._declare_nvjpeg(__import__("ctypes").CDLL(str(tmp_path / "jpeg_nvjpeg_copy.so")))
    assert lib.cvm_decode_set_device(torch.cuda.device_count() + 7) == 0
    monkeypatch.setattr(jpeg, "get_lib", lambda device: lib)
    jpegs, _ = chip_smoke.fixture_jpegs()
    with pytest.raises(RuntimeError, match="could not start on the card.*cudaSetDevice"):
        jpeg.decode_jpeg_batch(jpegs[:2], 768, 768, device=cuda_device)
    with pytest.raises(RuntimeError, match="could not start on the card"):
        jpeg.decode_jpeg_batch_yuv420(jpegs[:2], 768, 768, device=cuda_device)


def test_record_loader_batch_on_the_card(cuda_device):
    """A RecordLoader batch of the fixture, decoded on the card: the frames
    as decode_jpeg_batch gives them, the labels from the metas."""
    import chip_smoke

    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch_yuv420
    from cvm_tpu_torch.data.loader import RecordLoader
    from cvm_tpu_torch.data.records import RecordDataset

    ds = RecordDataset([f"{chip_smoke.FIXTURE_DIR}/scenes.cvrec"])
    jpegs, metas = chip_smoke.fixture_jpegs()
    loader = RecordLoader(ds, 8, (768, 768), shuffle=False, loop=False,
                          output_format="yuv420", device=cuda_device)
    (batch,) = list(loader)
    Y, U, V, hw = decode_jpeg_batch_yuv420(jpegs, 768, 768, device=cuda_device)
    np.testing.assert_array_equal(batch["y"], Y)
    np.testing.assert_array_equal(batch["u"], U)
    np.testing.assert_array_equal(batch["image_hw"], hw)
    for i, m in enumerate(metas):
        n = len(m["boxes"])
        assert batch["num_objects"][i] == n
        sy, sx = hw[i][0] / m["height"], hw[i][1] / m["width"]
        np.testing.assert_allclose(batch["boxes"][i, :n],
                                   np.float32(m["boxes"]) * np.float32([sx, sy, sx, sy]),
                                   rtol=1e-6)
    assert set(loader.stats()) == {"read_ms_per_batch", "decode_ms_per_batch",
                                   "assemble_ms_per_batch", "batches"}


# -- the stall watchdog and remat on the card --------------------------------


def test_watchdog_sees_a_device_stall_and_re_execs(cuda_device, tmp_path):
    """``tests/torch_hang_child.py`` on the card (tiny CenterNet): step 4
    sleeps on the device for 20 s while the host runs ahead to the
    in-flight bound; the watchdog (threshold 3 s) must call it the device's
    stall, re-exec once, and the new image resume from the step-2
    checkpoint and finish all 10 steps with one K1 launch per step."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CVM_STALL_THRESHOLD_S="3", CVM_HANG_S="20")
    env.pop("CVM_RESTART_COUNT", None)
    proc = subprocess.run([sys.executable, os.path.join(repo, "tests", "torch_hang_child.py"),
                           str(tmp_path / "ck"), "10", "cuda", "tiny", "hang"],
                          capture_output=True, text=True, env=env, cwd=repo, timeout=300)
    out, err = proc.stdout, proc.stderr
    print(out, err[-2000:])
    assert proc.returncode == 0, err[-3000:]
    assert "no training step completed on the device" in err and "AUTO-RESTART 1/1" in err
    resumed = [line.split() for line in out.splitlines() if line.startswith("RESUMED")]
    assert [r[1] for r in resumed] == ["0", "2"], out
    assert [line.split()[1:3] for line in out.splitlines()
            if line.startswith("DONE")] == [["10", "8"]], out


def test_remat_equal_on_the_card(cuda_device):
    """CenterNet config-B width at 128x128, batch 2, one training forward and
    backward with and without ``remat``, deterministic cuDNN: outputs,
    loss, gradients and BatchNorm statistics identical."""
    from cvm_tpu_torch.models import get_model
    from cvm_tpu_torch.models.registry import build_model

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res = []
        for remat in (False, True):
            spec = get_model("centernet")
            cfg = spec.params_cls(input_hw=(128, 128), batch_size=2, remat=remat)
            m = build_model(spec, cfg, cuda_device, torch.Generator().manual_seed(0)).train()
            x = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
            out = m(x.to(cuda_device))
            loss = sum((o.float() ** 2).mean() for o in out.values())
            grads = torch.autograd.grad(loss, list(m.parameters()))
            res.append((out, loss, grads, [b.clone() for b in m.buffers()]))
        (o0, l0, g0, b0), (o1, l1, g1, b1) = res
        assert all(torch.equal(o0[k], o1[k]) for k in o0) and torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        assert all(torch.equal(a, b) for a, b in zip(b0, b1))
    finally:
        torch.backends.cudnn.deterministic = det
