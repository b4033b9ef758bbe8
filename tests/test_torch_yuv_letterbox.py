"""The eval YUV420 letterbox op (``ops/cuda/yuv_letterbox.py``) on the CPU,
where it runs its plain version: the op ``cvm_tpu_torch::yuv_letterbox`` is
registered for the CPU and the card, and its CPU version is the eager ops
of the eval preprocess bit for bit (images and ROI fields, bf16 and
float32, both benchmark cells' shapes and edge sizes);
``preprocess_yuv420_batch`` sends every eval call to the op, on any device
(fake CUDA tensors stand for the card), and training draws and RGB input to
the eager ops; an eval call the op does not take raises; the op's fake gives
the kernel's shapes and types, and ``torch.export`` of a YUV ``run`` on the
CPU records the op and serves, saved and loaded, what the eager pipeline
serves; the wrapper refuses what the kernel does not take. The kernel on
the card: ``tests/test_torch_yuv_letterbox_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.registry import build_model
from cvm_tpu_torch.ops.cuda import yuv_letterbox as yl
from cvm_tpu_torch.ops.image import PhotoDraws, RoiDraws, normalize_pm1, resample_yuv420_frame
from cvm_tpu_torch.pipeline import preprocess

# name: (buffer (Hm, Wm), valid sizes (h, w) per image, out_hw)
CASES = {
    "semseg_cell": ((874, 1164), [(874, 1164)], (256, 640)),
    "b8_cell": ((768, 768), [(360, 768), (768, 360), (512, 640), (767, 401)], (512, 512)),
    "odd": ((101, 77), [(101, 77), (99, 75), (57, 33)], (64, 96)),
    "tall_wide": ((300, 300), [(300, 40), (40, 300)], (128, 128)),
    "one_pixel": ((50, 50), [(1, 50), (50, 1), (1, 1)], (32, 48)),
    "upscale": ((20, 30), [(20, 30), (7, 13)], (33, 47)),
}


def planes(buffer_hw, sizes, seed=0):
    rng = np.random.default_rng(seed)
    B, (Hm, Wm) = len(sizes), buffer_hw
    y = rng.integers(0, 256, (B, Hm, Wm), dtype=np.uint8)
    u = rng.integers(0, 256, (B, (Hm + 1) // 2, (Wm + 1) // 2), dtype=np.uint8)
    v = rng.integers(0, 256, u.shape, dtype=np.uint8)
    return [torch.from_numpy(a) for a in (y, u, v, np.asarray(sizes, np.int32))]


def test_op_is_registered_for_the_cpu_and_the_card():
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key("cvm_tpu_torch::yuv_letterbox",
                                                              key)


def eager(y, u, v, hw, out_hw, out_dtype):
    """The eval preprocess as the eager ops: ROIs, the three resamples,
    normalisation and the cast."""
    rois = preprocess.make_rois(hw, out_hw)
    out = resample_yuv420_frame(y, u, v, hw, rois, out_hw)
    return normalize_pm1(out).to(out_dtype), rois


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_cpu_op_is_the_eager_path(case, out_dtype):
    buffer_hw, sizes, out_hw = CASES[case]
    y, u, v, hw = planes(buffer_hw, sizes, seed=len(case))
    want, want_roi = eager(y, u, v, hw, out_hw, out_dtype)
    for image, roi in (yl.yuv_letterbox(y, u, v, hw, out_hw, out_dtype),
                       yl.yuv_letterbox_reference(y, u, v, hw, out_hw, out_dtype),
                       preprocess.preprocess_yuv420_batch(y, u, v, hw, out_hw, out_dtype)):
        assert image.dtype == want.dtype == out_dtype and torch.equal(image, want)
        for name, a, b in zip(roi._fields, roi, want_roi):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert yl.yuv_letterbox.launches == 0  # the plain version launches nothing


def _fake_cuda(tensors):
    """Fake tensors on a CUDA device of ``tensors``' shapes and types (in a
    ``FakeTensorMode``; None kept)."""
    return [None if t is None else torch.empty(t.shape, dtype=t.dtype, device="cuda")
            for t in tensors]


@pytest.fixture
def which(monkeypatch):
    """Makes the op raise "op" and the eager path's first step (its ROIs)
    raise "plain": the exception says which path ``preprocess_yuv420_batch``
    took."""

    def op(*a, **k):
        raise RuntimeError("op")

    def plain(*a, **k):
        raise RuntimeError("plain")

    monkeypatch.setattr(preprocess, "yuv_letterbox", op)
    monkeypatch.setattr(preprocess, "make_rois", plain)

    def path(*args, **kw):
        with pytest.raises(RuntimeError) as e:
            preprocess.preprocess_yuv420_batch(*args, **kw)
        return str(e.value)

    return path


def _draws(B, fake):
    """A training batch's draws (as fake CUDA tensors when ``fake``)."""
    z, flip = torch.zeros(B), torch.zeros(B, dtype=torch.bool)
    roi, photo = (z, z, z, flip), (z, z, z, z)
    if fake:
        roi, photo = _fake_cuda(roi), _fake_cuda(photo)
    return preprocess.AugDraws(RoiDraws(*roi), PhotoDraws(*photo))


@pytest.mark.parametrize("case", ["eval_cpu", "eval_cpu_f32", "eval_cuda", "draws_cpu",
                                  "draws_cuda"])
def test_every_eval_call_takes_the_op(which, case):
    y, u, v, hw = planes(*CASES["odd"][:2])
    out_hw = CASES["odd"][2]
    kw = {"out_dtype": torch.float32 if case.endswith("f32") else torch.bfloat16}
    want = "op" if case.startswith("eval") else "plain"
    if case.endswith("cpu") or case.endswith("f32"):
        if case.startswith("draws"):
            kw["draws"] = _draws(3, fake=False)
        assert which(y, u, v, hw, out_hw, **kw) == want
        return
    with FakeTensorMode(allow_non_fake_inputs=True):
        y, u, v, hw = _fake_cuda((y, u, v, hw))
        if case.startswith("draws"):
            kw["draws"] = _draws(3, fake=True)
        assert which(y, u, v, hw, out_hw, **kw) == want


@pytest.mark.parametrize("case", ["f16_out", "int16_planes", "float_planes"])
def test_an_eval_call_the_op_does_not_take_raises(case):
    y, u, v, hw = planes(*CASES["odd"][:2])
    out_dtype = torch.float16 if case == "f16_out" else torch.bfloat16
    if case != "f16_out":
        y = y.to(torch.int16 if case == "int16_planes" else torch.float32)
    with pytest.raises(TypeError, match="out_dtype" if case == "f16_out" else "uint8"):
        preprocess.preprocess_yuv420_batch(y, u, v, hw, CASES["odd"][2], out_dtype)


def test_rgb_input_never_takes_the_kernel(monkeypatch):
    def kernel(*a, **k):
        raise RuntimeError("kernel")

    monkeypatch.setattr(preprocess, "yuv_letterbox", kernel)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (2, 40, 60, 3), dtype=np.uint8)),
             "image_hw": torch.tensor([[40, 60], [31, 17]], dtype=torch.int32)}
    image, _ = preprocess.preprocess_batch(batch, (32, 48))
    assert image.shape == (2, 32, 48, 3)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_fake_gives_the_kernels_shapes_and_types(out_dtype):
    y, u, v, hw = (t.to("meta") for t in planes(*CASES["odd"][:2]))
    image, table, flip = torch.ops.cvm_tpu_torch.yuv_letterbox(y, u, v, hw, [64, 96], out_dtype)
    assert image.shape == (3, 64, 96, 3) and image.dtype == out_dtype
    assert table.shape == (3, 8) and table.dtype == torch.float32
    assert flip.shape == (3,) and flip.dtype == torch.bool


def test_export_of_a_yuv_run_records_the_op(tmp_path):
    from cvm_tpu_torch.cli.export import _Program, _Served, served_tensors

    spec = get_model("centernet")
    cfg = spec.params_cls(input_hw=(64, 96), backbone="tiny", batch_size=2, neck_features=32,
                          head_features=16, num_classes=3)
    model = build_model(spec, cfg, "cpu", torch.Generator().manual_seed(0))
    pipe = InferencePipeline(cfg, model, "cpu", input_format="yuv420", fold_bn=True)
    y, u, v, hw = planes((80, 120), [(80, 120), (61, 37)])
    with torch.no_grad():
        want = pipe.run(y, u, v, hw)
    weights = served_tensors(pipe.model)
    path = str(tmp_path / "model.pt2")
    with torch.no_grad():
        ep = torch.export.export(_Program(_Served(pipe)), (weights, y, u, v, hw), strict=False)
        torch.export.save(ep, path)
        got = torch.export.load(path).module()(weights, y, u, v, hw)
    ops = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert torch.ops.cvm_tpu_torch.yuv_letterbox.default in ops
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_wrapper_refuses_what_the_kernel_does_not_take():
    y, u, v, hw = planes(*CASES["odd"][:2])
    with pytest.raises(TypeError, match="uint8"):
        yl.yuv_letterbox(y.float(), u, v, hw, (32, 32))
    with pytest.raises(TypeError, match="uint8"):
        yl.yuv_letterbox(y[0], u, v, hw, (32, 32))
    with pytest.raises(ValueError, match="u and v"):
        yl.yuv_letterbox(y, u, v[:, 1:], hw, (32, 32))
    with pytest.raises(ValueError, match="u and v"):
        yl.yuv_letterbox(y, u[:2], v[:2], hw, (32, 32))
    with pytest.raises(TypeError, match="image_hw"):
        yl.yuv_letterbox(y, u, v, hw[:2], (32, 32))
    with pytest.raises(TypeError, match="out_dtype"):
        yl.yuv_letterbox(y, u, v, hw, (32, 32), torch.float16)
    with pytest.raises(ValueError, match="out_hw"):
        yl.yuv_letterbox(y, u, v, hw, (0, 32))
    with pytest.raises(ValueError, match="different devices"):
        yl.yuv_letterbox(y, u, v.to("meta"), hw, (32, 32))
    with pytest.raises(ValueError, match="no kernel for device"):
        yl.yuv_letterbox(y.to("meta"), u.to("meta"), v.to("meta"), hw.to("meta"), (32, 32))


def test_wrapper_passes_what_the_c_interface_takes():
    import re
    from pathlib import Path

    src = (Path(yl.__file__).resolve().parents[2] / "csrc" / "yuv_letterbox.cu").read_text()
    params = re.search(r'extern "C" int yuv_letterbox_launch\(([^)]*)\)', src).group(1)
    kinds = ["P" if "*" in p else "I" for p in params.split(",")]
    assert kinds == ["P" if t is yl.ctypes.c_void_p else "I" for t in yl.ARGTYPES]
