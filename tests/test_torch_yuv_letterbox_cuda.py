"""The eval YUV420 letterbox kernel (``csrc/yuv_letterbox.cu``) on the card:
``yuv_letterbox`` equals PyTorch's eager ops on the same CUDA tensors (the
plain version, ``yuv_letterbox_reference``) bit for bit, images and ROI
fields, in bf16 and float32, at both benchmark cells' shapes and at odd and
edge sizes (odd sizes, an image that fills its buffer, tall and wide
images, 1-pixel sides, widths whose rows are not 16-byte aligned), with
every output element first poisoned; one launch per call and one device
kernel; the eval path of CUDA planes takes the kernel or raises, and a
yuv420 program exported on the CPU runs the kernel once loaded on the card;
a captured CUDA
graph replayed with new ``image_hw`` values gives the new ROIs and images;
and a ``fold_bn`` pipeline of each cell's configuration serves what the
same pipeline serves on the eager preprocess, eagerly and replayed, one
kernel launch per call and per replay.

These need the card (a CUDA kernel has no CPU mode): on a machine without
one each test skips with a reason. The file imports no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_yuv_letterbox_cuda.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.ops.cuda import yuv_letterbox as yl
from cvm_tpu_torch.pipeline import preprocess

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CELLS = {"centernet_b": "closed_loop_coco_b8", "semseg_a": "closed_loop_camera"}
# name: (buffer (Hm, Wm), valid sizes (h, w) per image, out_hw)
CASES = {
    "semseg_cell": ((874, 1164), [(874, 1164)], (256, 640)),
    "b8_cell": ((768, 768), [(360, 768), (768, 360), (512, 640), (767, 401), (600, 600),
                             (433, 719), (768, 768), (361, 362)], (512, 512)),
    "odd": ((101, 77), [(101, 77), (99, 75), (57, 33)], (64, 96)),
    "fills_buffer": ((96, 128), [(96, 128), (96, 128)], (96, 128)),
    "tall": ((300, 64), [(300, 40), (299, 63)], (128, 128)),
    "wide": ((64, 300), [(40, 300), (63, 299)], (128, 128)),
    "one_pixel": ((50, 50), [(1, 50), (50, 1), (1, 1)], (32, 48)),
    "upscale_unaligned": ((20, 30), [(20, 30), (7, 13)], (33, 47)),
    "rows_ragged": ((240, 320), [(240, 320), (239, 319), (120, 320), (240, 100)] * 2,
                    (203, 136)),
    "rows_unaligned": ((120, 200), [(120, 200), (119, 199), (60, 200), (120, 50)] * 2,
                       (203, 300)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the letterbox kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def planes(buffer_hw, sizes, dev, seed=0):
    """Seeded noise planes (the harshest input for the resample) with the
    valid sizes ``sizes``, 4:2:0 chroma of (Hm+1)//2 x (Wm+1)//2."""
    rng = np.random.default_rng(seed)
    B, (Hm, Wm) = len(sizes), buffer_hw
    y = rng.integers(0, 256, (B, Hm, Wm), dtype=np.uint8)
    u = rng.integers(0, 256, (B, (Hm + 1) // 2, (Wm + 1) // 2), dtype=np.uint8)
    v = rng.integers(0, 256, u.shape, dtype=np.uint8)
    hw = np.asarray(sizes, np.int32)
    return [torch.from_numpy(a).to(dev) for a in (y, u, v, hw)]


def poisoned(fn, shape, dtype, dev):
    """``fn()`` after a NaN block of the output's size was freed, so that the
    caching allocator hands the kernel's output that block: an element the
    kernel does not write stays NaN."""
    torch.full(shape, float("nan"), dtype=dtype, device=dev)
    return fn()


def assert_same(got, want, what):
    image, roi = got
    ref_image, ref_roi = want
    assert image.dtype == ref_image.dtype and image.shape == ref_image.shape, what
    unequal = int((image.view(-1) != ref_image.view(-1)).sum())
    assert unequal == 0, f"{what}: {unequal} of {image.numel()} elements differ"
    names = type(roi)._fields
    for name, a, b in zip(names, roi, ref_roi):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, name, a, b)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_the_plain_version(cuda_device, case, out_dtype):
    buffer_hw, sizes, out_hw = CASES[case]
    y, u, v, hw = planes(buffer_hw, sizes, cuda_device, seed=len(case))
    n0 = yl.yuv_letterbox.launches
    got = poisoned(lambda: yl.yuv_letterbox(y, u, v, hw, out_hw, out_dtype),
                   (len(sizes), *out_hw, 3), out_dtype, cuda_device)
    torch.cuda.synchronize()
    assert yl.yuv_letterbox.launches - n0 == 1
    image, roi = yl.yuv_letterbox_reference(y, u, v, hw, out_hw, out_dtype)
    want_roi = preprocess.make_rois(hw, out_hw)
    assert all(torch.equal(a, b) for a, b in zip(roi, want_roi))
    assert_same(got, (image, want_roi), case)
    assert not bool(got[1].flip_x.any())


def test_dispatch_sends_the_eval_path_to_the_kernel(cuda_device):
    y, u, v, hw = planes(*CASES["odd"][:2], cuda_device)
    out_hw = CASES["odd"][2]
    n0 = yl.yuv_letterbox.launches
    got = preprocess.preprocess_yuv420_batch(y, u, v, hw, out_hw, torch.bfloat16)
    preprocess.preprocess_yuv420_batch(y, u, v, hw, out_hw, torch.float32)
    assert yl.yuv_letterbox.launches - n0 == 2
    with pytest.raises(TypeError, match="out_dtype"):  # no eager fallback on the card
        preprocess.preprocess_yuv420_batch(y, u, v, hw, out_hw, torch.float16)
    with pytest.raises(ValueError, match="different devices"):
        preprocess.preprocess_yuv420_batch(y, u, v, hw.cpu(), out_hw, torch.bfloat16)
    preprocess.preprocess_yuv420_batch(y.cpu(), u.cpu(), v.cpu(), hw.cpu(), out_hw)
    assert yl.yuv_letterbox.launches - n0 == 2
    image = yl.yuv_letterbox_reference(y, u, v, hw, out_hw, torch.bfloat16)[0]
    assert torch.equal(got[0], image)


def test_a_cpu_export_serves_the_kernel_on_the_card(cuda_device, tmp_path):
    """A yuv420 program exported on the CPU records the op, so once loaded
    on the card it runs the kernel: one launch a call."""
    from cvm_tpu_torch.cli.export import export_model
    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.models import get_model
    from cvm_tpu_torch.train.loop import Trainer

    cfg = get_model("centernet").params_cls(input_hw=(64, 96), backbone="tiny", batch_size=2,
                                            neck_features=32, head_features=16, num_classes=3)
    tr = Trainer(cfg, "cpu", checkpoint_dir=str(tmp_path / "ck"))
    tr.init_state()
    tr.state.step = 1
    tr.ckpt.save(1, tr.checkpoint_state(None))
    tr.ckpt.wait()
    art = str(tmp_path / "art")
    export_model("centernet", str(tmp_path / "ck"), art, batch_size=2, pad_hw=(80, 120),
                 input_format="yuv420", fold_bn=True, device="cpu")
    served = ServingModel(art, device=cuda_device)
    y, u, v, hw = planes((80, 120), [(80, 120), (61, 37)], cuda_device)
    n0 = yl.yuv_letterbox.launches
    for _ in range(3):
        out = served(y, u, v, hw)
    torch.cuda.synchronize()
    assert yl.yuv_letterbox.launches - n0 == 3
    want = ServingModel(art, device="cpu")(*(t.cpu() for t in (y, u, v, hw)))
    assert out.keys() == want.keys()


_ONE_CALL = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from cvm_tpu_torch.ops.cuda.yuv_letterbox import yuv_letterbox
dev = torch.device("cuda")
y = torch.randint(0, 256, (8, 768, 768), dtype=torch.uint8, device=dev)
u = torch.randint(0, 256, (8, 384, 384), dtype=torch.uint8, device=dev)
hw = torch.tensor([[600, 700]] * 8, dtype=torch.int32, device=dev)
yuv_letterbox(y, u, u, hw, (512, 512))
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    yuv_letterbox(y, u, u, hw, (512, 512))
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def test_one_call_runs_one_device_kernel(cuda_device):
    # In a process of its own: in one that an earlier test profiled, CUPTI
    # recorded no kernel at all.
    proc = subprocess.run([sys.executable, "-c", _ONE_CALL], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    kernels = json.loads(proc.stdout.splitlines()[-1])
    assert len(kernels) == 1 and "yuv_letterbox_kernel" in kernels[0], kernels


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    y, u, v, hw = planes(*CASES["odd"][:2], cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        yl.yuv_letterbox(y, u, v, hw.cpu(), (32, 32))
    with pytest.raises(TypeError, match="uint8"):
        yl.yuv_letterbox(y.float(), u, v, hw, (32, 32))


def test_replayed_graph_reads_new_sizes(cuda_device):
    buffer_hw, sizes, out_hw = CASES["b8_cell"]
    y, u, v, hw = planes(buffer_hw, sizes, cuda_device, seed=5)
    yl.yuv_letterbox(y, u, v, hw, out_hw)  # built and warmed outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = yl.yuv_letterbox.launches
    with torch.cuda.graph(graph):
        image, roi = yl.yuv_letterbox(y, u, v, hw, out_hw)
    assert yl.yuv_letterbox.launches - n0 == 1
    rng = np.random.default_rng(7)
    for _ in range(3):
        new = rng.integers(1, 769, (len(sizes), 2)).astype(np.int32)
        hw.copy_(torch.from_numpy(new))
        fresh = planes(buffer_hw, sizes, "cpu", seed=int(new.sum()))
        for dst, src in zip((y, u, v), fresh[:3]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want_image = yl.yuv_letterbox_reference(y, u, v, hw, out_hw)[0]
        assert_same((image, roi), (want_image, preprocess.make_rois(hw, out_hw)),
                    f"replay with sizes {new.tolist()}")


def _cell(name, dev, seed=2147490011):
    """The cell's program: its configuration and traffic mix, seeded weights,
    and two batches of its frames (``cvbench``, which imports no JAX)."""
    from cvbench import program
    from cvbench.runners.closed_loop_batches import stack
    from cvbench.traffic.generator import frame_pool, stream

    with open(ROOT / "cvbench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    with open(ROOT / "cvbench" / "traffic" / f"{CELLS[name]}.json") as f:
        mix = json.load(f)
    cfg = program.cell_config(cfg, mix)
    params, model, _ = program.build(cfg, seed, dev)
    n = int(cfg["params"]["batch_size"])
    pool = frame_pool(stream(seed, 1), dict(mix, pool=2 * n), cfg["params"]["num_classes"])
    return params, model, stack(pool, n)


def _predict(pipe, batch):
    data = [torch.from_numpy(batch[k]).to(pipe.device) for k in pipe.keys]
    return {k: v.clone() for k, v in pipe.predict(*data).items()}


@pytest.mark.parametrize("cell", list(CELLS))
def test_fold_bn_pipeline_equals_the_eager_preprocess(cuda_device, cell, monkeypatch):
    params, model, batches = _cell(cell, cuda_device)
    new = InferencePipeline(params, model, cuda_device, input_format="yuv420", fold_bn=True)
    old = InferencePipeline(params, model, cuda_device, input_format="yuv420", fold_bn=True)
    for batch in batches + batches + batches:  # eager, capture, then replays
        with monkeypatch.context() as m:
            m.setattr(preprocess, "yuv_letterbox", yl.yuv_letterbox_reference)
            want = _predict(old, batch)
        n0 = yl.yuv_letterbox.launches
        got = _predict(new, batch)
        assert yl.yuv_letterbox.launches - n0 == 1
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (cell, k)
    for pipe in (new, old):
        c = pipe.graph_counts
        assert (c["first_sighting"], c["captures"]) == (1, 1)
        assert c["replays"] == 3 * len(batches) - 1
