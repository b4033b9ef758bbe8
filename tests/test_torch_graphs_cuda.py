"""``InferencePipeline.predict``'s CUDA graphs (``infer/graphs.py``) on the
card: every call of a captured signature replays the whole device step, and
each result is bit-equal to the eager ``run`` on the same inputs, in the
benchmark's semseg cell (its configuration, seeded weights and frames, BN
folded) and across the zoo's postures; a second buffer size captures a
graph of its own; a result outlives later calls; new weights loaded in
place reach the replay; ``cvm.infer.replay`` shows once per replayed call;
the launch counters read the same for a replay as for an eager call.

These need the card (CUDA graphs have no CPU mode): on a machine without
one each test skips with a reason. The file imports no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.models.layers import Conv
from cvm_tpu_torch.models.registry import build_model

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CELL = ROOT / "cvbench" / "configs" / "semseg_a.json"
CELL_MIX = ROOT / "cvbench" / "traffic" / "closed_loop_camera.json"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(frame, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in frame.items()}


def _eager(pipe, data):
    with torch.no_grad():
        out = pipe.run(*data)
    return {k: v.clone() for k, v in out.items()}


def assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _cell_pipeline(dev, fold_bn=True):
    """The semseg cell's program: its configuration, weights from a seed,
    and its pool of frames (``cvbench``, which imports no JAX)."""
    from cvbench import program
    from cvbench.traffic.generator import frame_pool, stream

    with open(CELL) as f:
        cfg = json.load(f)
    with open(CELL_MIX) as f:
        mix = json.load(f)
    seed = 2147490011
    params, model, _ = program.build(cfg, seed, dev)
    pipe = InferencePipeline(params, model, dev, input_format="yuv420", fold_bn=fold_bn)
    return pipe, frame_pool(stream(seed, 1), dict(mix, pool=6), cfg["params"]["num_classes"])


def test_cell_frames_replay_bit_equal_to_run(cuda_device):
    pipe, pool = _cell_pipeline(cuda_device)
    for frame in pool:
        data = [_to(frame, cuda_device)[k] for k in pipe.keys]
        want = _eager(pipe, data)
        assert_equal(pipe.predict(*data), want)
        assert_equal({k: v.to(cuda_device) for k, v in pipe(frame).items()}, want)
    c = pipe.graph_counts
    assert (c["first_sighting"], c["captures"], c["replays"]) == (1, 1, 2 * len(pool) - 1)


def test_second_buffer_size_captures_its_own_graph(cuda_device):
    pipe, pool = _cell_pipeline(cuda_device)
    rng = np.random.default_rng(5)
    wide = {"y": rng.integers(0, 256, (1, 720, 1280), dtype=np.uint8),
            "u": rng.integers(0, 256, (1, 360, 640), dtype=np.uint8),
            "v": rng.integers(0, 256, (1, 360, 640), dtype=np.uint8),
            "image_hw": np.array([[716, 1270]], np.int32)}
    for frame in (pool[0], wide, pool[1], wide, pool[2], wide):
        data = [_to(frame, cuda_device)[k] for k in pipe.keys]
        assert_equal(pipe.predict(*data), _eager(pipe, data))
    c = pipe.graph_counts
    assert (c["first_sighting"], c["captures"], c["replays"]) == (2, 2, 4)


def test_an_earlier_result_outlives_later_calls(cuda_device):
    pipe, pool = _cell_pipeline(cuda_device)
    results = [pipe(f)["class_map"] for f in pool]
    assert pipe.graph_counts["replays"] == len(pool) - 1
    for frame, got in zip(pool, results):
        data = [_to(frame, cuda_device)[k] for k in pipe.keys]
        assert torch.equal(got, _eager(pipe, data)["class_map"])
    assert len({r.data_ptr() for r in results}) == len(results)


def test_update_variables_reaches_the_replay(cuda_device):
    pipe, pool = _cell_pipeline(cuda_device, fold_bn=False)
    data = [_to(pool[0], cuda_device)[k] for k in pipe.keys]
    before = pipe.predict(*data)
    pipe.predict(*data)
    g = torch.Generator().manual_seed(1)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=g).to(v) if v.dim() == 4 else v
             for k, v in pipe.model.state_dict().items()}  # the conv kernels moved
    pipe.update_variables(state)
    after = pipe.predict(*data)
    assert pipe.graph_counts["captures"] == 1 and pipe.graph_counts["replays"] == 2
    assert_equal(after, _eager(pipe, data))
    assert not torch.equal(after["class_map"], before["class_map"])


def test_replay_span_once_per_replayed_call(cuda_device):
    pipe, pool = _cell_pipeline(cuda_device)
    pipe(pool[0]), pipe(pool[1])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for f in pool[2:5]:
            pipe(f)["class_map"].cpu()
    names = [e.name for e in prof.events()  # host ranges (each also shows on the device)
             if e.name.startswith("cvm.") and e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("cvm.infer.replay") == 3
    assert names.count("cvm.infer.call") == 3 and names.count("cvm.infer.h2d") == 3
    assert not {"cvm.infer.preprocess", "cvm.infer.forward", "cvm.infer.postprocess"} & set(names)


def _zoo_inputs(pipe, rng, buf_hw):
    """Device inputs in ``pipe.keys``' order: random planes or RGB buffers
    of ``buf_hw`` with valid sizes inside them, intrinsics for 3D heads."""
    n, (bh, bw) = pipe.cfg.batch_size, buf_hw
    hw = np.stack([2 * rng.integers(bh // 4, bh // 2 + 1, n),
                   2 * rng.integers(bw // 4, bw // 2 + 1, n)], 1).astype(np.int32)
    shapes = {"y": (n, bh, bw), "u": (n, bh // 2, bw // 2), "v": (n, bh // 2, bw // 2),
              "image": (n, bh, bw, 3)}
    out = []
    for k in pipe.keys:
        base = k.replace("_t1", "")
        if base in shapes:
            out.append(rng.integers(0, 256, shapes[base], dtype=np.uint8))
        elif k == "image_hw":
            out.append(hw)
        else:  # intrinsics in source pixels
            out.append(np.tile(np.float32([[700.0, 700.0, bw / 2, bh / 2]]), (n, 1)))
    return [torch.from_numpy(a).to(pipe.device) for a in out]


# (model, params, pipeline options): the postures the zoo serves.
def _scales(model):
    return {n: 0.05 for n, m in model.named_modules() if isinstance(m, Conv)}


POSTURES = {
    "centernet_fp": ("centernet", {}, {}),
    "centernet_fold_bn": ("centernet", {}, dict(fold_bn=True)),
    "centernet_hflip": ("centernet", {}, dict(tta="hflip")),
    "centernet_rgb": ("centernet", {}, dict(input_format="rgb", fold_bn=True)),
    "centernet_w8a8_fused": ("centernet", {}, dict(w8a8="scales", w8a8_fused=True)),
    "centernet_w8a8_chain": ("centernet", {}, dict(w8a8="scales", w8a8_fused=True,
                                                   w8a8_chain=True)),
    "centernet_w8a8_static": ("centernet", {}, dict(w8a8="scales")),
    "centernet_w8a8_dynamic": ("centernet", {}, dict(w8a8=True)),
    "centernet_qat": ("centernet", dict(qat=True), {}),
    "centernet_3d": ("centernet", dict(with_3d=True), dict(fold_bn=True)),
    "semseg_hflip": ("semseg", {}, dict(tta="hflip", fold_bn=True)),
    "depth_fold_bn": ("depth", {}, dict(fold_bn=True)),
    "multitask_fold_bn": ("multitask", {}, dict(fold_bn=True)),
    "dmds_fp": ("dmds", {}, {}),
}


@pytest.mark.parametrize("posture", list(POSTURES))
def test_zoo_posture_replays_bit_equal_to_run(cuda_device, posture):
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.utils import prof

    name, fields, opts = POSTURES[posture]
    spec = get_model(name)
    cfg = spec.params_cls(**fields, batch_size=2)
    model = build_model(spec, cfg, "cpu", torch.Generator().manual_seed(0))
    if opts.get("w8a8") == "scales":
        opts = dict(opts, w8a8=_scales(model))
    pipe = InferencePipeline(cfg, model, cuda_device, **opts)
    rng = np.random.default_rng(7)
    buf = (cfg.input_hw[0] + 88, cfg.input_hw[1] + 120)
    frames = [_zoo_inputs(pipe, rng, buf) for _ in range(3)]
    counters = list(prof.LAUNCH_COUNTERS)

    def launched():
        return [getattr(owner, name) for owner, name in counters]

    for data in frames:
        want = _eager(pipe, data)
        n0 = launched()
        _eager(pipe, data)
        eager = [b - a for a, b in zip(n0, launched())]
        n0 = launched()
        got = pipe.predict(*data)
        assert [b - a for a, b in zip(n0, launched())] == eager
        assert_equal(got, want)
    c = pipe.graph_counts
    assert (c["first_sighting"], c["captures"], c["replays"]) == (1, 1, 2)
    if opts.get("w8a8_fused"):
        assert fq.fused_qconv.launches > 0


def test_dmds_pass_counters_gain_the_captures_passes_on_each_replay(cuda_device):
    """The DMDS cell's program at a small size (tiny backbone, 64x192, batch 2):
    each call of the pipeline reads 2 depth and 2 motion passes, whether it
    runs eagerly, captures or replays its graph (a replay runs no Python)."""
    from cvbench import program
    from cvbench.traffic.pairs import pair_pool
    from cvm_tpu_torch.models.dmds.model import DmdsModel

    with open(ROOT / "cvbench" / "configs" / "dmds_e.json") as f:
        cfg = json.load(f)
    cfg["params"].update(input_hw=[64, 192], batch_size=2, backbone="tiny",
                         decoder_features=16, motion_features=32)
    params, model, _ = program.build(cfg, 2147490023, cuda_device)
    pipe = InferencePipeline(params, model, cuda_device, input_format="yuv420", fold_bn=True)
    mix = {"pool": 2, "buffer_hw": [128, 384], "sizes": [[125, 380], [121, 371]], "colors": 10,
           "max_objects": 12, "zoom": [1.0, 1.04], "focus": 0.1, "shift_px": 3.0}
    pairs = pair_pool(np.random.default_rng(3), mix)
    batch = {k: np.concatenate([p[k] for p in pairs]) for k in pairs[0]}
    for _ in range(4):
        d0, m0 = DmdsModel.depth_passes, DmdsModel.motion_passes
        pipe(batch)["depth"].cpu()
        assert (DmdsModel.depth_passes - d0, DmdsModel.motion_passes - m0) == (2, 2)
    c = pipe.graph_counts
    assert (c["first_sighting"], c["captures"], c["replays"]) == (1, 1, 3)
