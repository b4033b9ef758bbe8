"""The frame-pair cell (``dmds_e.infer_pairs_b8``, runner
``closed_loop_pairs``) on the CPU at a tiny size: a sound run reads correct
and counts its network passes, and each fault planted under the timed path
reads not correct against the cell's committed limits: the rows of a batch
answered in a rotated order, frames t and t+1 swapped, the pose of another
pair, frame t+1's depth served for frame t's; the fp8 control too. Also the
FLOPs the runner counts (the served outputs' only), the pair generator, and
the ``net_passes_per_call.infer`` reader."""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cvbench import control, run
from cvbench.reference.dmds import served_flops
from cvbench.traffic.pairs import ego_step, pair_pool, yuv420

CPU = torch.device("cpu")
SEED = 2 ** 31 + 23
CELL = "dmds_e.infer_pairs_b8"
# the tiny backbone and decoder, the motion net at its published width
PARAMS = {"input_hw": [64, 192], "batch_size": 8, "backbone": "tiny", "decoder_features": 16,
          "num_scales": 1, "min_depth": 0.1, "max_depth": 80.0, "motion_features": 128,
          "predict_object_motion": True}
# the heads scaled as the cell scales them, set for this size: a tiny body's
# disp logits sit elsewhere than the published one's
TINY = {"config": {"params": PARAMS},
        "mix": {"pool": 16, "buffer_hw": [128, 384], "sizes": [[125, 380], [126, 379], [121, 370]],
                "shift_px": 3.0,
                "weights": {"gain": {"depth.disp3.out.weight": 32.0, "motion.fc2.weight": 500.0},
                            "shift": {"depth.disp3.out.bias": -3.0}}}}


def _tiny_spec(cell_spec):
    spec = cell_spec(CELL)
    return dict(spec, config=dict(spec["config"], **TINY["config"]),
                mix=dict(spec["mix"], **TINY["mix"]))


def _run(cell_spec):
    with tempfile.TemporaryDirectory() as tmp:
        out = run.run_cell(cell_spec(CELL), SEED, 1.0, False, CPU, tmp, TINY)
    return out["correct"], {n: v for n, v, _ in out["compared"]}, out


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def limits(cell_spec):
    return cell_spec(CELL)["limits"]


def test_a_sound_run_is_correct(cell_spec, limits):
    ok, got, out = _run(cell_spec)
    assert ok, got
    assert set(got) == set(limits)
    c = out["counters"]
    assert c["frames"] == out["attempted"] == 8 * c["calls"]
    assert c["graph_counts"]["cpu"] == c["calls"]         # a CPU pipeline never captures
    assert c["net_passes"] == 4 * c["calls"]               # depth on t and t+1, motion both ways
    assert len(out["samples"]) == 16
    for pair, served in out["samples"]:
        assert pair["y_t1"].shape == pair["y"].shape == (1, 128, 384)
        assert served["depth"].shape == (1, 64, 192, 1) and served["rotation"].shape == (1, 3)


def _wrap_call(monkeypatch, change):
    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    call = InferencePipeline.__call__
    monkeypatch.setattr(InferencePipeline, "__call__", lambda self, batch: change(call, self, batch))


def test_rows_answered_in_a_rotated_order(monkeypatch, cell_spec, limits):
    _wrap_call(monkeypatch, lambda call, self, batch: {
        k: torch.roll(v, 1, 0) for k, v in call(self, batch).items()})
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["depth_log_gap"] > limits["depth_log_gap"], got
    assert got["pose_gap"] > limits["pose_gap"], got


def test_frames_t_and_t1_swapped(monkeypatch, cell_spec, limits):
    def swapped(call, self, batch):
        b = dict(batch)
        for k in ("y", "u", "v"):
            b[k], b[k + "_t1"] = batch[k + "_t1"], batch[k]
        return call(self, b)

    _wrap_call(monkeypatch, swapped)
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["depth_log_gap"] > limits["depth_log_gap"], got
    assert got["pose_gap"] > limits["pose_gap"], got


def test_the_pose_of_another_pair(monkeypatch, cell_spec, limits):
    _wrap_call(monkeypatch, lambda call, self, batch: {
        k: torch.roll(v, 1, 0) if k != "depth" else v for k, v in call(self, batch).items()})
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["pose_gap"] > limits["pose_gap"], got


def test_frame_t1s_depth_served_for_frame_ts(monkeypatch, cell_spec, limits):
    import cvm_tpu_torch.infer.pipeline as pl

    post = pl.postprocess
    monkeypatch.setattr(pl, "postprocess", lambda cfg, out, *a: post(
        cfg, dict(out, depth_a=out["depth_b"]), *a))
    ok, got, _ = _run(cell_spec)
    assert not ok
    assert got["depth_log_gap"] > limits["depth_log_gap"], got


def test_the_fp8_control_fails_a_limit(cell_spec, limits):
    got = control.readings(_tiny_spec(cell_spec), SEED, CPU, "fp8_e4m3", 16)
    ok, _ = run.compare(got, limits)
    assert not ok, got


def _program_flops(params: dict, run_model) -> float:
    from cvm_tpu_torch.models.dmds.model import DmdsModel
    from cvm_tpu_torch.models.dmds.params import DmdsParams

    p = DmdsParams(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()})
    with torch.device("meta"):
        model = DmdsModel(p).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        run_model(model, p)
    return float(counter.get_total_flops())


def test_flops_per_frame_counts_the_served_outputs_only(cell_spec):
    """The runner's FLOPs per pair: below the program's whole forward (both
    depth passes, both motion passes with the object-motion decoders), and
    equal to the program's depth pass on frame t without the coarse disp heads
    plus its motion encoder through ``fc2``."""
    from cvm_tpu_torch.models.dmds.model import MotionNet

    h, w = PARAMS["input_hw"]
    pair = torch.empty(1, h, w, 6, device="meta")
    full = _program_flops(PARAMS, lambda m, p: m(pair))

    def served(m, p):
        m.depth(pair[..., :3])
        MotionNet(dataclasses.replace(p, predict_object_motion=False)).to("meta")(pair)

    def coarse_heads(m, p):
        widths = (4 * p.decoder_features, 2 * p.decoder_features, 2 * p.decoder_features)
        for i, (s, c) in enumerate(zip((16, 8, 4), widths)):
            getattr(m.depth, f"disp{i}")(torch.empty(1, h // s, w // s, c, device="meta"))

    want = _program_flops(PARAMS, served) - _program_flops(PARAMS, coarse_heads)
    spec = _tiny_spec(cell_spec)
    from cvbench import program

    _, model, weights = program.build(spec["config"], 1, CPU)
    got = served_flops(weights, program.ref_cfg(spec["config"]))
    assert got == want and got < 0.6 * full, (got, want, full)


def test_pairs_share_a_size_and_move_forward():
    mix = dict(TINY["mix"], pool=6, colors=10, max_objects=12, zoom=[1.0, 1.04], focus=0.1)
    a, b = pair_pool(np.random.default_rng(5), mix), pair_pool(np.random.default_rng(5), mix)
    for p, q in zip(a, b):
        assert all(np.array_equal(p[k], q[k]) for k in p)       # the seed makes the pool
        h, w = (int(x) for x in p["image_hw"][0])
        assert [h, w] in mix["sizes"]
        assert p["u"].shape == p["u_t1"].shape == (1, 64, 192)
        assert not np.array_equal(p["y"], p["y_t1"])
        assert (p["y"][0, h:] == 0).all() and (p["y"][0, :, w:] == 0).all()
        assert (p["u_t1"][0, (h + 1) // 2:] == 128).all()
    rgb = np.random.default_rng(0).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    y, u, v = yuv420(rgb)
    assert y.shape == (7, 9) and u.shape == v.shape == (4, 5)
    still = dict(mix, zoom=[1.0, 1.0], shift_px=0.0, focus=0.0)
    assert np.array_equal(ego_step(np.random.default_rng(1), rgb, still), rgb)


def test_net_passes_per_call_reads_the_windows_counts():
    read = run.metric_reader("net_passes_per_call.infer")

    def ctx(counters):
        return run.Context(trace=None, counters=counters, peak=None, card="cpu")

    assert read(ctx({"net_passes": 400, "calls": 100})) == pytest.approx(4.0)
    assert read(ctx({"calls": 100})) is None               # a program that counts no passes
    assert read(ctx({"net_passes": 0, "calls": 0})) is None
