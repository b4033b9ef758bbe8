"""CenterNet config B's serving path at its published batch of 8, on the CPU
at a tiny size (``backbone="tiny"``, 64x64 input, 5 classes, top-k 10):
planar YUV420 frames of eight different source sizes through
``InferencePipeline(input_format="yuv420", fold_bn=True)``, and a short
batch of 3 that ``__call__`` pads to 8, against the benchmark's plain
float32 reference (``cvbench/reference``: letterbox, preprocess, forward,
decode) on seeded weights whose heads are scaled as the benchmark's cell
scales them. Also the ``cvm.infer.decode`` span: inside
``cvm.infer.postprocess`` under a recording profiler, never entered
without one. No JAX here: the reference is the benchmark's.

The program computes in bfloat16, the reference in float32, so the two are
compared as the cell's check compares them (``cvbench/checks/
centernet_dense.py``): each served detection against the reference pixel
of its class that gives its box and its score, and every clear reference
peak served.
"""

import json

import numpy as np
import pytest
import torch

from cvbench import program
from cvbench.reference.decode import decode
from cvbench.reference.model import forward
from cvbench.reference.preprocess import letterbox, preprocess_yuv420
from cvbench.traffic.generator import rgb_to_yuv420, scene
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.utils import prof

CPU = torch.device("cpu")
CLASSES, TOP_K = 5, 10
CFG = {"model": "centernet",
       "program": {"params": "cvm_tpu_torch.models.centernet.params:CenternetParams",
                   "model": "cvm_tpu_torch.models.centernet.model:CenterNet"},
       "params": {"input_hw": [64, 64], "batch_size": 8, "num_classes": CLASSES, "stride": 4,
                  "backbone": "tiny", "neck_features": 32, "head_features": 16,
                  "top_k": TOP_K},
       # the cell's head scaling (cvbench/traffic/closed_loop_coco_b8.json): peaks
       # where a body of random weights would give a nearly flat heatmap
       "weights": {"gain": {"hm.out.weight": 25.0, "off.out.weight": 5.0,
                            "size.out.weight": 100.0},
                   "shift": {"size.out.bias": 6.0}, "balance": ["hm.out.bias"]}}
# eight source sizes (even, as YUV420 needs), wide and tall, in one buffer
SIZES = [(40, 64), (64, 40), (50, 50), (62, 30), (30, 62), (58, 46), (36, 52), (64, 64)]
BUFFER = (72, 80)
KEYS = ("boxes", "scores", "classes")

# Tolerances. The program rounds every activation and the heads' outputs to
# bfloat16 (8 significant bits); at this size its largest score error is
# about 0.05 of the frame's logit spread and its largest box error 0.15 px,
# where the reference computed in fp8 e4m3 (3 bits) errs by about 0.5
# spreads and 2 px. Each tolerance sits between, with room on both sides.
SCORE_TOL = 0.25      # spreads of the reference's heatmap logits
BOX_TOL_PX = 1.0      # source pixels
# A bfloat16 heatmap rounds neighbouring pixels to one value, and the 3x3
# max-pool keeps both: a served peak may stand one output pixel (4 input
# pixels, 6.25 source pixels at this scale) from the reference's.
TWIN_PX = 8.0
MARGIN = 0.25         # spreads above the least served score: a peak that must be served
LOGIT_MAX = float(np.log(1 - 1e-6) - np.log(1e-6))


def _frames(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SIZES:
        y, u, v = rgb_to_yuv420(scene(rng, h, w, CLASSES, 6))
        yb = np.zeros((1,) + BUFFER, np.uint8)
        ub = np.full((1, BUFFER[0] // 2, BUFFER[1] // 2), 128, np.uint8)
        vb = ub.copy()
        yb[0, :h, :w], ub[0, :h // 2, :w // 2], vb[0, :h // 2, :w // 2] = y, u, v
        out.append({"y": yb, "u": ub, "v": vb, "image_hw": np.array([[h, w]], np.int32)})
    return out


def _batch(frames):
    return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}


def _setup(seed: int):
    params, model, weights = program.build(CFG, seed, CPU)
    pipe = InferencePipeline(params, model, CPU, input_format="yuv420", fold_bn=True)
    return pipe, weights


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.float().clamp(1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


@torch.no_grad()
def _reference(frame: dict, weights):
    """The reference's heads of one frame, its letterbox, and every pixel's
    box in source pixels (``reference/decode.py``'s arithmetic)."""
    rc = program.ref_cfg(CFG)
    t = {k: torch.from_numpy(frame[k][0]) for k in ("y", "u", "v")}
    h, w = (int(x) for x in frame["image_hw"][0])
    heads = {k: v[0] for k, v in forward(weights, preprocess_yuv420(
        t["y"], t["u"], t["v"], h, w, rc["input_hw"])[None], rc).items()}
    lb = letterbox(h, w, *rc["input_hw"])
    _, H, W = heads["offset"].shape
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    s = rc["stride"]
    cx, cy = (px + heads["offset"][0]) * s, (py + heads["offset"][1]) * s
    bw, bh = heads["size"][0] * s, heads["size"][1] * s
    sx, sy = lb.w / lb.new_w, lb.h / lb.new_h
    boxes = torch.stack([(cx - bw * 0.5 - lb.x0) * sx, (cy - bh * 0.5 - lb.y0) * sy,
                         (cx + bw * 0.5 - lb.x0) * sx, (cy + bh * 0.5 - lb.y0) * sy], -1)
    return heads, lb, boxes.reshape(H * W, 4)


def _assert_matches(served: dict, frame: dict, weights):
    """Each served detection is a pixel of the reference's maps of its
    class (score and box within tolerance), and every reference peak
    clearly inside the served range is served."""
    heads, lb, boxes = _reference(frame, weights)
    logits = heads["heatmap"].reshape(CLASSES, -1).clamp(-LOGIT_MAX, LOGIT_MAX)
    spread = float(heads["heatmap"].std())
    sb, sc = served["boxes"].float(), served["classes"].long()
    sl = _logit(served["scores"])
    assert served["classes"].dtype == torch.int32 and bool(((sc >= 0) & (sc < CLASSES)).all())
    z = (sl[:, None] - logits[sc]).abs() / spread                        # (K, pixels)
    d = (sb[:, None, :] - boxes[None]).abs().amax(-1)
    box_gap = torch.where(z <= SCORE_TOL, d, torch.full_like(d, 1e4)).amin(1)
    assert float(box_gap.max()) <= BOX_TOL_PX, box_gap
    floor = float(sl.min()) + MARGIN * spread
    rb, rs, rcls = decode(heads["heatmap"], heads["offset"], heads["size"], CFG["params"]["stride"],
                          1, lb, float(torch.sigmoid(torch.tensor(floor))))
    keep = _logit(rs) >= floor
    rb, rl, rcls = rb[keep], _logit(rs[keep]), rcls[keep].long()
    assert len(rl) >= 1
    hit = ((rb[:, None, :] - sb[None]).abs().amax(-1) <= TWIN_PX) \
        & ((rl[:, None] - sl[None]).abs() / spread <= SCORE_TOL) & (rcls[:, None] == sc[None])
    assert bool(hit.any(1).all()), (rb, rl, rcls)


@pytest.mark.parametrize("seed", [1, 2])
def test_a_batch_of_eight_sizes_matches_the_reference(seed):
    pipe, weights = _setup(seed)
    frames = _frames(seed)
    out = pipe(_batch(frames))
    assert {k: tuple(out[k].shape) for k in KEYS} == {
        "boxes": (8, TOP_K, 4), "scores": (8, TOP_K), "classes": (8, TOP_K)}
    for i, f in enumerate(frames):
        _assert_matches({k: out[k][i] for k in KEYS}, f, weights)


def test_a_short_batch_is_padded_and_sliced():
    pipe, weights = _setup(3)
    frames = _frames(3)
    full = pipe(_batch(frames))
    short = pipe(_batch(frames[:3]))
    assert {k: tuple(short[k].shape[:1]) for k in KEYS} == dict.fromkeys(KEYS, (3,))
    for k in KEYS:   # the padding rows change nothing of the rows served
        assert torch.equal(short[k], full[k][:3]), k
    for i in range(3):
        _assert_matches({k: short[k][i] for k in KEYS}, frames[i], weights)


def _ranges(path):
    events = json.load(open(path))["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("cvm.infer.")), key=lambda e: e["ts"])


def test_the_decode_span_opens_inside_the_postprocess(tmp_path):
    pipe, _ = _setup(4)
    batch = _batch(_frames(4))
    plain = pipe(batch)
    with prof.trace(str(tmp_path / "tr")):
        traced = pipe(batch)
    for k in KEYS:
        assert torch.equal(plain[k], traced[k]), k
    spans = _ranges(tmp_path / "tr" / "trace.json")
    names = [e["name"] for e in spans]
    assert names.count("cvm.infer.decode") == 1 and names.count("cvm.infer.postprocess") == 1
    post = spans[names.index("cvm.infer.postprocess")]
    dec = spans[names.index("cvm.infer.decode")]
    assert post["ts"] <= dec["ts"] and dec["ts"] + dec["dur"] <= post["ts"] + post["dur"]


def test_no_decode_span_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    pipe, _ = _setup(5)
    batch = _batch(_frames(5))
    pipe(batch)
    assert entered == []
    with torch.profiler.profile():
        pipe(batch)
    assert entered.count("cvm.infer.decode") == 1
    assert entered.index("cvm.infer.postprocess") < entered.index("cvm.infer.decode")
