"""CenterNet detection: each served request's detections against the float32
reference's decode of the same frame. Scores are compared as logits, in
units of the spread (standard deviation) of the reference's heatmap logits
over the frame, so that a frame whose peaks sit where the sigmoid is flat
counts like any other.

  * ``score_gap`` (a reading, not compared: the int8 program's errors are
    within three times the control's at some seeds): the mean over the
    sampled requests, and over the ranks 1..k, of the gap between the k-th
    best served score and the reference's k-th best.
  * ``box_gap_px`` (compared): for each served detection, the nearest
    reference peak of the same class whose score lies within ``WINDOW``
    spreads of it (two: the int8 posture's own score noise reaches a
    spread on some weights), by the largest box-coordinate difference in
    source pixels (``NO_MATCH`` where there is none); the 90th percentile
    over the sample's detections (``_w1``, ``_w3``: at other windows,
    readings only). ``python -m cvbench.control --precision int8_static``
    reads the same numbers for the reference's own int8 in the export's
    calibrated posture: the witness for how wide that posture's noise is.
    Rounding that swaps two near-equal peaks moves a detection little; a
    box or a frame that is wrong finds no close neighbour.

Neither is a maximum: the int8 program's largest errors are its
calibration's clipped outliers, and a widest gap would set them against
the control's, which are only a few times larger.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cvbench.reference.decode import decode
from cvbench.reference.model import forward, no_tf32
from cvbench.traffic.generator import frame_pool, pick, stream
from cvbench.reference.preprocess import letterbox, preprocess_yuv420

# Reference peaks within this many spreads of a served score are its candidates.
WINDOW = 2.0
WINDOWS = (1.0, 2.0, 3.0)       # the compared one and the readings beside it
NO_MATCH = 1e4


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


@torch.no_grad()
def detections(frames: List[dict], weights, cfg: dict, device, top_k: int, quant=None,
               windows=None):
    """The reference's (boxes, scores, classes, spread) of each frame: the
    best ``top_k``, and with ``windows`` every peak whose logit lies within
    ``WINDOW`` spreads below ``windows[i]``, the least served logit of frame
    i; ``spread`` is the standard deviation of the frame's heatmap logits."""
    no_tf32()
    out = []
    for i in range(0, len(frames), 8):
        part = frames[i:i + 8]
        xs, lbs = [], []
        for f in part:
            t = {k: torch.from_numpy(f[k][0]).to(device) for k in ("y", "u", "v")}
            h, w = (int(x) for x in f["image_hw"][0])
            xs.append(preprocess_yuv420(t["y"], t["u"], t["v"], h, w, cfg["input_hw"]))
            lbs.append(letterbox(h, w, *cfg["input_hw"]))
        heads = forward(weights, torch.stack(xs), cfg, quant)
        for j, lb in enumerate(lbs):
            spread = float(heads["heatmap"][j].std())
            lo = 1.0
            if windows is not None:
                lo = float(torch.sigmoid(torch.tensor(windows[i + j] - max(WINDOWS) * spread)))
            out.append((*decode(heads["heatmap"][j], heads["offset"][j], heads["size"][j],
                                cfg["stride"], top_k, lb, lo), spread))
    return out


def reference_outputs(frames: List[dict], weights, cfg: dict, device, quant=None) -> List[dict]:
    """The reference's answers in the program's format (batch axis of 1)."""
    return [{"boxes": b[None].cpu().numpy(), "scores": s[None].cpu().numpy(),
             "classes": c[None].cpu().numpy().astype(np.int32)}
            for b, s, c, _ in detections(frames, weights, cfg, device, cfg["top_k"], quant)]


def compare(samples, weights, cfg: dict, device) -> Dict[str, float]:
    k = cfg["top_k"]
    served = [{n: torch.as_tensor(np.asarray(out[n])[0], device=device) for n in out}
              for _, out in samples]
    lows = [float(_logit(o["scores"].float()).min()) for o in served]
    refs = detections([f for f, _ in samples], weights, cfg, device, k, windows=lows)
    score, box = [], {w: [] for w in WINDOWS}
    for o, (rb, rs, rc, spread) in zip(served, refs):
        sb, ss, sc = o["boxes"].float(), o["scores"].float(), o["classes"].long()
        got = _logit(torch.sort(ss, descending=True).values)
        score.append(float((got - _logit(rs[:k])).abs().mean()) / spread)
        d = (sb[:, None, :] - rb[None, :, :]).abs().amax(-1)               # (k, peaks)
        same = sc[:, None] == rc[None, :].long()
        dz = (_logit(ss)[:, None] - _logit(rs)[None, :]).abs() / spread
        for w in WINDOWS:
            box[w].append(torch.where(same & (dz <= w), d, torch.full_like(d, NO_MATCH)).amin(1))
    out = {"score_gap": float(np.mean(score))}
    for w in WINDOWS:
        b = torch.cat(box[w]).clamp_max(NO_MATCH)
        out["box_gap_px" if w == WINDOW else f"box_gap_px_w{w:g}"] = float(b.quantile(0.9))
    return out

def control(cfg: dict, mix: dict, seed: int, weights, device, quant, tmp: str, n: int):
    """The control's samples: the frames a run of ``seed`` sends, answered
    by the reference through ``quant``."""
    pool = frame_pool(stream(seed, 1), mix, cfg["num_classes"])
    frames = [pool[i] for i in pick(stream(seed, 3), range(len(pool)), n)]
    return list(zip(frames, reference_outputs(frames, weights, cfg, device, quant)))
