"""Semantic segmentation: each served class map against the float32
reference's logits of the same frame.

``class_gap``: for each sampled frame, the widest gap, over its pixels, by
which the reference's logit of the served class lies below the reference's
best logit there (0 where the served class is the reference's best); the
mean of these over the frames. It is the served-token rule of a language
model, per pixel: rounding that swaps two near-equal classes costs little,
a wrong answer costs the whole gap. The mean over frames steadies a number
that one frame's nearest tie would otherwise set.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cvbench.reference.model import forward, no_tf32
from cvbench.traffic.generator import frame_pool, pick, stream
from cvbench.reference.preprocess import preprocess_yuv420


def _input(frame: dict, hw, device) -> torch.Tensor:
    t = {k: torch.from_numpy(frame[k][0]).to(device) for k in ("y", "u", "v")}
    h, w = (int(x) for x in frame["image_hw"][0])
    return preprocess_yuv420(t["y"], t["u"], t["v"], h, w, hw)[None]


@torch.no_grad()
def logits(frame: dict, weights, cfg: dict, device, quant=None) -> torch.Tensor:
    no_tf32()
    return forward(weights, _input(frame, cfg["input_hw"], device), cfg, quant)[0]


def reference_outputs(frames: List[dict], weights, cfg: dict, device, quant=None) -> List[dict]:
    """The reference's answers in the program's format: ``class_map`` (1, H, W)."""
    return [{"class_map": logits(f, weights, cfg, device, quant).argmax(0)[None].cpu().numpy()}
            for f in frames]


def compare(samples, weights, cfg: dict, device) -> Dict[str, float]:
    gaps = []
    for frame, out in samples:
        ref = logits(frame, weights, cfg, device)                       # (C, H, W)
        served = torch.as_tensor(np.asarray(out["class_map"])[0], device=device).long()
        got = ref.gather(0, served[None])[0]
        gaps.append(float((ref.amax(0) - got).max()))
    return {"class_gap": float(np.mean(gaps))}


def control(cfg: dict, mix: dict, seed: int, weights, device, quant, tmp: str, n: int):
    """The control's samples: the frames a run of ``seed`` sends, answered
    by the reference through ``quant``."""
    pool = frame_pool(stream(seed, 1), mix, cfg["num_classes"])
    frames = [pool[i] for i in pick(stream(seed, 3), range(len(pool)), n)]
    return list(zip(frames, reference_outputs(frames, weights, cfg, device, quant)))
