"""DMDS in a bfloat16 posture: each served pair's depth and ego-motion against
the float32 reference (``reference/dmds.py``) on the same planes, in units of
the bfloat16 floor: the same reference computed in bfloat16 (``Bf16Floor``)
against the float32 one, on the same sample.

  * ``depth_log_gap`` (compared): per pair, the ``DEPTH_Q`` quantile over the
    pixels of frame t of |ln d_served - ln d_reference|; the largest over the
    sample, over the floor's (the root mean square over the sample of the
    same quantile of the bfloat16 reference). A log gap is a relative depth
    error, the same at 2 m as at 50 m, as depth metrics (abs rel, delta <
    1.25) read it. The quantile, not the largest pixel, because the largest
    is where a logit lies on the edge of a bilinear tap or of the letterbox;
    the 1% it leaves out are 1,229 pixels of a 192x640 map, so a wrong map
    cannot hide there.
  * ``pose_gap`` (compared): per pair, the distance between the served and
    the reference rotation over the floor's (the root mean square over the
    sample of the bfloat16 reference's distance), and alike the translation;
    the root mean square of the two; the largest over the sample. A pose that
    belongs to another pair reads the pairs' spread in those units.

Both units follow what sets a bfloat16 error's size, which differs about
tenfold from seed to seed (how far the disp head's sum and the motion net's
global mean lie from 0 against how much they vary): a pair at the floor
reads about 1 on every seed, and a computation a precision below (the fp8
``control``) about 2^4 times that. Each is a largest over the sample: the
program's own errors are bfloat16 rounding, bounded on every pair, and a
wrong row of a batch (one pair in eight) is then one sampled pair's numbers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cvbench.reference.dmds import serve
from cvbench.reference.preprocess import preprocess_yuv420
from cvbench.traffic.generator import pick, stream
from cvbench.traffic.pairs import pair_pool

DEPTH_Q = 0.99
FLOOR_EPS = 1e-12


class Bf16Floor:
    """The reference's bfloat16 posture: every conv's input and kernel, and
    (``round``) the two tensors ``reference/dmds.py`` holds beside them,
    rounded to bfloat16; sums in float32, as the card's bfloat16 convs take
    them."""

    def __call__(self, x: torch.Tensor, w: torch.Tensor, name: str = ""):
        return self.round(x), self.round(w)

    @staticmethod
    def round(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).float()


def _frame(pair: dict, suffix: str, hw, device) -> torch.Tensor:
    t = {k: torch.from_numpy(pair[k + suffix][0]).to(device) for k in ("y", "u", "v")}
    h, w = (int(x) for x in pair["image_hw"][0])
    return preprocess_yuv420(t["y"], t["u"], t["v"], h, w, hw)


@torch.no_grad()
def reference_outputs(pairs: List[dict], weights, cfg: dict, device, quant=None) -> List[dict]:
    """The reference's answers in the program's format, each with a batch
    axis of 1: ``depth`` (1, H, W, 1), ``rotation`` and ``translation``
    (1, 3); 8 pairs a forward."""
    out = []
    for i in range(0, len(pairs), 8):
        part = pairs[i:i + 8]
        a = torch.stack([_frame(p, "", cfg["input_hw"], device) for p in part])
        b = torch.stack([_frame(p, "_t1", cfg["input_hw"], device) for p in part])
        res = serve(weights, a, b, cfg, quant)
        for j in range(len(part)):
            out.append({"depth": res["depth"][j, None, :, :, None].cpu().numpy(),
                        "rotation": res["rotation"][j, None].cpu().numpy(),
                        "translation": res["translation"][j, None].cpu().numpy()})
    return out


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _log_gaps(outs: List[dict], refs: List[dict]) -> torch.Tensor:
    """Per pair, the ``DEPTH_Q`` quantile of |ln d - ln d_reference|."""
    return torch.stack([torch.quantile((torch.log(_t(o["depth"]).reshape(-1))
                                        - torch.log(_t(r["depth"]).reshape(-1))).abs(), DEPTH_Q)
                        for o, r in zip(outs, refs)])


def _gaps(outs: List[dict], refs: List[dict], key: str) -> torch.Tensor:
    """Per pair, the distance of ``key`` (a 3-vector) from the reference's."""
    return torch.stack([(_t(o[key]) - _t(r[key])).reshape(3).norm() for o, r in zip(outs, refs)])


def _rms(v: torch.Tensor) -> float:
    return max(float(v.pow(2).mean().sqrt()), FLOOR_EPS)


def readings(served: List[dict], refs: List[dict], floors: List[dict]) -> Dict[str, float]:
    """The compared numbers of served outputs against the reference's, pair
    by pair, in units of the bfloat16 floor's (each a dict of arrays with a
    batch axis of 1)."""
    depth = _log_gaps(served, refs) / _rms(_log_gaps(floors, refs))
    pose = sum((_gaps(served, refs, k) / _rms(_gaps(floors, refs, k))) ** 2
               for k in ("rotation", "translation")) / 2
    return {"depth_log_gap": float(depth.max()), "pose_gap": float(pose.sqrt().max())}


def compare(samples, weights, cfg: dict, device) -> Dict[str, float]:
    pairs = [p for p, _ in samples]
    refs = reference_outputs(pairs, weights, cfg, device)
    floors = reference_outputs(pairs, weights, cfg, device, Bf16Floor())
    return readings([out for _, out in samples], refs, floors)


def control(cfg: dict, mix: dict, seed: int, weights, device, quant, tmp: str, n: int):
    """The control's samples: the pairs a run of ``seed`` sends, answered by
    the reference through ``quant``."""
    pool = pair_pool(stream(seed, 1), mix)
    pairs = [pool[i] for i in pick(stream(seed, 3), range(len(pool)), n)]
    return list(zip(pairs, reference_outputs(pairs, weights, cfg, device, quant)))
