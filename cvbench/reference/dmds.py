"""The plain float32 reference of DMDS, BASELINE config E: depth and
ego-motion from two consecutive frames.

A frozen copy, written for the benchmark, of the two-frame model that
github.com/j-o-d-o/computer-vision-models describes (BASELINE.json configs[4])
after Li et al., *Unsupervised Monocular Depth Learning in Dynamic Scenes*,
CoRL 2020, arXiv:2010.16404. Plain ``torch`` operations in NCHW and float32,
BatchNorm in inference form, TF32 off (``no_tf32``). It imports nothing of the
program: it reads the model's flat ``state_dict`` by name (``depth.*`` and
``motion.*``), with the layers of ``reference/model.py``.

  * Depth net (``depth.*``): the residual pyramid backbone with the
    space-to-depth stem; four ``UpBlock``s ``up0`` .. ``up3`` (strides 16 to
    2) on the skips c4 .. c1. The served depth is the finest head's (``disp3``,
    one channel) logit x through
    ``1 / (1 / max_depth + (1 / min_depth - 1 / max_depth) * sigmoid(x))``,
    then a bilinear upsample (half-pixel centres, border-replicate) to the
    input's size.
  * Motion net (``motion.*``): both frames stacked on 6 channels, five
    stride-2 ConvBNs ``enc0`` .. ``enc4``, the global mean, ``fc1`` and silu,
    ``fc2`` to 6 numbers: rotation (the first three, x0.01, radians) and
    translation (x0.1).
  * Served (``serve``): frame t's depth and the forward motion (t, t+1).

Departures from arXiv:2010.16404, as the served model has them:
  * the motion net takes the RGB pair alone, without the two depth maps the
    paper stacks beside the frames;
  * the camera intrinsics are given with the data, not learned;
  * the depth net is the zoo's pyramid backbone and decoder (the paper: a
    ResNet-18 U-Net), its depth a sigmoid of inverse depth between
    ``min_depth`` and ``max_depth``; the motion net's bottleneck is ``fc1`` /
    ``fc2`` over the global mean.
What the served outputs do not need is not computed: frame t+1's depth, the
backward motion, the object-motion field (``motion.dec*``,
``motion.resmotion``) and the coarser disp heads ``disp0`` .. ``disp2``, which
the program's training reads.

``quant`` (``lowprec.py``) takes every conv's input and kernel through a fake
quantizer, as in ``reference/model.py``; ``fc1`` and ``fc2`` stay float32, as
the program computes them. A quantizer with a ``round`` method (the check's
bfloat16 floor, ``checks/dmds.py``) also rounds the two tensors the program
holds in its precision that are no conv's input: the finest disp head's sum
before its bias, and the motion net's global mean.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from cvbench.reference.model import Quant, Weights, backbone, conv, convbn, no_tf32, upblock

ROT_SCALE = 0.01
TRANS_SCALE = 0.1


def sub(w: Weights, prefix: str) -> Weights:
    """The tensors of ``w`` under ``prefix``, by their names inside it."""
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def upsample_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, H, W): bilinear, half-pixel centres, edges
    replicated."""

    def axis(n_out: int, n_in: int):
        src = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) \
            * (n_in / n_out) - 0.5
        lo = torch.floor(src)
        frac = src - lo
        lo = lo.long()
        return lo.clamp(0, n_in - 1), (lo + 1).clamp(0, n_in - 1), frac

    y0, y1, fy = axis(out_hw[0], x.shape[2])
    x0, x1, fx = axis(out_hw[1], x.shape[3])
    rows = x[:, :, y0] + (x[:, :, y1] - x[:, :, y0]) * fy[:, None]
    return rows[..., x0] + (rows[..., x1] - rows[..., x0]) * fx


def held(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    """``x`` as ``quant`` holds a tensor that is no conv's input: rounded by
    its ``round`` where it has one, else unchanged."""
    return quant.round(x) if hasattr(quant, "round") else x


def disp_logit(w: Weights, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """NCHW frames in [-1, 1] -> (B, 1, H/2, W/2): the finest disp head's logit
    (``reference/model.py::head``, its last conv's sum held before the bias)."""
    d = sub(w, "depth.")
    f = backbone(d, x, cfg["backbone"], quant)
    h = f["c5"]
    for i, skip in enumerate((f["c4"], f["c3"], f["c2"], f["c1"])):
        h = upblock(d, f"up{i}", h, skip, quant)
    h = F.silu(conv(d, "disp3.c1.conv", h, quant=quant))
    y = conv({"disp3.out.weight": d["disp3.out.weight"]}, "disp3.out", h, quant=quant)
    return held(y, quant) + d["disp3.out.bias"].float()[None, :, None, None]


def depth_net(w: Weights, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """NCHW frames in [-1, 1] -> (B, H, W) metric depth at the input's size."""
    logit = disp_logit(w, x, cfg, quant)
    min_disp, max_disp = 1.0 / cfg["max_depth"], 1.0 / cfg["min_depth"]
    depth = 1.0 / (min_disp + (max_disp - min_disp) * torch.sigmoid(logit))
    return upsample_bilinear(depth, x.shape[2:])[:, 0]


def motion_net(w: Weights, pair: torch.Tensor, quant: Quant = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW frame pair (B, 6, H, W) -> rotation (B, 3), translation (B, 3)."""
    m = sub(w, "motion.")
    h = pair
    for i in range(5):
        h = convbn(m, f"enc{i}", h, stride=2, quant=quant)
    g = held(h.mean(dim=(2, 3)), quant)
    g = F.silu(F.linear(g, m["fc1.weight"].float(), m["fc1.bias"].float()))
    out = F.linear(g, m["fc2.weight"].float(), m["fc2.bias"].float())
    return out[:, :3] * ROT_SCALE, out[:, 3:] * TRANS_SCALE


def serve(w: Weights, a: torch.Tensor, b: torch.Tensor, cfg: dict,
          quant: Quant = None) -> Dict[str, torch.Tensor]:
    """Frames t (``a``) and t+1 (``b``), NCHW in [-1, 1] -> what the program
    serves: ``depth`` (B, H, W) of frame t, ``rotation`` and ``translation``
    (B, 3) from t to t+1. Sets TF32 off."""
    no_tf32()
    rot, trans = motion_net(w, torch.cat([a, b], dim=1), quant)
    return {"depth": depth_net(w, a, cfg, quant), "rotation": rot, "translation": trans}


_FLOPS: Dict[tuple, float] = {}


def served_flops(weights: Weights, cfg: dict) -> float:
    """FLOPs of ``serve`` for one pair, as ``FlopCounterMode`` counts them
    (convolutions and matrix products), on meta tensors; counted once per
    shape in a process."""
    h, w = cfg["input_hw"]
    key = (cfg["backbone"], h, w, cfg["decoder_features"], cfg["motion_features"])
    if key not in _FLOPS:
        meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
                for k, v in weights.items()}
        x = torch.empty((1, 3, h, w), dtype=torch.float32, device="meta")
        with FlopCounterMode(display=False) as counter:
            serve(meta, x, x, cfg)
        _FLOPS[key] = float(counter.get_total_flops())
    return _FLOPS[key]
