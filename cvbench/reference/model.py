"""The plain float32 reference of the two served architectures.

A frozen copy, written for the benchmark, of the residual pyramid backbone
with the space-to-depth stem, the CenterNet neck and heads, and the semantic
segmentation decoder and head, as the models' published description gives
them (BASELINE.json configs A and B of github.com/j-o-d-o/computer-vision-models).
Plain ``torch`` operations in NCHW and float32, BatchNorm in inference form
(running statistics), TF32 off. It imports nothing of the program: it takes a
flat ``{name: tensor}`` weight dict, the names of the model's ``state_dict``,
which the benchmark hands to both sides.

Layers:
  * conv: TensorFlow ``SAME`` padding (a stride-2 conv on an even size pads 0
    before and 1 after), an optional bias;
  * ConvBN: conv, BatchNorm (eps 1e-5), silu (or none);
  * ResBlock: ``silu(x + c2(c1(x)))``, c2 without activation;
  * UpBlock: nearest 2x upsample, concat with the skip, two ConvBNs;
  * Head: 3x3 conv with bias + silu, 1x1 conv with bias.

``quant`` (see ``lowprec.py``) makes every conv take its input and weights
through a fake quantizer, ``quant(x, weight, name)``: the control that
computes in a lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

# name -> (stage widths c1..c5, blocks per stage c2..c5)
BACKBONES = {
    "tiny": ((16, 32, 64, 128, 256), (1, 1, 2, 2)),
    "small": ((32, 64, 128, 256, 512), (1, 2, 2, 2)),
    "base": ((32, 64, 128, 256, 512), (2, 3, 4, 2)),
}
BN_EPS = 1e-5

Weights = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor, torch.Tensor, str], tuple]]


def no_tf32() -> None:
    """Float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _same(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(w: Weights, name: str, x: torch.Tensor, stride: int = 1, quant: Quant = None):
    weight = w[f"{name}.weight"].float()
    if quant is not None:
        x, weight = quant(x, weight, name)
    k = weight.shape[-1]
    pt, pb = _same(x.shape[2], k, stride)
    pl, pr = _same(x.shape[3], k, stride)
    y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, stride=stride)
    bias = w.get(f"{name}.bias")
    return y if bias is None else y + bias.float()[None, :, None, None]


def batchnorm(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    g, b = w[f"{name}.weight"].float(), w[f"{name}.bias"].float()
    m, v = w[f"{name}.running_mean"].float(), w[f"{name}.running_var"].float()
    s = g / torch.sqrt(v + BN_EPS)
    return (x - m[None, :, None, None]) * s[None, :, None, None] + b[None, :, None, None]


def convbn(w, name, x, stride=1, act=True, quant: Quant = None):
    y = batchnorm(w, f"{name}.bn", conv(w, f"{name}.conv", x, stride, quant))
    return F.silu(y) if act else y


def resblock(w, name, x, quant: Quant = None):
    h = convbn(w, f"{name}.c2", convbn(w, f"{name}.c1", x, quant=quant), act=False, quant=quant)
    if f"{name}.proj.conv.weight" in w:
        x = convbn(w, f"{name}.proj", x, act=False, quant=quant)
    return F.silu(x + h)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel (dy * 2 + dx) * C + c."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, 4 * C, H // 2, W // 2)


def up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def backbone(w: Weights, x: torch.Tensor, kind: str, quant: Quant = None) -> Dict[str, torch.Tensor]:
    """NCHW input -> features c1..c5 at strides 2..32 (space-to-depth stem)."""
    _, depths = BACKBONES[kind]
    x = convbn(w, "backbone.stem", space_to_depth(x), quant=quant)
    feats = {"c1": x}
    for i, d in enumerate(depths):
        x = convbn(w, f"backbone.down{i + 2}", x, stride=2, quant=quant)
        for j in range(d):
            x = resblock(w, f"backbone.s{i + 2}b{j}", x, quant)
        feats[f"c{i + 2}"] = x
    return feats


def upblock(w, name, x, skip, quant: Quant = None):
    x = torch.cat([up2(x), skip], dim=1)
    return convbn(w, f"{name}.c2", convbn(w, f"{name}.c1", x, quant=quant), quant=quant)


def head(w, name, x, quant: Quant = None):
    return conv(w, f"{name}.out", F.silu(conv(w, f"{name}.c1.conv", x, quant=quant)), quant=quant)


def centernet(w: Weights, x: torch.Tensor, cfg: dict, quant: Quant = None) -> Dict[str, torch.Tensor]:
    """NCHW input in [-1, 1] -> NCHW heads heatmap (logits), offset, size."""
    f = backbone(w, x, cfg["backbone"], quant)
    skips = {16: f["c4"], 8: f["c3"], 4: f["c2"], 2: f["c1"]}
    h, s, i = f["c5"], 32, 0
    while s > cfg["stride"]:
        s //= 2
        h = upblock(w, f"up{i}", h, skips[s], quant)
        i += 1
    return {"heatmap": head(w, "hm", h, quant), "offset": head(w, "off", h, quant),
            "size": head(w, "size", h, quant)}


def semseg(w: Weights, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """NCHW input in [-1, 1] -> NCHW class logits at the input's size."""
    f = backbone(w, x, cfg["backbone"], quant)
    h = upblock(w, "up16", f["c5"], f["c4"], quant)
    h = upblock(w, "up8", h, f["c3"], quant)
    h = upblock(w, "up4", h, f["c2"], quant)
    h = upblock(w, "up2", h, f["c1"], quant)
    return up2(head(w, "seg", h, quant))


def forward(w: Weights, x: torch.Tensor, cfg: dict, quant: Quant = None):
    """The model that ``cfg["model"]`` names."""
    if cfg["model"] == "centernet":
        return centernet(w, x, cfg, quant)
    if cfg["model"] == "semseg":
        return semseg(w, x, cfg, quant)
    raise ValueError(f"no reference for model {cfg['model']!r}")

