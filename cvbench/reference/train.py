"""The plain float32 reference of CenterNet's training step from records.

Written for the benchmark from the recipe's published description (Objects
as Points, arXiv:1904.07850; BASELINE config B): JPEG decode (PIL), the
training jitter (zoom, shift, horizontal flip) and the photometric jitter
(brightness, contrast, saturation, hue as an RGB channel-rotation blend),
the boxes through the same window, the ground truth at stride 4 (Gaussian
peaks of the CornerNet radius at IoU 0.7, max over objects of a class, each
axis truncated at the radius; sub-pixel offset and box size at the integer
centres), the penalty-reduced focal loss (alpha 2, beta 4) plus L1 offset and
0.1 L1 size at the centres, the model in training mode (BatchNorm on batch
statistics), the gradients by autograd, the global-norm clip at 10 and AdamW
(b1 0.9, b2 0.999, eps 1e-8, the decay on every parameter scaled by the
learning rate, the learning rate read at the update count before it is
incremented: linear warmup from 0).

The random numbers of a step's jitter are drawn, in the recipe's order, from
the step's ``torch.Generator`` (``step_generator``), as the program's step
draws them; the records of each step are the recipe's shuffle of the train
split. ``quant`` makes every conv fake-quantized (straight-through in the
backward): the control.
"""

from __future__ import annotations

import io
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from cvbench.reference import model as M

B1, B2, EPS = 0.9, 0.999, 1e-8


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of training step ``step`` (0-based) of a run seeded ``seed``."""
    s = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def batch_ids(n_records: int, batch: int, seed: int, steps: int,
              ranks: int = 1) -> List[List[int]]:
    """The records of the first ``steps`` global batches: the train split (a
    permutation by seed 0 less its first tenth), every ``ranks``-th of it
    to each data rank, each rank's share shuffled by ``seed``; a global
    batch is the ranks' local batches in rank order."""
    train = np.random.default_rng(0).permutation(n_records)[int(n_records * 0.1):].tolist()
    local = batch // ranks
    shares = []
    for d in range(ranks):
        ids = np.array(train[d::ranks])
        np.random.default_rng(seed).shuffle(ids)
        shares.append(ids.tolist())
    return [sum((sh[k * local:(k + 1) * local] for sh in shares), []) for k in range(steps)]


def decode_jpeg(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def draws(gen: torch.Generator, n: int, aug: dict) -> Dict[str, torch.Tensor]:
    """The step's jitter numbers in the recipe's order: zoom, shift y, shift
    x, flip; brightness, contrast, saturation, hue."""
    def u(lo, hi):
        return torch.rand(n, generator=gen, device=gen.device) * (hi - lo) + lo

    d = {"zoom": u(*aug["scale_range"]), "sy": u(-aug["shift_frac"], aug["shift_frac"]),
         "sx": u(-aug["shift_frac"], aug["shift_frac"])}
    d["flip"] = torch.rand(n, generator=gen, device=gen.device) < aug["flip_prob"]
    for k in ("brightness", "contrast", "saturation", "hue"):
        d[k] = u(-aug[k], aug[k])
    return d


def _axis(n_out, src0, src_len, valid, flip, device):
    t = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) / n_out
    if flip:
        t = 1.0 - t
    src = t * src_len - 0.5 + src0
    lo = torch.floor(src)
    frac = src - lo
    lo = lo.long()
    return lo.clamp(0, valid - 1), (lo + 1).clamp(0, valid - 1), frac


def augment(rgb: torch.Tensor, d: dict, i: int, out_hw) -> tuple:
    """One (h, w, 3) uint8 image through the jitter window and the
    photometric jitter -> ((3, H, W) in [-1, 1], window (y0, x0, sh, sw, flip))."""
    h, w = rgb.shape[:2]
    oh, ow = out_hw
    hf = torch.tensor(float(h), device=rgb.device)
    wf = torch.tensor(float(w), device=rgb.device)
    base = torch.minimum(hf / oh, wf / ow)
    sh, sw = oh * base / d["zoom"][i], ow * base / d["zoom"][i]
    y0 = hf * 0.5 + d["sy"][i] * hf - sh * 0.5
    x0 = wf * 0.5 + d["sx"][i] * wf - sw * 0.5
    flip = bool(d["flip"][i])
    ya, yb, fy = _axis(oh, y0, sh, h, False, rgb.device)
    xa, xb, fx = _axis(ow, x0, sw, w, flip, rgb.device)
    p = rgb.float()
    rows = p[ya] + (p[yb] - p[ya]) * fy[:, None, None]
    img = rows[:, xa] + (rows[:, xb] - rows[:, xa]) * fx[None, :, None]      # (H, W, 3)
    img = img + d["brightness"][i] * 255.0
    img = (img - 127.5) * (1.0 + d["contrast"][i]) + 127.5
    gray = 0.299 * img[..., 0:1] + 0.587 * img[..., 1:2] + 0.114 * img[..., 2:3]
    img = gray + (img - gray) * (1.0 + d["saturation"][i])
    hue = d["hue"][i].abs()
    img = img * (1.0 - hue) + torch.roll(img, 1, dims=-1) * hue
    img = img.clamp(0.0, 255.0) / 127.5 - 1.0
    return img.permute(2, 0, 1), (y0, x0, sh, sw, flip)


def gaussian_radius(h: torch.Tensor, w: torch.Tensor, overlap: float) -> torch.Tensor:
    """CornerNet's radius: the least of the three quadratic cases."""
    b1, c1 = h + w, w * h * (1 - overlap) / (1 + overlap)
    r1 = (b1 + torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * c1, 0))) / 2
    b2, c2 = 2 * (h + w), (1 - overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp_min(b2 ** 2 - 16 * c2, 0))) / 8
    a3, b3, c3 = 4 * overlap, -2 * overlap * (h + w), (overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def targets(boxes: torch.Tensor, classes: Sequence[int], win, cfg: dict):
    """One image's source boxes (n, 4) -> heatmap (C, Hs, Ws), offset and
    size (2, Hs, Ws), mask (Hs, Ws) at the stride."""
    y0, x0, sh, sw, flip = win
    oh, ow = cfg["input_hw"]
    s, C = cfg["stride"], cfg["num_classes"]
    hs, ws = oh // s, ow // s
    dev = boxes.device
    hm = torch.zeros(C, hs, ws, device=dev)
    off = torch.zeros(2, hs, ws, device=dev)
    size = torch.zeros(2, hs, ws, device=dev)
    mask = torch.zeros(hs, ws, device=dev)
    xs = (boxes[:, 0::2] - x0) * (ow / sw)
    ys = (boxes[:, 1::2] - y0) * (oh / sh)
    if flip:
        xs = ow - xs
    bx = torch.stack([xs.amin(1), ys.amin(1), xs.amax(1), ys.amax(1)], 1) / s
    yy = torch.arange(hs, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(ws, device=dev, dtype=torch.float32)[None, :]
    for k in range(bx.shape[0]):
        cx, cy = (bx[k, 0] + bx[k, 2]) * 0.5, (bx[k, 1] + bx[k, 3]) * 0.5
        bw, bh = torch.clamp_min(bx[k, 2] - bx[k, 0], 0), torch.clamp_min(bx[k, 3] - bx[k, 1], 0)
        if not (0 <= cx < ws and 0 <= cy < hs and bw > 0 and bh > 0):
            continue
        ix, iy = int(torch.floor(cx)), int(torch.floor(cy))
        r = torch.floor(torch.clamp_min(gaussian_radius(bh, bw, cfg["min_overlap"]), 0))
        sigma = (2 * r + 1) / 6
        dy2, dx2 = (yy - iy) ** 2, (xx - ix) ** 2
        g = torch.exp(-(dy2 + dx2) / (2 * sigma * sigma + 1e-12))
        g = torch.where((dy2 <= r * r + 1e-6) & (dx2 <= r * r + 1e-6), g, torch.zeros_like(g))
        c = int(classes[k])
        hm[c] = torch.maximum(hm[c], g)
        off[:, iy, ix] = torch.stack([cx - ix, cy - iy])
        size[:, iy, ix] = torch.stack([bw, bh])
        mask[iy, ix] = 1.0
    return hm, off, size, mask


def loss(out: Dict[str, torch.Tensor], t, cfg: dict) -> torch.Tensor:
    hm, off, size, mask = t
    prob = torch.clamp(torch.sigmoid(out["heatmap"]), 1e-6, 1 - 1e-6)
    pos = (hm >= 1 - 1e-6).float()
    pos_l = -torch.log(prob) * (1 - prob) ** cfg["focal_alpha"] * pos
    neg_l = -torch.log(1 - prob) * prob ** cfg["focal_alpha"] * (1 - hm) ** cfg["focal_beta"] * (1 - pos)
    l_hm = (pos_l.sum() + neg_l.sum()) / torch.clamp_min(pos.sum(), 1.0)
    m = mask[:, None]
    n = torch.clamp_min(m.sum(), 1.0)
    l_off = (torch.abs(out["offset"] - off) * m).sum() / n
    l_size = (torch.abs(out["size"] - size) * m).sum() / n
    return cfg["weight_heatmap"] * l_hm + cfg["weight_offset"] * l_off + cfg["weight_size"] * l_size


def bn_train(w, name, x):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    g, b = w[f"{name}.weight"][None, :, None, None], w[f"{name}.bias"][None, :, None, None]
    return (x - mean) * torch.rsqrt(var + M.BN_EPS) * g + b


def train_forward(w, x, cfg, quant=None):
    """The model in training mode: BatchNorm on the batch's statistics."""
    saved = M.batchnorm
    M.batchnorm = bn_train
    try:
        return M.centernet(w, x, cfg, quant)
    finally:
        M.batchnorm = saved


def ste(quant):
    """A fake quantizer whose backward passes the gradient straight through."""
    if quant is None:
        return None

    def q(x, w, name):
        xq, wq = quant(x.detach(), w.detach(), name)
        return x + (xq - x).detach(), w + (wq - w).detach()

    return q


class Reference:
    """Three steps of the recipe from the same weights, in float32."""

    def __init__(self, weights: Dict[str, torch.Tensor], params: List[str], cfg: dict,
                 device, quant=None, rows=None):
        self.cfg, self.quant, self.device, self.rows = cfg, ste(quant), device, rows
        self.p = {n: weights[n].detach().to(device, torch.float32).clone() for n in params}
        self.fixed = {n: v.to(device) for n, v in weights.items() if n not in self.p}
        self.mu = {n: torch.zeros_like(v) for n, v in self.p.items()}
        self.nu = {n: torch.zeros_like(v) for n, v in self.p.items()}
        self.count = 0

    def lr(self, count: int) -> float:
        c = self.cfg
        warm = max(c["warmup_steps"], 1)
        if count < warm:
            return c["learning_rate"] * count / warm
        decay = max(c["total_steps"], warm + 1) - warm
        t = min(count - warm, decay)
        return c["learning_rate"] * (0.99 * 0.5 * (1 + math.cos(math.pi * t / decay)) + 0.01)

    def inputs(self, records, ids, gen):
        """The step's batch: model input (B, 3, H, W) and targets."""
        d = draws(gen, len(ids), self.cfg["aug"])
        xs, ts = [], []
        for i, r in enumerate(ids):
            meta, blobs = records.get(r)
            rgb = torch.from_numpy(decode_jpeg(bytes(blobs["jpeg"])).copy()).to(self.device)
            x, win = augment(rgb, d, i, self.cfg["input_hw"])
            xs.append(x)
            b = torch.tensor(meta["boxes"][:self.cfg["max_objects"]], dtype=torch.float32,
                             device=self.device).reshape(-1, 4)
            ts.append(targets(b, meta["classes"], win, self.cfg))
        return torch.stack(xs), tuple(torch.stack(f) for f in zip(*ts))

    def step(self, x, t):
        """One step: the loss, and the clipped gradients the optimizer got.
        With ``rows`` (a fault for the check's tests), the step sees the
        first ``rows`` of its batch only."""
        if self.rows is not None:
            x, t = x[:self.rows], tuple(f[:self.rows] for f in t)
        p = {n: v.requires_grad_(True) for n, v in self.p.items()}
        out = train_forward({**self.fixed, **p}, x, self.cfg, self.quant)
        value = loss(out, t, self.cfg)
        grads = torch.autograd.grad(value, list(p.values()))
        g = dict(zip(p, grads))
        norm = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values())).float()
        if norm >= 10.0:
            g = {n: v * (10.0 / norm) for n, v in g.items()}
        lr = self.lr(self.count)
        self.count += 1
        with torch.no_grad():
            for n, v in self.p.items():
                v.requires_grad_(False)
                self.mu[n].mul_(B1).add_(g[n], alpha=1 - B1)
                self.nu[n].mul_(B2).addcmul_(g[n], g[n], value=1 - B2)
                m_hat = self.mu[n] / (1 - B1 ** self.count)
                v_hat = self.nu[n] / (1 - B2 ** self.count)
                v.sub_(lr * (m_hat / (torch.sqrt(v_hat) + EPS) + self.cfg["weight_decay"] * v))
        return float(value.detach()), g
