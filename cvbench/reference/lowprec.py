"""Fake quantizers for the control: the reference computed in the precision
below the one the configuration states (fp8 e4m3 below bfloat16, int4
below int8). Symmetric, per-tensor activations at their own maximum (no
clipping), per-output-channel weights; every conv's input and kernel pass
through it. A quantizer is called ``quant(x, weight, name)`` with the conv's
name.

``StaticInt8`` is a witness, not a control: the reference's own int8 in the
posture an int8 serving export takes (static per-conv input scales
calibrated on a fixed set of synthetic scenes, inputs beyond them clipped),
to tell whether an int8 program's errors on given weights are the posture's
or the program's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def fake_quant(bits: int):
    """``quant(x, w, name) -> (x, w)`` rounded onto ``bits``-bit symmetric grids."""
    q = float(2 ** (bits - 1) - 1)

    def quant(x: torch.Tensor, w: torch.Tensor, name: str = ""):
        sx = x.abs().amax().clamp_min(1e-12) / q
        sw = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12) / q
        return torch.round(x / sx).clamp(-q, q) * sx, torch.round(w / sw).clamp(-q, q) * sw

    return quant


def fake_fp8():
    """``quant(x, w, name) -> (x, w)`` rounded to float8 e4m3, each tensor (each
    output channel of ``w``) scaled so that its maximum is e4m3's largest
    finite value, 448."""
    top = 448.0

    def quant(x: torch.Tensor, w: torch.Tensor, name: str = ""):
        sx = x.abs().amax().clamp_min(1e-12) / top
        sw = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12) / top
        f8 = torch.float8_e4m3fn
        return (x / sx).to(f8).float() * sx, (w / sw).to(f8).float() * sw

    return quant


def _percentile(x: torch.Tensor, q: float) -> float:
    """numpy's linear-method percentile of ``x``, sorted on its device."""
    s = x.flatten().sort().values
    pos = q / 100.0 * (s.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


class StaticInt8:
    """Int8 with static input scales: ``calibrate`` runs the float32
    reference over calibration inputs and keeps, per conv, the largest over
    the inputs of the ``percentile`` of |input|, over 127; then each conv's
    input is rounded onto that grid and clipped to +-127 steps, its kernel
    per output channel at its own maximum."""

    def __init__(self, percentile: float = 99.9):
        self.percentile = percentile
        self.scales: Dict[str, float] = {}
        self.calibrating = False

    def __call__(self, x: torch.Tensor, w: torch.Tensor, name: str):
        if self.calibrating:
            v = _percentile(x.abs(), self.percentile) / 127.0 + 1e-12
            self.scales[name] = max(self.scales.get(name, 0.0), v)
            return x, w
        sx = self.scales[name]
        sw = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12) / 127.0
        return (torch.round(x / sx).clamp(-127, 127) * sx,
                torch.round(w / sw).clamp(-127, 127) * sw)

    @torch.no_grad()
    def calibrate(self, weights, cfg: dict, device, pad_hw) -> None:
        """Scales from ``calibration_inputs`` through the reference."""
        from cvbench.reference.model import forward, no_tf32

        no_tf32()
        self.calibrating = True
        try:
            for x in calibration_inputs(cfg, pad_hw, device):
                forward(weights, x, cfg, self)
        finally:
            self.calibrating = False


# The calibration set of an int8 serving export: three batches of two
# synthetic scenes from numpy's default_rng(0) (a noise background and 1-8
# rectangles in one of ten class colours), each drawn at 70-100% of the
# padded buffer, letterboxed into the model input as RGB. The draws follow
# the scene generator that the export calibrates on, in the same order.
CLASS_COLORS = np.array(
    [(220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40), (220, 40, 220),
     (40, 220, 220), (240, 140, 20), (140, 20, 240), (20, 240, 140), (180, 180, 180)],
    np.uint8)


def calibration_scene(rng: np.random.Generator, pad_hw, num_classes: int,
                      max_objects: int = 8) -> np.ndarray:
    """One (H, W, 3) uint8 scene of the calibration set."""
    hm, wm = pad_hw
    h = int(rng.integers(int(hm * 0.7), hm + 1))
    w = int(rng.integers(int(wm * 0.7), wm + 1))
    img = rng.integers(60, 90, (h, w, 3)).astype(np.uint8)
    for _ in range(int(rng.integers(1, max_objects + 1))):
        bw = int(rng.integers(w // 8, w // 3))
        bh = int(rng.integers(h // 8, h // 3))
        x0 = int(rng.integers(0, max(w - bw, 1)))
        y0 = int(rng.integers(0, max(h - bh, 1)))
        c = int(rng.integers(0, num_classes))
        rng.uniform(5.0, 30.0)                   # the scene's depth draw
        img[y0:y0 + bh, x0:x0 + bw] = CLASS_COLORS[c]
    return img


def calibration_inputs(cfg: dict, pad_hw, device, batches: int = 3,
                       per_batch: int = 2) -> List[torch.Tensor]:
    """The calibration set as model inputs, (per_batch, 3, H, W) in [-1, 1]."""
    from cvbench.reference.preprocess import letterbox, resample

    rng = np.random.default_rng(0)
    nc = min(int(cfg.get("num_classes", 3)), 10)
    out_hw = cfg["input_hw"]
    xs = []
    for _ in range(batches):
        batch = []
        for _ in range(per_batch):
            img = torch.from_numpy(calibration_scene(rng, pad_hw, nc)).to(device)
            lb = letterbox(img.shape[0], img.shape[1], *out_hw)
            rgb = torch.stack([resample(img[..., c], lb, False, out_hw, 0.0) for c in range(3)])
            batch.append(rgb / 127.5 - 1.0)
        xs.append(torch.stack(batch))
    return xs


def control_quant(name: str):
    """The control's quantizer by the name a mix gives: "fp8_e4m3", or
    "int<bits>"; "int8_static" is the witness above (to be calibrated)."""
    if name == "fp8_e4m3":
        return fake_fp8()
    if name == "int8_static":
        return StaticInt8()
    if name.startswith("int"):
        return fake_quant(int(name[3:]))
    raise ValueError(f"unknown control precision {name!r}")
