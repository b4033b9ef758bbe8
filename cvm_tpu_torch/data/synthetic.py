"""Synthetic scenes: planar YUV420 batches (the serving wire format) and a
resumable stream of RGB training batches.

Counterpart of ``cvm_tpu/data/synthetic.py``: ``synthetic_batch`` is the
port's copy of that module's RGB path (noise background, colored class
rectangles; no two-frame or 3D labels), drawing from the numpy generator
in the same order, so one ``rng`` gives the same scenes on both sides. The
RGB -> 4:2:0 conversion is ``cvm_tpu/native::_rgb_to_yuv420_np``
(full-range JFIF, chroma averaged over each 2x2 block), written out here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

# One distinctive RGB color per class.
_CLASS_COLORS = np.array(
    [(220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40), (220, 40, 220),
     (40, 220, 220), (240, 140, 20), (140, 20, 240), (20, 240, 140), (180, 180, 180)],
    np.uint8)


def synthetic_sample(rng: np.random.Generator, hw: Tuple[int, int], num_classes: int = 3,
                     max_objects: int = 8) -> Dict[str, np.ndarray]:
    """One scene: noise background + 1..max_objects colored class
    rectangles, with the matching boxes, classes, class mask and depth."""
    H, W = hw
    img = rng.integers(60, 90, (H, W, 3)).astype(np.uint8)
    n = int(rng.integers(1, max_objects + 1))
    boxes = np.zeros((max_objects, 4), np.float32)
    classes = np.zeros((max_objects,), np.int32)
    mask = np.zeros((H, W), np.uint8)
    depth = np.zeros((H, W), np.float32)
    depth[:] = np.linspace(40.0, 5.0, H)[:, None]
    for k in range(n):
        bw = int(rng.integers(W // 8, W // 3))
        bh = int(rng.integers(H // 8, H // 3))
        x0 = int(rng.integers(0, max(W - bw, 1)))
        y0 = int(rng.integers(0, max(H - bh, 1)))
        c = int(rng.integers(0, num_classes))
        img[y0:y0 + bh, x0:x0 + bw] = _CLASS_COLORS[c]
        boxes[k] = [x0, y0, x0 + bw, y0 + bh]
        classes[k] = c
        mask[y0:y0 + bh, x0:x0 + bw] = c
        depth[y0:y0 + bh, x0:x0 + bw] = float(rng.uniform(5.0, 30.0))
    return {"image": img, "image_hw": np.array([H, W], np.int32), "boxes": boxes,
            "classes": classes, "num_objects": np.int32(n), "mask": mask, "depth": depth}


def synthetic_batch(rng: np.random.Generator, batch_size: int, pad_hw: Tuple[int, int],
                    num_classes: int = 3, max_objects: int = 8) -> Dict[str, np.ndarray]:
    """Batch of RGB scenes padded to ``pad_hw`` (the loader's static buffer
    shape): ``{"image", "image_hw", "boxes", "classes", "num_objects",
    "mask", "depth"}``. Each scene's extent is drawn from [0.7, 1] of the
    padding."""
    Hm, Wm = pad_hw
    keys = ("image", "image_hw", "boxes", "classes", "num_objects", "mask", "depth")
    out: Dict[str, list] = {k: [] for k in keys}
    for _ in range(batch_size):
        H = int(rng.integers(int(Hm * 0.7), Hm + 1))
        W = int(rng.integers(int(Wm * 0.7), Wm + 1))
        s = synthetic_sample(rng, (H, W), num_classes, max_objects)
        for k, dtype in (("image", np.uint8), ("mask", np.uint8), ("depth", np.float32)):
            padded = np.zeros((Hm, Wm) + s[k].shape[2:], dtype)
            padded[:H, :W] = s[k]
            s[k] = padded
        for k in keys:
            out[k].append(s[k])
    return {k: np.stack(v) for k, v in out.items()}


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB with even H, W -> (y, u, v) uint8 planes."""
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def down2(p):
        return 0.25 * (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2])

    def q(p):
        return np.clip(p + 0.5, 0, 255).astype(np.uint8)

    return q(y), q(down2(u)), q(down2(v))


def synthetic_yuv420_batch(rng: np.random.Generator, batch_size: int,
                           pad_hw: Tuple[int, int], num_classes: int = 3,
                           max_objects: int = 8) -> Dict[str, np.ndarray]:
    """``{"y", "u", "v", "image_hw", "boxes", "classes", "num_objects"}``.

    The scenes of ``synthetic_batch(rng, ...)`` converted to planes. Unlike
    the reference's ``yuv420=True``, valid extents may be odd; the serving
    preprocess takes any extent (chroma extent ``(h + 1) // 2``)."""
    if pad_hw[0] % 2 or pad_hw[1] % 2:
        raise ValueError(f"pad size must be even for 4:2:0, got {pad_hw}")
    batch = synthetic_batch(rng, batch_size, pad_hw, num_classes, max_objects)
    out = {k: batch[k] for k in ("image_hw", "boxes", "classes", "num_objects")}
    planes = [rgb_to_yuv420(im) for im in batch["image"]]
    for i, k in enumerate(("y", "u", "v")):
        out[k] = np.stack([p[i] for p in planes])
    return out


class SyntheticIterator:
    """Endless RGB training batches, the stream of
    ``cvm_tpu.data.synthetic.synthetic_iterator(seed, ...)`` (one numpy
    generator drawn from in order), whose position can be saved and
    restored: ``state_dict`` is the generator's state after the last batch
    it produced, so a resumed run continues the same stream."""

    def __init__(self, seed: int, batch_size: int, pad_hw: Tuple[int, int],
                 num_classes: int = 3, max_objects: int = 8):
        self.rng = np.random.default_rng(seed)
        self.batch_size, self.pad_hw = batch_size, tuple(pad_hw)
        self.num_classes, self.max_objects = num_classes, max_objects

    def __iter__(self) -> "SyntheticIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return synthetic_batch(self.rng, self.batch_size, self.pad_hw, self.num_classes,
                               self.max_objects)

    def state_dict(self) -> Dict[str, Any]:
        return {"bit_generator": self.rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.rng.bit_generator.state = state["bit_generator"]
