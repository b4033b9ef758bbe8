"""Synthetic scenes: planar YUV420 batches (the serving wire format) and a
resumable stream of RGB training batches.

Counterpart of ``cvm_tpu.data.synthetic.synthetic_batch(..., yuv420=True)``
and ``synthetic_iterator``: the scenes come from that (JAX-free, numpy-only)
module, and the RGB ->
4:2:0 conversion is ``cvm_tpu/native::_rgb_to_yuv420_np`` (full-range JFIF,
chroma averaged over each 2x2 block), written out here because
``cvm_tpu.native`` is not among the reference modules the port imports.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from cvm_tpu.data.synthetic import synthetic_batch


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

    The scenes of ``synthetic_batch(rng, ..., yuv420=False)`` converted to
    planes. Unlike ``yuv420=True`` in the reference (which needs
    ``cvm_tpu.native``), valid extents may be odd; the serving preprocess
    takes any extent (chroma extent ``(h + 1) // 2``)."""
    if pad_hw[0] % 2 or pad_hw[1] % 2:
        raise ValueError(f"pad size must be even for 4:2:0, got {pad_hw}")
    batch = synthetic_batch(rng, batch_size, pad_hw, num_classes, max_objects,
                            yuv420=False)
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
