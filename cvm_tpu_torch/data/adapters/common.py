"""Shared adapter helpers.

The port's copy of ``cvm_tpu/data/adapters/common.py``: ``load_png_u16``,
``load_png_u8`` and ``colors_to_class_map``; ``read_image_as_jpeg`` has
its one home in ``data/images.py`` (JPEGs pass through untouched, other
formats are encoded once as JPEG with PIL).
"""

from __future__ import annotations

import numpy as np

from cvm_tpu_torch.data.images import read_image_as_jpeg  # noqa: F401


def load_png_u16(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.uint16)


def load_png_u8(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def colors_to_class_map(rgb: np.ndarray, palette, tolerance: int = 8) -> np.ndarray:
    """Color-coded mask -> class-id map (255 where no palette color matches).

    The reference rasterizes color PNG masks to one-hot on host per sample
    (SURVEY.md §2 "Semseg processor+loss"); here it happens once at pack time.
    """
    h, w = rgb.shape[:2]
    out = np.full((h, w), 255, np.uint8)
    for ci, color in enumerate(palette):
        m = np.all(np.abs(rgb.astype(int) - np.asarray(color, int)) <= tolerance, axis=-1)
        out[m] = ci
    return out
