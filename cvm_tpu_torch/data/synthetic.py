"""Synthetic scenes: planar YUV420 batches (the serving wire format), RGB
training batches with optional two-frame (DMDS) and monocular 3D labels,
and a resumable stream of them.

Counterpart of ``cvm_tpu/data/synthetic.py``: ``synthetic_sample``,
``_bilinear_np`` and ``synthetic_batch`` are the port's copy of that
module (noise or smooth backgrounds, colored class rectangles; the
depth-consistent second frame ``image_t1`` with its ego translation
``ego_t``; ``loc3d`` / ``dims3d`` / ``rot_y`` and the intrinsics; 4:2:0
planes with ``yuv420=True``), drawing from the numpy generator in the same
order, so one ``rng`` gives the same scenes on both sides. The RGB -> 4:2:0
conversion is ``cvm_tpu/native::_rgb_to_yuv420_np`` (full-range JFIF,
chroma averaged over each 2x2 block), written out here.
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
                     max_objects: int = 8, smooth_background: bool = False
                     ) -> Dict[str, np.ndarray]:
    """One scene: noise background + 1..max_objects colored class
    rectangles, with the matching boxes, classes, class mask and depth.

    ``smooth_background`` (two-frame scenes) renders the noise at quarter
    resolution, bilinearly upsampled, and textures each rectangle with a
    smooth luminance modulation: per-pixel noise decorrelates under any
    subpixel resample, and a flat patch carries no parallax, so the
    photometric loss would have no usable minimum on either."""
    H, W = hw
    if smooth_background:
        hb, wb = max(H // 4, 2), max(W // 4, 2)
        base = rng.integers(40, 110, (hb, wb, 3)).astype(np.uint8)
        yy, xx = np.meshgrid(np.linspace(0.0, hb - 1.0, H, dtype=np.float32),
                             np.linspace(0.0, wb - 1.0, W, dtype=np.float32), indexing="ij")
        img = _bilinear_np(base, xx, yy)
    else:
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
        if smooth_background:
            hb, wb = max(bh // 4, 2), max(bw // 4, 2)
            lum = rng.uniform(0.55, 1.45, (hb, wb, 1)).astype(np.float32)
            yy, xx = np.meshgrid(np.linspace(0.0, hb - 1.0, bh, dtype=np.float32),
                                 np.linspace(0.0, wb - 1.0, bw, dtype=np.float32),
                                 indexing="ij")
            lum255 = np.clip(lum * 170.0, 0, 255).astype(np.uint8)
            mod = _bilinear_np(lum255, xx, yy).astype(np.float32) / 170.0
            patch = _CLASS_COLORS[c].astype(np.float32) * mod
            img[y0:y0 + bh, x0:x0 + bw] = np.clip(np.round(patch), 0, 255).astype(np.uint8)
        else:
            img[y0:y0 + bh, x0:x0 + bw] = _CLASS_COLORS[c]
        boxes[k] = [x0, y0, x0 + bw, y0 + bh]
        classes[k] = c
        mask[y0:y0 + bh, x0:x0 + bw] = c
        depth[y0:y0 + bh, x0:x0 + bw] = float(rng.uniform(5.0, 30.0))
    return {"image": img, "image_hw": np.array([H, W], np.int32), "boxes": boxes,
            "classes": classes, "num_objects": np.int32(n), "mask": mask, "depth": depth}


def _bilinear_np(img: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """Bilinear-sample an (H, W, C) uint8 image at float coords (sy, sx)."""
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    x1 = np.minimum(x0 + 1, img.shape[1] - 1)
    y1 = np.minimum(y0 + 1, img.shape[0] - 1)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    f = img.astype(np.float32)
    top = f[y0, x0] * (1.0 - wx) + f[y0, x1] * wx
    bot = f[y1, x0] * (1.0 - wx) + f[y1, x1] * wx
    return np.clip(np.round(top * (1.0 - wy) + bot * wy), 0, 255).astype(np.uint8)


def synthetic_batch(rng: np.random.Generator, batch_size: int, pad_hw: Tuple[int, int],
                    num_classes: int = 3, max_objects: int = 8, vary_sizes: bool = True,
                    two_frame: bool = False, with_3d: bool = False,
                    yuv420: bool = False) -> Dict[str, np.ndarray]:
    """Batch of scenes padded to ``pad_hw`` (the loader's static buffer
    shape): ``{"image", "image_hw", "boxes", "classes", "num_objects",
    "mask", "depth"}``. Each scene's extent is drawn from [0.7, 1] of the
    padding (``vary_sizes``).

    ``two_frame`` adds ``image_t1``, the scene seen after a lateral camera
    translation ``ego_t`` (tx, ty) metres: a pixel observing depth Z moves
    by (fx tx / Z, fy ty / Z), so near structure moves farther and the
    photometric loss identifies the (scale-free) depth. ``with_3d`` adds
    per-object ``loc3d`` (camera z from the box width), ``dims3d`` and
    ``rot_y``. Either adds ``intrinsics`` (B, 4) [fx, fy, cx, cy] in source
    pixels. ``yuv420`` replaces ``image`` (and ``image_t1``) by planar
    4:2:0 ``y/u/v`` (``y_t1/u_t1/v_t1``), with even valid extents."""
    Hm, Wm = pad_hw
    if yuv420 and (Hm % 2 or Wm % 2):
        raise ValueError(f"pad size must be even for 4:2:0, got {pad_hw}")
    keys = ["image", "image_hw", "boxes", "classes", "num_objects", "mask", "depth"]
    if two_frame:
        keys += ["image_t1", "ego_t"]
    if with_3d:
        keys += ["loc3d", "dims3d", "rot_y"]
    if two_frame or with_3d:
        keys += ["intrinsics"]
    out: Dict[str, list] = {k: [] for k in keys}
    for _ in range(batch_size):
        if vary_sizes:
            H = int(rng.integers(int(Hm * 0.7), Hm + 1))
            W = int(rng.integers(int(Wm * 0.7), Wm + 1))
        else:
            H, W = Hm, Wm
        if yuv420:  # even valid extents keep the chroma planes aligned
            H -= H % 2
            W -= W % 2
        s = synthetic_sample(rng, (H, W), num_classes, max_objects,
                             smooth_background=two_frame)
        scene = s["image"]
        for k, dtype in (("image", np.uint8), ("mask", np.uint8), ("depth", np.float32)):
            padded = np.zeros((Hm, Wm) + s[k].shape[2:], dtype)
            padded[:H, :W] = s[k]
            s[k] = padded
        if with_3d:
            # Plausible camera-frame labels correlated with the box size
            # (a bigger box is closer), so the 3D heads are learnable.
            sizes = (s["boxes"][:, 2] - s["boxes"][:, 0]) + 1e-3
            loc = np.zeros((max_objects, 3), np.float32)
            loc[:, 2] = np.clip(800.0 / sizes, 2.0, 80.0).astype(np.float32)
            s["loc3d"] = loc
            s["dims3d"] = np.tile(np.array([1.6, 1.8, 4.2], np.float32), (max_objects, 1))
            s["rot_y"] = rng.uniform(-np.pi, np.pi, max_objects).astype(np.float32)
        if two_frame:
            fx = fy = 0.9 * W  # the intrinsics emitted below
            tx = float(rng.uniform(0.10, 0.28)) * (1.0 if rng.random() < 0.5 else -1.0)
            ty = float(rng.uniform(-0.06, 0.06))
            inv_z = 1.0 / np.maximum(s["depth"][:H, :W], 0.5)
            yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                                 np.arange(W, dtype=np.float32), indexing="ij")
            # Inverse warp: frame t+1's pixel p samples frame t at
            # p + f t / Z(p), Z taken at the target pixel.
            src_x = np.clip(xx + fx * tx * inv_z, 0.0, W - 1.0)
            src_y = np.clip(yy + fy * ty * inv_z, 0.0, H - 1.0)
            img2 = np.zeros((Hm, Wm, 3), np.uint8)
            img2[:H, :W] = _bilinear_np(scene, src_x, src_y)
            s["image_t1"] = img2
            s["ego_t"] = np.array([tx, ty], np.float32)
        if two_frame or with_3d:
            s["intrinsics"] = np.array([0.9 * W, 0.9 * W, W / 2.0, H / 2.0], np.float32)
        for k in keys:
            out[k].append(s[k])
    batch = {k: np.stack(v) for k, v in out.items()}
    if yuv420:
        for src, dst in (("image", ("y", "u", "v")), ("image_t1", ("y_t1", "u_t1", "v_t1"))):
            if src in batch:
                planes = [rgb_to_yuv420(im) for im in batch.pop(src)]
                for i, k in enumerate(dst):
                    batch[k] = np.stack([p[i] for p in planes])
    return batch


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
    """Endless RGB training batches (two-frame and 3D labels on request),
    the stream of ``cvm_tpu.data.synthetic.synthetic_iterator(seed, ...)``
    (one numpy generator drawn from in order), whose position can be saved
    and restored: ``state_dict`` is the generator's state after the last
    batch it produced, so a resumed run continues the same stream."""

    def __init__(self, seed: int, batch_size: int, pad_hw: Tuple[int, int],
                 num_classes: int = 3, max_objects: int = 8, two_frame: bool = False,
                 with_3d: bool = False):
        self.rng = np.random.default_rng(seed)
        self.batch_size, self.pad_hw = batch_size, tuple(pad_hw)
        self.num_classes, self.max_objects = num_classes, max_objects
        self.two_frame, self.with_3d = two_frame, with_3d

    def __iter__(self) -> "SyntheticIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return synthetic_batch(self.rng, self.batch_size, self.pad_hw, self.num_classes,
                               self.max_objects, two_frame=self.two_frame,
                               with_3d=self.with_3d)

    def state_dict(self) -> Dict[str, Any]:
        return {"bit_generator": self.rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.rng.bit_generator.state = state["bit_generator"]
