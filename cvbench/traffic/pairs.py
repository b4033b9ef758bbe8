"""Frame pairs of a forward camera for a two-frame model (depth and
ego-motion): frame t, and frame t+1 as the camera sees the scene after moving
forward, each in planar YUV420 inside a padded buffer, all drawn from the
run's data stream.

Frame t is the general generator's scene (``generator.py::scene``) at one of
the mix's source sizes (``mix["sizes"]``, [h, w] pairs, odd sizes allowed: a
camera's chroma planes then hold ceil(size / 2) samples). Frame t+1 is frame
t zoomed by ``mix["zoom"]`` ([lo, hi]) about a point within ``mix["focus"]``
(a fraction of each side) of the centre, then shifted by up to
``mix["shift_px"]`` pixels along each axis: what forward travel does to the
image of a scene ahead. It is sampled bilinearly with edges replicated.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from cvbench.traffic.generator import rgb_to_yuv420, scene


def ego_step(rng: np.random.Generator, rgb: np.ndarray, mix: dict) -> np.ndarray:
    """Frame t (h, w, 3) uint8 -> frame t+1 after forward ego-motion."""
    h, w = rgb.shape[:2]
    zoom = rng.uniform(*mix["zoom"])
    cy = h * (0.5 + rng.uniform(-mix["focus"], mix["focus"]))
    cx = w * (0.5 + rng.uniform(-mix["focus"], mix["focus"]))
    dy, dx = rng.uniform(-mix["shift_px"], mix["shift_px"], 2)
    sy = cy + (np.arange(h, dtype=np.float32) - cy) / zoom - dy
    sx = cx + (np.arange(w, dtype=np.float32) - cx) / zoom - dx

    def taps(src, n):
        src = np.clip(src, 0.0, n - 1.0)
        lo = np.floor(src).astype(np.int64)
        return lo, np.minimum(lo + 1, n - 1), (src - lo).astype(np.float32)

    y0, y1, fy = taps(sy, h)
    x0, x1, fx = taps(sx, w)
    img = rgb.astype(np.float32)
    rows = img[y0] + (img[y1] - img[y0]) * fy[:, None, None]
    out = rows[:, x0] + (rows[:, x1] - rows[:, x0]) * fx[None, :, None]
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def yuv420(rgb: np.ndarray):
    """(h, w, 3) uint8, any h and w -> y (h, w), u, v (ceil(h/2), ceil(w/2)):
    an odd side is edge-replicated to even before the 2x2 chroma averages."""
    h, w = rgb.shape[:2]
    even = np.pad(rgb, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    y, u, v = rgb_to_yuv420(even)
    return y[:h, :w], u, v


def _buffers(rgb: np.ndarray, buffer_hw, suffix: str) -> Dict[str, np.ndarray]:
    bh, bw = buffer_hw
    y, u, v = yuv420(rgb)
    yb = np.zeros((1, bh, bw), np.uint8)
    ub = np.full((1, bh // 2, bw // 2), 128, np.uint8)
    vb = np.full((1, bh // 2, bw // 2), 128, np.uint8)
    yb[0, :y.shape[0], :y.shape[1]] = y
    ub[0, :u.shape[0], :u.shape[1]] = u
    vb[0, :v.shape[0], :v.shape[1]] = v
    return {"y" + suffix: yb, "u" + suffix: ub, "v" + suffix: vb}


def pair_pool(rng: np.random.Generator, mix: dict) -> List[Dict[str, np.ndarray]]:
    """``mix["pool"]`` pairs, each ``{"y", "u", "v", "y_t1", "u_t1", "v_t1",
    "image_hw"}`` with a leading batch axis of 1, in ``mix["buffer_hw"]``
    buffers; both frames of a pair share its ``image_hw``."""
    out = []
    sizes = [tuple(int(x) for x in s) for s in mix["sizes"]]
    for _ in range(int(mix["pool"])):
        h, w = sizes[int(rng.integers(0, len(sizes)))]
        t0 = scene(rng, h, w, int(mix["colors"]), int(mix["max_objects"]))
        t1 = ego_step(rng, t0, mix)
        out.append({**_buffers(t0, mix["buffer_hw"], ""), **_buffers(t1, mix["buffer_hw"], "_t1"),
                    "image_hw": np.array([[h, w]], np.int32)})
    return out
