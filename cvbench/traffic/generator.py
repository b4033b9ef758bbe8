"""The general traffic generator: camera frames, arrival schedules and the
seeded sample of finished requests, all drawn from ``--seed``.

Frames are scenes in the manner of the program's synthetic data (a noise
background and coloured class rectangles; a copy written for the benchmark),
converted to planar YUV420 (JFIF, 2x2 chroma averages) and padded into the
mix's buffer, as a camera hands them over. A mix draws a pool of
distinct frames once in set-up; requests cycle through the pool in a seeded
order, so every seed sends the same kind and amount of work.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

COLORS = np.random.default_rng(12345).integers(0, 256, (256, 3)).astype(np.uint8)


def stream(seed: int, k: int) -> np.random.Generator:
    """The ``k``-th random stream of a run seeded ``seed`` (1: the data, 2:
    the order and arrivals, 3: the check's sample)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), k]))


def scene(rng: np.random.Generator, h: int, w: int, num_classes: int,
          max_objects: int) -> np.ndarray:
    """An (h, w, 3) uint8 RGB scene: noise background, 1..max_objects
    rectangles of class colours."""
    img = rng.integers(40, 110, (h, w, 3), dtype=np.uint8)
    for _ in range(int(rng.integers(1, max_objects + 1))):
        bw = int(rng.integers(max(w // 16, 2), max(w // 3, 3)))
        bh = int(rng.integers(max(h // 16, 2), max(h // 3, 3)))
        x0 = int(rng.integers(0, max(w - bw, 1)))
        y0 = int(rng.integers(0, max(h - bh, 1)))
        img[y0:y0 + bh, x0:x0 + bw] = COLORS[int(rng.integers(0, num_classes))]
    return img


def rgb_to_yuv420(rgb: np.ndarray):
    """(H, W, 3) uint8, H and W even -> y (H, W), u, v (H/2, W/2) uint8."""
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def down2(p):
        return 0.25 * (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2])

    def q(p):
        return np.clip(p + 0.5, 0, 255).astype(np.uint8)

    return q(y), q(down2(u)), q(down2(v))


def frame_pool(rng: np.random.Generator, mix: dict, num_classes: int) -> List[Dict[str, np.ndarray]]:
    """``mix["pool"]`` frames, each ``{"y", "u", "v", "image_hw"}`` with a
    leading batch axis of 1: sizes drawn even from ``mix["src_h"]`` and
    ``mix["src_w"]`` ([lo, hi] inclusive), in ``mix["buffer_hw"]`` buffers."""
    bh, bw = mix["buffer_hw"]
    out = []
    for _ in range(int(mix["pool"])):
        h = 2 * int(rng.integers(mix["src_h"][0] // 2, mix["src_h"][1] // 2 + 1))
        w = 2 * int(rng.integers(mix["src_w"][0] // 2, mix["src_w"][1] // 2 + 1))
        y, u, v = rgb_to_yuv420(scene(rng, h, w, num_classes, int(mix["max_objects"])))
        yb = np.zeros((1, bh, bw), np.uint8)
        ub = np.full((1, bh // 2, bw // 2), 128, np.uint8)
        vb = np.full((1, bh // 2, bw // 2), 128, np.uint8)
        yb[0, :h, :w], ub[0, :h // 2, :w // 2], vb[0, :h // 2, :w // 2] = y, u, v
        out.append({"y": yb, "u": ub, "v": vb, "image_hw": np.array([[h, w]], np.int32)})
    return out


def poisson_schedule(rng: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson process of
    ``rate`` per second over ``seconds``."""
    n = int(rate * seconds * 1.5 + 100)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(rng.exponential(1.0 / rate, n))])
    return t[t < seconds]


def request_order(rng: np.random.Generator, pool: int, n: int) -> np.ndarray:
    """Which pool frame each of ``n`` requests sends: seeded passes over the
    whole pool, each in its own order."""
    reps = -(-n // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(max(reps, 1))])[:n]


class Reservoir:
    """A seeded uniform sample of ``k`` items from a stream of unknown length
    (algorithm R)."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k, self.n = rng, k, 0
        self.items: List = []

    def offer(self, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n))
            if j < self.k:
                self.items[j] = item


def pick(rng: np.random.Generator, candidates: Sequence[int], k: int) -> List[int]:
    """A seeded sample of at most ``k`` of ``candidates``, in order."""
    c = np.asarray(list(candidates))
    if len(c) <= k:
        return c.tolist()
    return np.sort(rng.choice(c, size=k, replace=False)).tolist()
