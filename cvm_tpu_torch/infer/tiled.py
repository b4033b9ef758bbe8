"""Tiled (sliding-window) inference for the dense models at any resolution.

Mirrors ``cvm_tpu/infer/tiled.py`` (``tile_positions``, ``_hann2d``,
``tiled_apply``, ``tiled_predict``): the image is covered by overlapping
tiles of the model's input size, every tile goes through one forward
(chunks of ``tile_batch`` tiles, the last padded by repeating the first
tile, so every forward has one shape), and the overlaps blend under a
separable Hann window floored at 0.01, so that no seam shows and every
pixel has weight. ``tiled_predict`` runs semseg, depth and multitask (one
forward per tile for all their dense heads, under fake-quant for a ``qat``
config, as the pipeline serves it) and refuses detection, which needs
global context per tile.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from cvm_tpu_torch.ops.image import normalize_pm1
from cvm_tpu_torch.train.qat import maybe_fake_quant

DENSE_KEYS = {"semseg": ("logits",), "depth": ("depth",), "multitask": ("logits", "depth")}


def tile_positions(full: int, tile: int, overlap: float) -> List[int]:
    """Start offsets covering [0, full) with ~``overlap`` fractional overlap;
    the last tile is clamped to the border, and ``full <= tile`` gives [0]
    (the caller pads)."""
    if not 0.0 <= overlap < 1.0:
        # overlap < 0 strides past the tile (uncovered gaps, 0/0 in the
        # blend); overlap >= 1 clamps the stride to 1 px (a tile-count
        # explosion that looks like a hang).
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    if tile >= full:
        return [0]
    stride = max(1, int(round(tile * (1.0 - overlap))))
    pos = list(range(0, full - tile + 1, stride))
    if pos[-1] != full - tile:
        pos.append(full - tile)
    return pos


@functools.lru_cache(maxsize=8)
def _hann2d(th: int, tw: int) -> np.ndarray:
    """The (th, tw, 1) float32 blend window: separable Hann, plus 0.01 so
    border tiles (which have no partner there) keep weight."""
    wy = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(th) + 0.5) / th)
    wx = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tw) + 0.5) / tw)
    w = np.outer(wy, wx).astype(np.float32) + 1e-2
    w.setflags(write=False)
    return w[..., None]


def tiled_apply(apply_fn: Callable[[torch.Tensor], torch.Tensor], image: torch.Tensor,
                tile_hw: Tuple[int, int], overlap: float = 0.25,
                tile_batch: int = 8) -> torch.Tensor:
    """Stitch ``apply_fn`` over ``image`` with overlapping tiles.

    apply_fn: (tile_batch, th, tw, C_in) -> (tile_batch, th, tw, C_out), a
    dense prediction at the tile's resolution. image: (H, W, C_in) float.
    Returns the (H, W, C_out) float32 blend, on ``image``'s device."""
    th, tw = tile_hw
    H, W = int(image.shape[0]), int(image.shape[1])
    ph, pw = max(H, th), max(W, tw)
    if (ph, pw) != (H, W):  # smaller than a tile: pad, crop at the end
        image = torch.nn.functional.pad(image, (0, 0, 0, pw - W, 0, ph - H))
    grid = [(y, x) for y in tile_positions(ph, th, overlap)
            for x in tile_positions(pw, tw, overlap)]
    T = len(grid)
    pad = (-T) % tile_batch
    tiles = torch.stack([image[y:y + th, x:x + tw] for (y, x) in grid])
    if pad:
        tiles = torch.cat([tiles, tiles[:1].expand(pad, *tiles.shape[1:])])
    preds = [apply_fn(tiles[i:i + tile_batch]) for i in range(0, T + pad, tile_batch)]
    if tuple(preds[0].shape[1:3]) != (th, tw):
        raise ValueError(f"tiled_apply needs same-resolution dense output, got tile "
                         f"{(th, tw)} -> {tuple(preds[0].shape[1:3])}")
    p = torch.cat(preds)[:T].to(torch.float32)
    window = torch.tensor(_hann2d(th, tw), device=p.device)
    out = torch.zeros((ph, pw, p.shape[-1]), dtype=torch.float32, device=p.device)
    wsum = torch.zeros((ph, pw, 1), dtype=torch.float32, device=p.device)
    for i, (y, x) in enumerate(grid):
        out[y:y + th, x:x + tw] += p[i] * window
        wsum[y:y + th, x:x + tw] += window
    return (out / wsum)[:H, :W]


@torch.no_grad()
def tiled_predict(cfg, model: torch.nn.Module, image_u8, overlap: float = 0.25,
                  tile_batch: int = 8) -> Dict[str, torch.Tensor]:
    """Dense prediction of a zoo model (semseg, depth or multitask: ``cfg.name``)
    over an (H, W, 3) uint8 RGB image of any size >= 1 px, stitched at (H, W):
    semseg {"logits", "class_map"}, depth {"depth"}, multitask {"logits",
    "class_map", "depth"}. The image is normalized as in training
    (``normalize_pm1``); ``model`` runs in eval mode on its own device."""
    keys = DENSE_KEYS.get(cfg.name)
    if keys is None:
        raise ValueError(f"tiled inference is for dense-prediction models, not {cfg.name!r} "
                         "(detection needs global context per tile; run the fixed-size "
                         "InferencePipeline instead)")
    device = next(model.parameters()).device
    model.eval()
    image = normalize_pm1(torch.tensor(np.asarray(image_u8), device=device))
    n_cls = int(getattr(cfg, "num_seg_classes", getattr(cfg, "num_classes", 0)))
    widths = {"logits": n_cls, "depth": 1}

    def one(tiles):
        # one forward per tile for every dense head: the heads concatenate
        # along channels, stitch once, and split back
        with maybe_fake_quant(cfg):
            o = model(tiles)
        return torch.cat([o[k].to(torch.float32) for k in keys], -1)

    stitched = tiled_apply(one, image, tuple(cfg.input_hw), overlap, tile_batch)
    out, c0 = {}, 0
    for k in keys:
        out[k] = stitched[..., c0:c0 + widths[k]]
        c0 += widths[k]
    if "logits" in out:
        out["class_map"] = torch.argmax(out["logits"], -1)
    return out
