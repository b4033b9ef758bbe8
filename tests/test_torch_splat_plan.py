"""The tiling of the Gaussian splat kernel K1 and the bound it culls by.

``csrc/gaussian_splat.cu`` runs on the card only, so what it relies on is
held here on the CPU, in plain PyTorch:

- ``splat_plan`` cuts every image's NHWC map into tiles that cover each
  element exactly once and fit the block's shared memory;
- every pixel an object makes nonzero lies within R = ceil(r) + 1 of its
  centre, the bound by which a block drops the objects that miss its tile;
- a banded render (per tile, only the objects that bound keeps; then the
  tiles concatenated) equals ``render_heatmap_reference`` exactly.
"""

import numpy as np
import pytest
import torch

from cvm_tpu_torch.ops.cuda import gaussian_splat as gs
from cvm_tpu_torch.ops.cuda.gaussian_splat import render_heatmap_reference, splat_plan
from cvm_tpu_torch.ops.heatmap import prepare_centers

SMEM_PER_BLOCK = 232448  # an H100 block's shared memory, in bytes

# name -> (B, K, Hs, Ws, C)
SHAPES = {
    "flagship": (16, 8, 128, 128, 10),
    "config_b": (8, 128, 128, 128, 80),
    "one_pixel": (2, 3, 1, 1, 1),
    "ragged": (3, 7, 13, 17, 5),        # Ws*C = 85, not a multiple of 4 floats
    "non_square": (2, 6, 24, 40, 3),
    "tall": (2, 9, 64, 16, 4),
    "wide_row": (1, 6, 8, 1024, 80),    # one row is wider than a tile: flat chunks
}


def tile_ranges(plan, Hs, Ws, C):
    hwc = Hs * Ws * C
    return [(t * plan.chunk, min((t + 1) * plan.chunk, hwc)) for t in range(plan.tiles)]


@pytest.mark.parametrize("name", list(SHAPES))
def test_splat_plan_tiles_each_image_once(name):
    B, _, Hs, Ws, C = SHAPES[name]
    plan = splat_plan(B, Hs, Ws, C)
    row = Ws * C
    cover = np.zeros(Hs * row, np.int64)
    for a, b in tile_ranges(plan, Hs, Ws, C):
        assert a < b
        cover[a:b] += 1
    assert (cover == 1).all()
    assert plan.blocks == B * plan.tiles
    if plan.rows:  # bands of whole rows: each row of the image in one band
        assert plan.chunk == plan.rows * row and 4 * row <= gs.ROW_BYTES_MAX
        bands = [(t * plan.rows, min((t + 1) * plan.rows, Hs)) for t in range(plan.tiles)]
        assert sorted(y for a, b in bands for y in range(a, b)) == list(range(Hs))
        assert plan.rows == 1 or 4 * plan.chunk <= gs.TILE_BYTES
        assert plan.blocks >= min(gs.MIN_BLOCKS, B * Hs)
    else:
        assert 4 * row > gs.ROW_BYTES_MAX and plan.chunk % 4 == 0
    # the tile, shifted by up to 3 floats to align it, plus the culled objects
    tile_bytes = 4 * (plan.chunk + 3)
    assert tile_bytes + gs._KERNEL_OBJS * gs._OBJ_BYTES <= plan.smem_bytes <= SMEM_PER_BLOCK


def test_splat_plan_shapes_of_the_main_path():
    """The flagship training map in 4-row bands of 20 KB, config B's in
    single rows of 40 KB; both grids several blocks per SM."""
    assert splat_plan(16, 128, 128, 10)[:4] == (4, 5120, 32, 512)
    assert splat_plan(8, 128, 128, 80)[:4] == (1, 10240, 128, 1024)
    assert splat_plan(1, 8, 1024, 80).rows == 0


def random_objects(rng, B, K, Hs, Ws, C):
    """Per-object inputs from random boxes through prepare_centers, as the
    training path makes them, with one box far larger than the map (its
    radius exceeds the map) and a few classes outside [0, C)."""
    x0 = rng.uniform(-8, Ws, (B, K))
    y0 = rng.uniform(-8, Hs, (B, K))
    w = rng.uniform(1, 0.75 * max(Hs, Ws) + 2, (B, K))
    h = rng.uniform(1, 0.75 * max(Hs, Ws) + 2, (B, K))
    boxes = np.stack([x0, y0, x0 + w, y0 + h], -1)
    if K:  # a square box 40 maps wide, centred in the map
        half = 20.0 * max(Hs, Ws)
        boxes[0, 0] = [Ws / 2 - half, Hs / 2 - half, Ws / 2 + half, Hs / 2 + half]
    boxes = torch.from_numpy(boxes.astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(B, K)) < 0.8)
    if K:
        valid[0, 0] = True
    _, _, _, _, v, ix, iy, radius, sigma = prepare_centers(boxes, valid, (Hs, Ws), 0.7)
    cls = torch.from_numpy(rng.integers(-1, C + 1, (B, K)).astype(np.int32))
    return iy, ix, sigma, radius, cls, v


def cull_radius(radius):
    return torch.ceil(radius.clamp_min(0.0)) + 1.0


@pytest.mark.parametrize("name", list(SHAPES))
def test_nonzero_pixels_lie_within_the_cull_radius(name):
    B, K, Hs, Ws, C = SHAPES[name]
    B, K = min(B, 2), min(K, 16)   # each object rendered alone: keep the lattice small
    rng = np.random.default_rng(len(name))
    iy, ix, sigma, radius, cls, v = random_objects(rng, B, K, Hs, Ws, C)
    if name == "one_pixel":  # fractional and zero radii
        radius = torch.from_numpy(rng.choice([0.0, 0.5, 2.5, 7.0], (B, K)).astype(np.float32))
        sigma = (2 * radius + 1) / 6
    # one object per image, all of class 0 and valid
    one = lambda t: t.reshape(B * K, 1)
    hm = render_heatmap_reference(one(iy), one(ix), one(sigma), one(radius),
                                  torch.zeros(B * K, 1, dtype=torch.int32),
                                  torch.ones(B * K, 1, dtype=torch.bool), (Hs, Ws), 1)[..., 0]
    R = cull_radius(one(radius))[:, 0]
    ys, xs = torch.arange(Hs)[None, :, None], torch.arange(Ws)[None, None, :]
    near = (((ys - one(iy)[:, :, None]).abs() <= R[:, None, None])
            & ((xs - one(ix)[:, :, None]).abs() <= R[:, None, None]))
    assert bool((hm[~near] == 0).all())
    assert bool((hm > 0).any())
    if name != "one_pixel":  # the huge box: its radius exceeds the map
        assert float(radius[0, 0]) > max(Hs, Ws)


def banded_render(iy, ix, sigma, radius, classes, valid, map_hw, C):
    """Render each tile of ``splat_plan`` from only the objects whose
    window [c - R, c + R] meets the tile's rows (and the map's columns), as
    the kernel culls them, and concatenate the tiles."""
    Hs, Ws = map_hw
    B = iy.shape[0]
    plan = splat_plan(B, Hs, Ws, C)
    R = cull_radius(radius)
    keep_any = valid & (classes >= 0) & (classes < C) & (ix - R <= Ws - 1) & (ix + R >= 0)
    row = Ws * C
    out = []
    for b in range(B):
        tiles = []
        for a, e in tile_ranges(plan, Hs, Ws, C):
            y0, y1 = a // row, (e - 1) // row
            keep = keep_any[b] & (iy[b] - R[b] <= y1) & (iy[b] + R[b] >= y0)
            sel = lambda t: t[b:b + 1]
            band = render_heatmap_reference(sel(iy), sel(ix), sel(sigma), sel(radius),
                                            sel(classes), keep[None], map_hw, C)
            tiles.append(band.reshape(-1)[a:e])
        out.append(torch.cat(tiles))
    return torch.stack(out).reshape(B, Hs, Ws, C)


@pytest.mark.parametrize("name", [n for n in SHAPES if n != "config_b"])
def test_banded_render_equals_reference(name):
    B, K, Hs, Ws, C = SHAPES[name]
    rng = np.random.default_rng(100 + len(name))
    args = random_objects(rng, B, K, Hs, Ws, C)
    want = render_heatmap_reference(*args, (Hs, Ws), C)
    got = banded_render(*args, (Hs, Ws), C)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((want > 0).any())


def test_banded_render_equals_reference_config_b_rows():
    """Config B's shape (1-row bands, 128 objects per image): the first 16
    bands of two images, each rendered from its culled objects alone (the
    whole banded render at this shape is too slow for a CPU test)."""
    B, K, Hs, Ws, C = SHAPES["config_b"]
    rng = np.random.default_rng(9)
    iy, ix, sigma, radius, cls, v = random_objects(rng, 2, K, Hs, Ws, C)
    plan = splat_plan(B, Hs, Ws, C)
    assert plan.rows == 1
    want = render_heatmap_reference(iy, ix, sigma, radius, cls, v, (Hs, Ws), C)
    R = cull_radius(radius)
    for y in range(16):
        keep = v & (cls >= 0) & (cls < C) & (iy - R <= y) & (iy + R >= y)
        assert bool(keep.any()) and not bool(keep.all())
        band = render_heatmap_reference(iy, ix, sigma, radius, cls, keep, (Hs, Ws), C)
        torch.testing.assert_close(band[:, y], want[:, y], rtol=0, atol=0)
    assert float(want.max()) == 1.0
