#!/usr/bin/env python3
"""Device time of the Gaussian splat kernel K1 at the main path's two shapes.

    python3 scripts/time_gaussian_splat.py [--root DIR] [--sweep] [--parts]

Times ``cvm_tpu_torch.ops.cuda.gaussian_splat.render_heatmap`` (the whole
call: for an older checkout that includes its zero fill) at the flagship
training shape (B16 K8 128^2 C10) and config B's default (B8 K128 128^2
C80), with ``chip_smoke.py``'s inputs and timing (CUDA events around 20
back-to-back calls behind a card sleep, so the host's launch overhead is
not counted), beside the card's name and power limit. With ``--root`` it
loads the checkout at ``DIR`` (an unpacked older commit) beside this one in
the same process and times them in turns: DIR, this, this, DIR. With
``--sweep`` it also times this checkout under other tilings (the
``splat_plan`` constants). With ``--parts`` it times this checkout's K1
on the same maps with every object invalid (no splat) and with K = 0 (no
object read either), beside a plain ``torch.zeros`` of the map (one fill
kernel, the least a kernel that writes the map takes here). Needs a CUDA
card; builds each kernel from its checkout's sources.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "cvm_tpu_torch"
SHAPES = ("flagship", "config-B")
# (TILE_BYTES, ROW_BYTES_MAX, MIN_BLOCKS) tried by --sweep
SWEEP = [(12 * 1024, 160 * 1024, 264), (24 * 1024, 160 * 1024, 528),
         (48 * 1024, 160 * 1024, 264), (24 * 1024, 24 * 1024, 264),
         (12 * 1024, 12 * 1024, 528)]


def _own(name: str) -> bool:
    return name == PKG or name.startswith(PKG + ".")


def load_checkout(root: str):
    """Import the splat wrapper of the checkout at ``root`` without
    disturbing the modules already imported; returns it with the module
    table its lazy imports must see while it runs."""
    saved = {k: v for k, v in sys.modules.items() if _own(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        gs = importlib.import_module(f"{PKG}.ops.cuda.gaussian_splat")
        importlib.import_module(f"{PKG}.ops.cuda._build")
        mods = {k: v for k, v in sys.modules.items() if _own(k)}
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if _own(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    if not gs.__file__.startswith(os.path.join(root, PKG)):
        raise RuntimeError(f"imported {gs.__file__}, not the kernel under {root}")
    return gs, mods


@contextlib.contextmanager
def modules(mods):
    saved = {k: v for k, v in sys.modules.items() if _own(k)}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for k in [k for k in sys.modules if _own(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="an older checkout to time beside this one")
    ap.add_argument("--sweep", action="store_true", help="also time other tilings")
    ap.add_argument("--parts", action="store_true",
                    help="also time K1 without objects and a plain fill of the map")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("time_gaussian_splat: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    cases = {name: (a, hw, c) for name, a, hw, c in cs.splat_cases(dev) if name in SHAPES}
    this = load_checkout(HERE)
    runs = [("this", this)]
    if args.root:
        old = load_checkout(os.path.abspath(args.root))
        runs = [("old", old), ("this", this), ("this", this), ("old", old)]

    def time_all(label, gs, mods):
        with modules(mods):
            for name, (a, hw, c) in cases.items():
                t = cs.cuda_ms(lambda: gs.render_heatmap(*a, hw, c))
                print(f"[{label}] {name:8s} B{a[0].shape[0]} K{a[0].shape[1]} "
                      f"{hw[0]}x{hw[1]} C{c}: {t:.4f} ms", flush=True)

    for label, (gs, mods) in runs:
        time_all(label, gs, mods)
    if args.sweep:
        gs, mods = this
        default = (gs.TILE_BYTES, gs.ROW_BYTES_MAX, gs.MIN_BLOCKS)
        for tile, row_max, min_blocks in SWEEP + [default]:
            gs.TILE_BYTES, gs.ROW_BYTES_MAX, gs.MIN_BLOCKS = tile, row_max, min_blocks
            plans = "; ".join(f"{n} {gs.splat_plan(a[0].shape[0], *hw, c)}"
                              for n, (a, hw, c) in cases.items())
            print(f"[sweep] TILE_BYTES {tile}, ROW_BYTES_MAX {row_max}, MIN_BLOCKS "
                  f"{min_blocks}: {plans}", flush=True)
            time_all("sweep", gs, mods)
        gs.TILE_BYTES, gs.ROW_BYTES_MAX, gs.MIN_BLOCKS = default
    if args.parts:
        gs, mods = this
        with modules(mods):
            for name, (a, hw, c) in cases.items():
                invalid = (*a[:5], torch.zeros_like(a[5]))
                k0 = [t[:, :0] for t in a]
                shape = (a[0].shape[0], *hw, c)
                t_inv = cs.cuda_ms(lambda: gs.render_heatmap(*invalid, hw, c))
                t_k0 = cs.cuda_ms(lambda: gs.render_heatmap(*k0, hw, c))
                t_fill = cs.cuda_ms(lambda: torch.zeros(shape, device=dev))
                print(f"[parts] {name:8s}: K1 all objects invalid {t_inv:.4f} ms, K1 K=0 "
                      f"{t_k0:.4f} ms, torch.zeros of the map {t_fill:.4f} ms", flush=True)
    print(f"[card] {cs.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
