#!/usr/bin/env python3
"""The card decoder's gap to libjpeg on the JPEG layouts and color spaces
of the card tests, for the decoders of several checkouts in one process.

``python3 scripts/jpeg_layout_gaps.py --roots DIR [DIR ...]`` (on the
card's machine, from the root of a checkout; DIR may be ``.``): builds
``<DIR>/cvm_tpu_torch/csrc/jpeg_nvjpeg.cu`` of each checkout with nvcc and
decodes at full scale with it the frames of
``tests/test_torch_kernels_cuda.py`` (made from the committed fixture):
4:4:0 and 4:1:1 (``relaid_frames``, odd-sized), RGB and YCbCr 4:4:4 told
apart by their markers (``color_space_frames``), CMYK (``refused_frames``),
and the whole-ratio layouts 1x4, 4:1:0, its vertical twin, 3x1 and a Cr of
its own ratio (``whole_ratio_frames``). It prints, per checkout and frame,
the mean and max |d| of its RGB against PIL's decode (libjpeg), or the
decoder's return code and hw when it did not decode the frame, with the
card's name and power limit. One JSON line per checkout, then one with
nvJPEG's own verdict on each frame (``data/jpeg.py::nvjpeg_verdict``:
status codes of ``nvjpegGetImageInfo`` and ``nvjpegDecode``, chroma
subsampling enum, component sizes).
"""

from __future__ import annotations

import argparse
import ctypes
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def load_decoder(root: Path) -> ctypes.CDLL:
    """The nvJPEG decoder of the checkout at ``root``, built into this
    checkout's build directory (named by its source's hash)."""
    from cvm_tpu_torch.ops.cuda import _build

    tag = "jpeg_nvjpeg_" + root.resolve().name.replace("-", "_")
    lib = _build._build(tag, root / "cvm_tpu_torch" / "csrc" / "jpeg_nvjpeg.cu", _build._nvcc,
                        _build.NVCC_FLAGS, ("nvjpeg",), ("nvjpeg.h",))
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.cvm_decode_batch.restype = ctypes.c_int
    lib.cvm_decode_batch.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.POINTER(ctypes.c_ulong), u8p] + \
        [ctypes.c_int] * 4 + [ip, ip, ctypes.c_int]
    return lib


def decode(lib: ctypes.CDLL, data: bytes, h: int, w: int) -> np.ndarray:
    out = np.zeros((1, h, w, 3), np.uint8)
    hw = np.zeros((1, 2), np.int32)
    rc = np.zeros(1, np.int32)
    buf = np.frombuffer(data, np.uint8)
    ptrs = (ctypes.c_char_p * 1)(buf.ctypes.data_as(ctypes.c_char_p))
    lens = (ctypes.c_ulong * 1)(len(data))
    lib.cvm_decode_batch(1, ptrs, lens, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h,
                         w, 0, 0, hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                         rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1)
    return int(rc[0]), hw[0].tolist(), out[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--roots", nargs="+", required=True, help="checkout roots to compare")
    args = ap.parse_args(argv)
    import torch
    from PIL import Image
    from test_torch_kernels_cuda import (color_space_frames, refused_frames, relaid_frames,
                                         whole_ratio_frames)

    from cvm_tpu_torch.data.images import jpeg_size

    if not torch.cuda.is_available():
        print("jpeg_layout_gaps: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    frames = dict(relaid_frames(), **{k: v for k, (v, _) in color_space_frames().items()},
                  **refused_frames(), **whole_ratio_frames())
    for root in args.roots:
        lib = load_decoder(Path(root))
        res = {}
        for name, data in frames.items():
            h, w = jpeg_size(data)
            rc, hw, out = decode(lib, data, h, w)
            if rc != 0 or hw != [h, w]:
                res[name] = {"rc": rc, "hw": hw}
                continue
            pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(int)
            d = np.abs(out.astype(int) - pil)
            res[name] = {"hw": [h, w], "mean_abs": float(d.mean()), "max_abs": int(d.max())}
        print(json.dumps({"root": os.path.abspath(root), "card": smi.strip().splitlines()[0],
                          "vs_pil_full_scale": res}), flush=True)
    from cvm_tpu_torch.data.jpeg import nvjpeg_verdict

    print(json.dumps({"nvjpeg_verdict": {name: nvjpeg_verdict(data)
                                         for name, data in frames.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
