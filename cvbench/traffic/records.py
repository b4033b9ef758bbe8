"""Training records: a ``.cvrec`` shard of JPEG scenes written from the seed,
and a reader of that format for the reference.

The format (the program's record store, little-endian): header ``b"CVRC"``,
u32 version 1, u64 record count, u64 index offset; each record a u32-length
JSON meta, a u32 blob count and per blob a u16-length name, u8 dtype code
(0 raw bytes), u8 ndim, u32 dims, u64 length and the bytes; then the index,
(u64 offset, u64 length) per record.

A scene is the generator's (noise background, class-coloured rectangles),
at a COCO size, with ``objects_mean`` objects on average (1 + Poisson) and
at most ``max_objects``, their centres at least ``min_sep_px`` apart on one
axis so that no two share a cell of the output map; JPEG quality and chroma
subsampling from the mix (PIL).
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict, List, Tuple

import numpy as np

from cvbench.traffic.generator import COLORS

MAGIC = b"CVRC"


def _objects(rng: np.random.Generator, h: int, w: int, n: int, min_sep: float):
    boxes, centres = [], []
    for _ in range(20 * n):
        if len(boxes) == n:
            break
        bw = int(rng.integers(max(w // 20, 4), max(w // 3, 8)))
        bh = int(rng.integers(max(h // 20, 4), max(h // 3, 8)))
        x0 = int(rng.integers(0, max(w - bw, 1)))
        y0 = int(rng.integers(0, max(h - bh, 1)))
        c = (x0 + bw / 2.0, y0 + bh / 2.0)
        if all(max(abs(c[0] - d[0]), abs(c[1] - d[1])) >= min_sep for d in centres):
            boxes.append([x0, y0, x0 + bw, y0 + bh])
            centres.append(c)
    return boxes


def scene_record(rng: np.random.Generator, mix: dict, num_classes: int, idx: int):
    """(meta, jpeg bytes) of one scene."""
    from PIL import Image

    h = int(rng.integers(mix["src_h"][0], mix["src_h"][1] + 1))
    w = int(rng.integers(mix["src_w"][0], mix["src_w"][1] + 1))
    n = int(min(1 + rng.poisson(mix["objects_mean"] - 1), mix["max_objects"]))
    img = rng.integers(40, 110, (h, w, 3), dtype=np.uint8)
    boxes = _objects(rng, h, w, n, float(mix["min_sep_px"]))
    classes = [int(rng.integers(0, num_classes)) for _ in boxes]
    for (x0, y0, x1, y1), c in zip(boxes, classes):
        img[y0:y1, x0:x1] = COLORS[c]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=int(mix["jpeg_quality"]),
                              subsampling=int(mix["jpeg_subsampling"]))
    meta = {"id": idx, "height": h, "width": w, "boxes": [[float(v) for v in b] for b in boxes],
            "classes": classes}
    return meta, buf.getvalue()


def write_shard(path: str, rng: np.random.Generator, mix: dict, num_classes: int) -> int:
    """Write ``mix["records"]`` scenes to ``path``; returns the bytes written."""
    index: List[Tuple[int, int]] = []
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<IQQ", 1, 0, 0))
        for i in range(int(mix["records"])):
            meta, jpeg = scene_record(rng, mix, num_classes, i)
            mj = json.dumps(meta, separators=(",", ":")).encode()
            rec = (struct.pack("<I", len(mj)) + mj + struct.pack("<I", 1)
                   + struct.pack("<H", 4) + b"jpeg" + struct.pack("<BBQ", 0, 0, len(jpeg)) + jpeg)
            index.append((f.tell(), len(rec)))
            f.write(rec)
        off = f.tell()
        for o, n in index:
            f.write(struct.pack("<QQ", o, n))
        f.seek(len(MAGIC))
        f.write(struct.pack("<IQQ", 1, len(index), off))
        return off + 16 * len(index)


class Shard:
    """The records of one shard: ``get(i) -> (meta, {"jpeg": bytes})``."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        if self.data[:4] != MAGIC:
            raise ValueError(f"{path}: not a record shard")
        _, n, off = struct.unpack_from("<IQQ", self.data, 4)
        self.index = [struct.unpack_from("<QQ", self.data, off + 16 * i) for i in range(n)]

    def __len__(self) -> int:
        return len(self.index)

    def get(self, i: int) -> Tuple[dict, Dict[str, bytes]]:
        o, _ = self.index[i]
        (mlen,) = struct.unpack_from("<I", self.data, o)
        meta = json.loads(self.data[o + 4:o + 4 + mlen])
        p = o + 4 + mlen
        (nb,) = struct.unpack_from("<I", self.data, p)
        p += 4
        blobs = {}
        for _ in range(nb):
            (nl,) = struct.unpack_from("<H", self.data, p)
            name = self.data[p + 2:p + 2 + nl].decode()
            p += 2 + nl
            code, ndim = struct.unpack_from("<BB", self.data, p)
            p += 2 + 4 * ndim
            (dl,) = struct.unpack_from("<Q", self.data, p)
            p += 8
            blobs[name] = self.data[p:p + dl]
            p += dl
        return meta, blobs
