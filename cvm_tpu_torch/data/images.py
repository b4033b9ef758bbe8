"""Image files as JPEG bytes, for ``cli.serve --images``.

Mirrors ``cvm_tpu/data/adapters/common.py::read_image_as_jpeg``: a
``.jpg`` / ``.jpeg`` file passes through untouched (no recompression; its
size read from the frame header); any other format is decoded and encoded
once as JPEG, which needs PIL, and raises naming it where PIL is absent.
The decoders (``data/jpeg.py``) read JPEG only.
"""

from __future__ import annotations

import io
import struct
from typing import Tuple

# Start-of-frame markers (baseline, extended, progressive, lossless, ...):
# 0xC0-0xCF except DHT (C4), JPG (C8) and DAC (CC).
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from a JPEG's start-of-frame header."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):  # markers without a length
            i += 2
            continue
        (seg,) = struct.unpack_from(">H", data, i + 2)
        if marker in _SOF:
            h, w = struct.unpack_from(">HH", data, i + 5)
            return int(h), int(w)
        i += 2 + seg
    raise ValueError("corrupt JPEG: no start-of-frame header")


def read_image_as_jpeg(path: str, quality: int = 95) -> Tuple[bytes, int, int]:
    """Load an image file; return (jpeg_bytes, height, width)."""
    with open(path, "rb") as f:
        data = f.read()
    if path.lower().endswith((".jpg", ".jpeg")):
        h, w = jpeg_size(data)
        return data, h, w
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: only .jpg/.jpeg files are read without PIL; "
                           "re-encoding another format needs PIL, which is not "
                           "installed") from None
    img = Image.open(io.BytesIO(data)).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue(), img.height, img.width
