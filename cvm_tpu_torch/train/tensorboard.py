"""Dependency-free TensorBoard event writer and reader: the port's copy of
``cvm_tpu/train/tensorboard.py`` (plain Python and numpy; held to the
original by ``tests/test_torch_tensorboard.py``: the same scalars, images
and wall times give the same bytes).

The on-disk format, written directly (neither TensorFlow nor the
``tensorboard`` package is needed):

- a TFRecord stream (length, masked-crc32c(length), payload,
  masked-crc32c(payload)) in a file named ``events.out.tfevents.<ts>.<host>``,
- each payload a hand-encoded ``tensorflow.Event`` protobuf
  (``wall_time``=1/double, ``step``=2/int64, ``file_version``=3/string,
  ``summary``=5 -> repeated ``Summary.Value`` with ``tag``=1/string,
  ``simple_value``=2/float).

Image summaries (``write_image``: ``Summary.Value.image``=4 with
``height``=1, ``width``=2, ``colorspace``=3, ``encoded_image_string``=4
holding a hand-encoded PNG) carry ``cli.train --eval_images``' renderings.
Files load in any stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Dict

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — TFRecord framing requires the masked
# variant; zlib.crc32 is the wrong polynomial.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding (varint / fixed64 / fixed32 / bytes).
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int = 0, file_version: str = "",
           scalars: Dict[str, float] = ()) -> bytes:
    msg = _f_double(1, wall_time)
    if step:
        msg += _f_varint(2, step)
    if file_version:
        msg += _f_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, float(val)))
            for tag, val in scalars.items()
        )
        msg += _f_bytes(5, summary)
    return msg


def _png_encode(rgb) -> bytes:
    """uint8 (H, W, 3) → PNG bytes (8-bit RGB, filter 0, one zlib stream) —
    stdlib-only so the writer stays dependency-free."""
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(rgb, np.uint8))
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8 RGB, got {arr.shape}")
    h, w = arr.shape[:2]

    def chunk(typ: bytes, data: bytes) -> bytes:
        body = typ + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, color type 2
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


class TensorBoardWriter:
    """Scalar + image event writer; drop-in sibling of JsonlMetricsWriter."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        clean = {k: float(v) for k, v in metrics.items()}
        self._record(_event(time.time(), step=int(step), scalars=clean))

    def write_image(self, step: int, tag: str, rgb) -> None:
        """Log a uint8 (H, W, 3) RGB image under ``tag`` (TB "Images" tab)."""
        h, w = rgb.shape[:2]
        img = (_f_varint(1, int(h)) + _f_varint(2, int(w))
               + _f_varint(3, 3) + _f_bytes(4, _png_encode(rgb)))
        value = _f_bytes(1, tag.encode()) + _f_bytes(4, img)
        msg = (_f_double(1, time.time()) + _f_varint(2, int(step))
               + _f_bytes(5, _f_bytes(1, value)))
        self._record(msg)

    def close(self) -> None:
        self._f.close()


def read_scalar_events(path: str):
    """Parse an events file back (framing + Event subset) — used by tests
    to prove the format round-trips without TensorBoard installed."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt length crc"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "corrupt payload crc"
            out.append(_parse_event(payload))
    return out


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_image(buf: bytes):
    img = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
            img["height" if field == 1 else "width" if field == 2
                else "colorspace"] = v
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            img["png"] = buf[i:i + ln]
            i += ln
        else:
            raise AssertionError("unexpected Image field")
    return img


def _parse_event(buf: bytes):
    ev = {"scalars": {}}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
            if field == 2:
                ev["step"] = v
        elif wire == 1:
            (v,) = struct.unpack("<d", buf[i:i + 8])
            i += 8
            if field == 1:
                ev["wall_time"] = v
        elif wire == 5:
            i += 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            sub = buf[i:i + ln]
            i += ln
            if field == 3:
                ev["file_version"] = sub.decode()
            elif field == 5:
                j = 0
                while j < len(sub):
                    k2, j = _read_varint(sub, j)
                    if k2 >> 3 == 1 and k2 & 7 == 2:
                        vl, j = _read_varint(sub, j)
                        val_msg = sub[j:j + vl]
                        j += vl
                        tag, sv, img = None, None, None
                        m = 0
                        while m < len(val_msg):
                            k3, m = _read_varint(val_msg, m)
                            if k3 >> 3 == 1 and k3 & 7 == 2:
                                tl, m = _read_varint(val_msg, m)
                                tag = val_msg[m:m + tl].decode()
                                m += tl
                            elif k3 >> 3 == 2 and k3 & 7 == 5:
                                (sv,) = struct.unpack("<f", val_msg[m:m + 4])
                                m += 4
                            elif k3 >> 3 == 4 and k3 & 7 == 2:
                                il, m = _read_varint(val_msg, m)
                                img = _parse_image(val_msg[m:m + il])
                                m += il
                            else:
                                raise AssertionError("unexpected Value field")
                        if tag is not None and img is not None:
                            ev.setdefault("images", {})[tag] = img
                        elif tag is not None:
                            ev["scalars"][tag] = sv
                    else:
                        raise AssertionError("unexpected Summary field")
    return ev
