"""`.cvrec` packed record shards — the framework's label/image store.

The port's copy of ``cvm_tpu/data/records.py`` (numpy only there too):
``RecordWriter``, ``_parse_record``, ``RecordReader``, ``RecordDataset``.
It writes byte-identical shards and reads the reference's
(``tests/test_torch_records.py``). The reference's docstring follows.

Replaces the reference's MongoDB + GridFS label store (SURVEY.md §1 L1) with
a self-contained, mmap-friendly binary shard format: no server process, O(1)
random access via a trailing index, JPEG bytes stored verbatim (decode
happens in the native feeder), labels as compact JSON + typed binary blobs.

Layout (little-endian):
    header : magic b"CVRC" | u32 version | u64 num_records | u64 index_offset
    records: for each record:
        u32 meta_len | meta JSON bytes
        u32 num_blobs
        per blob: u16 name_len | name | u8 dtype | u8 ndim | u32 dims[ndim]
                  | u64 data_len | raw bytes
    index  : num_records x (u64 offset | u64 length)

Blob dtype codes: 0 = raw bytes (e.g. JPEG), 1 = uint8, 2 = int32,
3 = float32, 4 = uint16.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"CVRC"
VERSION = 1

_DTYPE_CODES = {
    None: 0,  # raw bytes
    np.dtype(np.uint8): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.float32): 3,
    np.dtype(np.uint16): 4,
}
_CODE_DTYPES = {1: np.uint8, 2: np.int32, 3: np.float32, 4: np.uint16}


class RecordWriter:
    """Streams records to a shard; call ``close()`` to write header + index."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path + ".tmp", "wb")
        self._f.write(MAGIC + struct.pack("<IQQ", VERSION, 0, 0))  # patched on close
        self._index: List[Tuple[int, int]] = []

    def write(self, meta: Dict[str, Any], blobs: Dict[str, Any]) -> None:
        """meta: JSON-serializable labels. blobs: name → bytes | np.ndarray."""
        buf = io.BytesIO()
        mj = json.dumps(meta, separators=(",", ":")).encode()
        buf.write(struct.pack("<I", len(mj)))
        buf.write(mj)
        buf.write(struct.pack("<I", len(blobs)))
        for name, val in blobs.items():
            nb = name.encode()
            buf.write(struct.pack("<H", len(nb)))
            buf.write(nb)
            if isinstance(val, (bytes, bytearray, memoryview)):
                buf.write(struct.pack("<BB", 0, 0))
                buf.write(struct.pack("<Q", len(val)))
                buf.write(val)
            else:
                arr = np.ascontiguousarray(val)
                if arr.dtype not in _DTYPE_CODES:
                    supported = sorted(str(d) for d in _DTYPE_CODES if d)
                    raise ValueError(
                        f"blob {name!r} has unsupported dtype {arr.dtype}; "
                        f"supported: {supported} (cast float64→float32 / "
                        "int64→int32 before writing)"
                    )
                code = _DTYPE_CODES[arr.dtype]
                buf.write(struct.pack("<BB", code, arr.ndim))
                buf.write(struct.pack(f"<{arr.ndim}I", *arr.shape))
                raw = arr.tobytes()
                buf.write(struct.pack("<Q", len(raw)))
                buf.write(raw)
        data = buf.getvalue()
        self._index.append((self._f.tell(), len(data)))
        self._f.write(data)

    def close(self) -> None:
        index_offset = self._f.tell()
        for off, ln in self._index:
            self._f.write(struct.pack("<QQ", off, ln))
        self._f.seek(len(MAGIC))
        self._f.write(struct.pack("<IQQ", VERSION, len(self._index), index_offset))
        self._f.close()
        os.replace(self.path + ".tmp", self.path)  # atomic publish

    def abort(self) -> None:
        """Discard the in-progress shard (nothing is published)."""
        try:
            self._f.close()
        finally:
            try:
                os.remove(self.path + ".tmp")
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # A failed pack must NOT atomically publish a truncated shard over a
        # previous complete one — abort and let the exception propagate.
        if exc_type is not None:
            self.abort()
            return False
        self.close()


def _parse_record(data: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    off = 0
    (mlen,) = struct.unpack_from("<I", data, off)
    off += 4
    meta = json.loads(data[off : off + mlen])
    off += mlen
    (nblobs,) = struct.unpack_from("<I", data, off)
    off += 4
    blobs: Dict[str, Any] = {}
    for _ in range(nblobs):
        (nlen,) = struct.unpack_from("<H", data, off)
        off += 2
        name = data[off : off + nlen].decode()
        off += nlen
        code, ndim = struct.unpack_from("<BB", data, off)
        off += 2
        dims = struct.unpack_from(f"<{ndim}I", data, off)
        off += 4 * ndim
        (dlen,) = struct.unpack_from("<Q", data, off)
        off += 8
        raw = data[off : off + dlen]
        off += dlen
        if code == 0:
            blobs[name] = raw
        else:
            blobs[name] = np.frombuffer(raw, dtype=_CODE_DTYPES[code]).reshape(dims)
    return meta, blobs


class RecordReader:
    """Random-access reader over one shard (thread-safe via pread)."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        header = os.pread(self._fd, len(MAGIC) + 20, 0)
        if header[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a .cvrec file")
        version, n, index_offset = struct.unpack_from("<IQQ", header, len(MAGIC))
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        raw_index = os.pread(self._fd, 16 * n, index_offset)
        self._index = [
            struct.unpack_from("<QQ", raw_index, 16 * i) for i in range(n)
        ]

    def __len__(self) -> int:
        return len(self._index)

    def get(self, i: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        off, ln = self._index[i]
        return _parse_record(os.pread(self._fd, ln, off))

    def __iter__(self) -> Iterator[Tuple[Dict[str, Any], Dict[str, Any]]]:
        for i in range(len(self)):
            yield self.get(i)

    def close(self) -> None:
        os.close(self._fd)


class RecordDataset:
    """A set of shards (glob or list) presented as one indexable dataset."""

    def __init__(self, paths: Sequence[str]):
        import glob as _glob

        expanded: List[str] = []
        for p in paths:
            hits = sorted(_glob.glob(p)) if any(c in p for c in "*?[") else [p]
            expanded.extend(hits)
        if not expanded:
            raise FileNotFoundError(f"no record shards match {paths}")
        self.readers = [RecordReader(p) for p in expanded]
        self._cum = np.cumsum([0] + [len(r) for r in self.readers])

    def __len__(self) -> int:
        return int(self._cum[-1])

    def get(self, i: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        s = int(np.searchsorted(self._cum, i, side="right") - 1)
        return self.readers[s].get(i - int(self._cum[s]))

    def split_ids(self, val_fraction: float = 0.1, seed: int = 0,
                  shard_index: int = 0, num_shards: int = 1):
        """Deterministic train/val id split (reference's load_ids(), SURVEY.md §2).

        ``shard_index``/``num_shards`` additionally stride-partition the
        TRAIN ids for multi-host input pipelines (each host feeds its own
        slice of the global batch: the process's rank and the world size).
        The val split is identical on every host so eval metrics agree.
        """
        rng = np.random.default_rng(seed)
        ids = rng.permutation(len(self))
        n_val = int(len(self) * val_fraction)
        train = ids[n_val:]
        if num_shards > 1:
            if not (0 <= shard_index < num_shards):
                raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
            train = train[shard_index::num_shards]
        return train.tolist(), ids[:n_val].tolist()
