"""Host input pipeline: record shards -> decoded padded batches -> device.

Mirrors ``cvm_tpu/data/loader.py``: ``_nearest_resize2d``,
``_label_scales``, ``_assemble_labels`` and ``RecordLoader`` (``.cvrec``
shards read, JPEGs decoded straight into the padded batch buffers,
labels assembled and rescaled to the decoded extent, on a background
thread with a bounded prefetch queue and per-stage timing), and
``prefetch_to_device`` (host batches copied to the device ahead of use).

Two changes from the reference. ``RecordLoader`` decodes with the decoder
its ``device`` implies (``data/jpeg.py``: libjpeg on the CPU, nvJPEG on a
card), which there is no falling back from. And a looping loader whose ids
cannot fill one batch raises: the reference's spins forever there
(ROADMAP Queue 3).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cvm_tpu_torch.data.jpeg import (_rgb_to_yuv420_np, _yuv420_to_rgb_np, decode_jpeg_batch,
                                     decode_jpeg_batch_yuv420)
from cvm_tpu_torch.data.records import RecordDataset
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


# Label keys each task expects; missing labels are filled with empty defaults
# so one loader serves every zoo model.
_MAX_OBJECTS_DEFAULT = 128


def _nearest_resize2d(a: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbor resize (no blending — safe for class ids / sparse GT)."""
    ys = np.minimum((np.arange(out_h) * (a.shape[0] / out_h)).astype(np.int64), a.shape[0] - 1)
    xs = np.minimum((np.arange(out_w) * (a.shape[1] / out_w)).astype(np.int64), a.shape[1] - 1)
    return a[ys][:, xs]


def _label_scales(
    metas: List[Dict[str, Any]], decoded_hw: np.ndarray
) -> Optional[np.ndarray]:
    """Per-sample (sy, sx) mapping original-pixel labels → decoded-frame pixels.

    The native feeder DCT-downscales JPEGs larger than the pad buffer by
    1/2..1/8 (jpeg_feeder.cc); labels are stored in original pixels, so
    geometry must follow the decoded frame. None if every scale is 1.
    """
    B = len(metas)
    scales = np.ones((B, 2), np.float64)
    for i, m in enumerate(metas):
        mh, mw = m.get("height"), m.get("width")
        dh, dw = int(decoded_hw[i, 0]), int(decoded_hw[i, 1])
        if mh and mw and (dh, dw) != (1, 1) and (dh != mh or dw != mw):
            scales[i] = (dh / mh, dw / mw)
    return scales if (scales != 1.0).any() else None


def _assemble_labels(
    metas: List[Dict[str, Any]],
    blobs: List[Dict[str, Any]],
    pad_hw: Tuple[int, int],
    max_objects: int,
    decoded_hw: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    B = len(metas)
    Hm, Wm = pad_hw
    out: Dict[str, np.ndarray] = {}
    scales = _label_scales(metas, decoded_hw) if decoded_hw is not None else None

    boxes = np.zeros((B, max_objects, 4), np.float32)
    classes = np.zeros((B, max_objects), np.int32)
    nobj = np.zeros((B,), np.int32)
    # Key-presence (not truthiness) decides emission: a batch whose frames
    # all happen to have zero boxes must still produce boxes/classes/
    # num_objects, or the detection processor KeyErrors (and the train-step
    # pytree structure would flap between batches → retraces).
    any_boxes = any("boxes" in m for m in metas)
    for i, m in enumerate(metas):
        bx = m.get("boxes")
        if bx:
            n = min(len(bx), max_objects)
            b = np.asarray(bx[:n], np.float32)
            if scales is not None:
                sy, sx = scales[i]
                b = b * np.asarray([sx, sy, sx, sy], np.float32)
            boxes[i, :n] = b
            cl = m.get("classes", [0] * n)
            classes[i, :n] = np.asarray(cl[:n], np.int32)
            nobj[i] = n
    if any_boxes:
        out["boxes"] = boxes
        out["classes"] = classes
        out["num_objects"] = nobj

    def _fit(i: int, a: np.ndarray) -> np.ndarray:
        """Align a dense per-pixel label to the decoded frame / pad buffer."""
        if decoded_hw is not None:
            dh, dw = int(decoded_hw[i, 0]), int(decoded_hw[i, 1])
            if (dh, dw) != (1, 1) and a.shape[:2] != (dh, dw):
                a = _nearest_resize2d(a, dh, dw)
        if a.shape[0] > Hm or a.shape[1] > Wm:
            raise ValueError(
                f"dense label {a.shape[:2]} exceeds pad buffer {(Hm, Wm)} for "
                f"sample {metas[i].get('id', i)!r}; raise pad_hw or re-pack "
                "with smaller images"
            )
        return a

    if any("mask" in b for b in blobs):
        # 255 = ignore everywhere a sample lacks a mask (or beyond its valid
        # extent) so unlabeled samples don't train the background class.
        mask = np.full((B, Hm, Wm), 255, np.uint8)
        for i, b in enumerate(blobs):
            if "mask" in b:
                m = _fit(i, b["mask"])
                mask[i, : m.shape[0], : m.shape[1]] = m
        out["mask"] = mask

    if any("depth" in b for b in blobs):
        depth = np.zeros((B, Hm, Wm), np.float32)
        for i, b in enumerate(blobs):
            if "depth" in b:
                d = b["depth"]
                if d.dtype == np.uint16:  # KITTI png convention: depth*256
                    d = d.astype(np.float32) / 256.0
                d = _fit(i, d)
                depth[i, : d.shape[0], : d.shape[1]] = d
        out["depth"] = depth

    if any("loc3d" in m for m in metas):
        loc3d = np.zeros((B, max_objects, 3), np.float32)
        dims3d = np.zeros((B, max_objects, 3), np.float32)
        rot_y = np.zeros((B, max_objects), np.float32)
        for i, m in enumerate(metas):
            if m.get("loc3d"):  # object-free frames carry empty lists
                n = min(len(m["loc3d"]), max_objects)
                loc3d[i, :n] = np.asarray(m["loc3d"][:n], np.float32)
                dims3d[i, :n] = np.asarray(m.get("dims3d", [[0, 0, 0]] * n)[:n], np.float32)
                rot_y[i, :n] = np.asarray(m.get("rot_y", [0.0] * n)[:n], np.float32)
        out["loc3d"] = loc3d
        out["dims3d"] = dims3d
        out["rot_y"] = rot_y

    if any("intrinsics" in m for m in metas):
        intr = np.zeros((B, 4), np.float32)
        for i, m in enumerate(metas):
            intr[i] = np.asarray(m.get("intrinsics", [1.0, 1.0, 0.0, 0.0]), np.float32)
            if scales is not None:  # [fx, fy, cx, cy] live in pixel units
                sy, sx = scales[i]
                intr[i] *= np.asarray([sx, sy, sx, sy], np.float32)
        out["intrinsics"] = intr
    return out


class RecordLoader:
    """Iterates shuffled batches from record shards, decode + pad on host.

    ``device`` picks the JPEG decoder (``data/jpeg.py``): the batches are
    host arrays either way. With ``loop`` and ``drop_remainder``, fewer ids
    than ``batch_size`` raise ValueError (no batch could ever be made)."""

    def __init__(
        self,
        dataset: RecordDataset,
        batch_size: int,
        pad_hw: Tuple[int, int],
        ids: Optional[Sequence[int]] = None,
        max_objects: int = _MAX_OBJECTS_DEFAULT,
        shuffle: bool = True,
        seed: int = 0,
        num_decode_threads: int = 4,
        prefetch_batches: int = 2,
        drop_remainder: bool = True,
        loop: bool = True,
        output_format: str = "rgb",
        target_hw: Tuple[int, int] = (0, 0),
        device: DeviceLike = "cpu",
    ):
        if output_format not in ("rgb", "yuv420"):
            raise ValueError(f"output_format must be rgb|yuv420, got {output_format}")
        self.ds = dataset
        self.batch_size = batch_size
        self.pad_hw = pad_hw
        self.ids = list(ids) if ids is not None else list(range(len(dataset)))
        if loop and len(self.ids) < (batch_size if drop_remainder else 1):
            # The reference's id stream never yields here and its consumer
            # waits forever on the empty queue.
            raise ValueError(
                f"RecordLoader: {len(self.ids)} ids cannot fill one batch of {batch_size} "
                f"(loop=True, drop_remainder={drop_remainder}): add records, lower "
                "batch_size or the val fraction")
        self.device = resolve_device(device)
        self.max_objects = max_objects
        self.shuffle = shuffle
        self.seed = seed
        self.threads = num_decode_threads
        self.prefetch = prefetch_batches
        self.drop_remainder = drop_remainder
        self.loop = loop
        self.output_format = output_format
        # Scale-aware decode: smallest M/8 DCT scale covering the model
        # input (the feeder never decodes pixels the letterbox will discard;
        # labels follow the decoded extent via _label_scales).
        self.target_hw = tuple(target_hw)
        # Per-stage host timing (SURVEY §5 tracing row): cumulative seconds
        # in shard read / JPEG decode / batch+label assembly, on the worker
        # thread. Benign cross-thread float reads; see stats().
        self.stage_seconds = {"read": 0.0, "decode": 0.0, "assemble": 0.0}
        self.batches_assembled = 0

    @contextmanager
    def _stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] += time.perf_counter() - t

    def stats(self) -> Dict[str, float]:
        """Per-stage input-pipeline timing: ms/batch for read (shard pread +
        meta parse), decode (native JPEG), assemble (pad blits + label
        tensors). The decode figure against the device step time tells you
        directly whether serving is host-decode-bound (BENCH_r01 was)."""
        n = max(self.batches_assembled, 1)
        out = {f"{k}_ms_per_batch": 1e3 * v / n
               for k, v in self.stage_seconds.items()}
        out["batches"] = float(self.batches_assembled)
        return out

    def _make_batch(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        r0, d0 = self.stage_seconds["read"], self.stage_seconds["decode"]
        batch = self._make_batch_inner(idxs)
        inner = (self.stage_seconds["read"] - r0) + (self.stage_seconds["decode"] - d0)
        self.stage_seconds["assemble"] += time.perf_counter() - t0 - inner
        self.batches_assembled += 1
        return batch

    def _make_batch_inner(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        metas, blobs, jpegs, raws = [], [], [], []
        with self._stage("read"):
            for i in idxs:
                meta, blob = self.ds.get(int(i))
                metas.append(meta)
                blobs.append(blob)
                jpegs.append(blob.get("jpeg"))
                raws.append(blob.get("image"))

        Hm, Wm = self.pad_hw
        B = len(idxs)
        to_decode = [(i, j) for i, j in enumerate(jpegs) if j is not None]

        if self.output_format == "yuv420":
            Y = np.zeros((B, Hm, Wm), np.uint8)
            U = np.full((B, Hm // 2, Wm // 2), 128, np.uint8)
            V = np.full((B, Hm // 2, Wm // 2), 128, np.uint8)
            hw = np.ones((B, 2), np.int32)
            # Pre-decoded plane blobs (raw-YUV serving shards, cli.repack):
            # the zero-decode fast path — assembly is a pure blit.
            for i, b in enumerate(blobs):
                if "y" in b and "u" in b and "v" in b:
                    to_decode = [(j, d) for j, d in to_decode if j != i]
                    yp, up, vp = b["y"], b["u"], b["v"]
                    h, w = yp.shape
                    if h > Hm or w > Wm:
                        raise ValueError(
                            f"raw yuv planes {(h, w)} exceed pad buffer {(Hm, Wm)} "
                            f"for sample {metas[i].get('id', i)!r}"
                        )
                    Y[i, :h, :w] = yp
                    U[i, : h // 2, : w // 2] = up
                    V[i, : h // 2, : w // 2] = vp
                    hw[i] = (h, w)
            if to_decode:
                if len(to_decode) == B:
                    # Common training case (all-JPEG batch): decode straight
                    # into the batch buffers — no temporary planes, no
                    # per-frame memcpy on the single-core host.
                    with self._stage("decode"):
                        _, _, _, dhw = decode_jpeg_batch_yuv420(
                            [j for _, j in to_decode], Hm, Wm, self.threads,
                            target_hw=self.target_hw, device=self.device, out_yuv=(Y, U, V),
                        )
                    hw[:] = dhw
                else:
                    with self._stage("decode"):
                        dy, du, dv, dhw = decode_jpeg_batch_yuv420(
                            [j for _, j in to_decode], Hm, Wm, self.threads,
                            target_hw=self.target_hw, device=self.device,
                        )
                    for k, (i, _) in enumerate(to_decode):
                        Y[i], U[i], V[i] = dy[k], du[k], dv[k]
                        hw[i] = dhw[k]
            for i, r in enumerate(raws):
                if r is not None:  # pre-decoded uint8 HxWx3 blob
                    h, w = r.shape[:2]
                    r = r[: h - h % 2, : w - w % 2]  # even extent for 4:2:0
                    h, w = r.shape[:2]
                    yq, uq, vq = _rgb_to_yuv420_np(r)
                    Y[i, :h, :w] = yq
                    U[i, : h // 2, : w // 2] = uq
                    V[i, : h // 2, : w // 2] = vq
                    hw[i] = (h, w)
            batch = {"y": Y, "u": U, "v": V, "image_hw": hw}
            batch.update(
                _assemble_labels(metas, blobs, self.pad_hw, self.max_objects, decoded_hw=hw)
            )
            if any(k in b for b in blobs for k in ("jpeg_t1", "image_t1", "y_t1")):
                # Two-frame records (DMDS): second frame as its own plane set,
                # same wire-format savings as frame t.
                Y1 = np.zeros((B, Hm, Wm), np.uint8)
                U1 = np.full((B, Hm // 2, Wm // 2), 128, np.uint8)
                V1 = np.full((B, Hm // 2, Wm // 2), 128, np.uint8)
                for i, b in enumerate(blobs):
                    if "y_t1" in b:  # raw serving shard (cli.repack): blit
                        yp, up, vp = b["y_t1"], b["u_t1"], b["v_t1"]
                        h, w = yp.shape
                        Y1[i, :h, :w] = yp
                        U1[i, : h // 2, : w // 2] = up
                        V1[i, : h // 2, : w // 2] = vp
                j1 = [(i, b["jpeg_t1"]) for i, b in enumerate(blobs)
                      if "jpeg_t1" in b and "y_t1" not in b]
                if j1:
                    with self._stage("decode"):
                        dy, du, dv, _ = decode_jpeg_batch_yuv420(
                            [j for _, j in j1], Hm, Wm, self.threads,
                            target_hw=self.target_hw, device=self.device,
                        )
                    for k, (i, _) in enumerate(j1):
                        Y1[i], U1[i], V1[i] = dy[k], du[k], dv[k]
                for i, b in enumerate(blobs):
                    if "image_t1" in b:
                        r = b["image_t1"]
                        h, w = r.shape[:2]
                        r = r[: h - h % 2, : w - w % 2]
                        h, w = r.shape[:2]
                        yq, uq, vq = _rgb_to_yuv420_np(r)
                        Y1[i, :h, :w] = yq
                        U1[i, : h // 2, : w // 2] = uq
                        V1[i, : h // 2, : w // 2] = vq
                batch["y_t1"] = Y1
                batch["u_t1"] = U1
                batch["v_t1"] = V1
            return batch

        images = np.zeros((B, Hm, Wm, 3), np.uint8)
        hw = np.ones((B, 2), np.int32)
        if to_decode:
            if len(to_decode) == B:
                # All-JPEG batch: decode straight into the batch buffer
                # (no temporary frames + per-frame memcpy).
                with self._stage("decode"):
                    _, dec_hw = decode_jpeg_batch(
                        [j for _, j in to_decode], Hm, Wm, self.threads,
                        target_hw=self.target_hw, device=self.device, out=images,
                    )
                hw[:] = dec_hw
            else:
                with self._stage("decode"):
                    dec, dec_hw = decode_jpeg_batch(
                        [j for _, j in to_decode], Hm, Wm, self.threads,
                        target_hw=self.target_hw, device=self.device,
                    )
                for k, (i, _) in enumerate(to_decode):
                    images[i] = dec[k]
                    hw[i] = dec_hw[k]
        for i, b in enumerate(blobs):
            # Raw-YUV serving shards (cli.repack) read through the RGB
            # format: convert the planes instead of silently yielding a
            # blank frame.
            if "y" in b and "u" in b and "v" in b and raws[i] is None:
                rgb = _yuv420_to_rgb_np(b["y"], b["u"], b["v"])
                h, w = rgb.shape[:2]
                if h > Hm or w > Wm:
                    raise ValueError(
                        f"raw yuv planes {(h, w)} exceed pad buffer {(Hm, Wm)} "
                        f"for sample {metas[i].get('id', i)!r}"
                    )
                images[i, :h, :w] = rgb
                hw[i] = (h, w)
        for i, r in enumerate(raws):
            if r is not None:  # pre-decoded uint8 HxWx3 blob
                h, w = r.shape[:2]
                if h > Hm or w > Wm:
                    raise ValueError(
                        f"pre-decoded image {(h, w)} exceeds pad buffer {(Hm, Wm)} "
                        f"for sample {metas[i].get('id', i)!r}; raise pad_hw or "
                        "re-pack with smaller images"
                    )
                images[i, :h, :w] = r
                hw[i] = (h, w)

        batch = {"image": images, "image_hw": hw}
        batch.update(
            _assemble_labels(metas, blobs, self.pad_hw, self.max_objects, decoded_hw=hw)
        )

        if any(k in b for b in blobs for k in ("jpeg_t1", "image_t1", "y_t1")):
            img1 = np.zeros((B, Hm, Wm, 3), np.uint8)
            j1 = [(i, b["jpeg_t1"]) for i, b in enumerate(blobs) if "jpeg_t1" in b]
            if j1:
                # Same target_hw as frame t: with scale-aware decode both
                # frames MUST land at the same DCT scale — the processor
                # resamples t1 through frame t's image_hw/ROI.
                with self._stage("decode"):
                    dec, _ = decode_jpeg_batch(
                        [j for _, j in j1], Hm, Wm, self.threads,
                        target_hw=self.target_hw, device=self.device,
                    )
                for k, (i, _) in enumerate(j1):
                    img1[i] = dec[k]
            for i, b in enumerate(blobs):
                if "image_t1" in b:
                    r = b["image_t1"]
                    img1[i, : r.shape[0], : r.shape[1]] = r
                elif "y_t1" in b:  # repacked two-frame serving shard
                    r = _yuv420_to_rgb_np(b["y_t1"], b["u_t1"], b["v_t1"])
                    img1[i, : r.shape[0], : r.shape[1]] = r
            batch["image_t1"] = img1
        return batch

    def _id_stream(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        epoch = 0
        while True:
            ids = np.array(self.ids)
            if self.shuffle:
                rng.shuffle(ids)
            for s in range(0, len(ids) - (self.batch_size - 1 if self.drop_remainder else 0), self.batch_size):
                chunk = ids[s : s + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_remainder:
                    break
                yield chunk.tolist()
            epoch += 1
            if not self.loop:
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Background-thread batch assembly with a bounded prefetch queue."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # A consumer that stops early (evaluate_model max_batches, eval
            # image rendering) abandons the queue full: a plain q.put would
            # block this thread forever, leaking it plus the prefetched
            # batches every eval pass. Poll stop instead.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idxs in self._id_stream():
                    if stop.is_set():
                        return
                    if not _put(self._make_batch(idxs)):
                        return
                _put(None)
            except Exception as e:  # surface loader errors to the consumer
                _put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()




def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]], device: torch.device,
                       depth: int = 2, stage: Optional[list] = None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the host batches (dicts of numpy arrays) as tensors on
    ``device``, with ``depth`` copies issued ahead of consumption.

    On a CUDA device each array goes through pinned host memory and a
    ``non_blocking`` copy on the current stream, so the copies of the next
    batches overlap the current step; the caching host allocator keeps a
    pinned buffer until its copy has finished. On the CPU the arrays are
    wrapped without a copy.

    ``stage``: a one-element list shared with the stall watchdog
    (``train/loop.py::Trainer.fit``), set to "await_batch" while the host
    iterator is waited on and "transfer" while a batch is handed to the
    device, as the reference's is: a stall in the first is the input
    pipeline's, in the second the device's.
    """
    st = stage if stage is not None else [None]

    def pull_and_put():
        st[0] = "await_batch"
        batch = next(it)
        st[0] = "transfer"
        return _to_device(batch, device)

    buf: collections.deque = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(depth):
            buf.append(pull_and_put())
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(pull_and_put())
        except StopIteration:
            pass
        yield out
