"""Online serving: dynamic batching and an HTTP API over an exported
artifact.

Port of ``cvm_tpu/infer/server.py`` (``DynamicBatcher``, ``_Ring``,
``result_record``, ``ModelServer``, ``serve_artifact``; stdlib + numpy
there too):

  client POST /predict (JPEG bytes)
    -> host buffers from the decoder of the serving device (data/jpeg.py)
    -> DynamicBatcher: coalesce up to the batch size or ``max_wait_ms``
    -> one ``ServingModel`` call on the smallest bucket that fits
    -> per-request JSON fan-out (``result_record``)

Endpoints: ``POST /predict`` (image bytes, ``X-Intrinsics: fx,fy,cx,cy``
for a 3D artifact; 400 on an undecodable body, 500 when the decoder or
the dispatch fails, 503 when the queue is full), ``GET /healthz`` (503 until ``warmup()`` has served a batch),
``GET /stats``, ``GET /metrics`` (Prometheus text, the reference's metric
names). DMDS artifacts are refused: they take two frames per request.
Changes from the reference: a ``model_fn`` may return torch tensors (on
any device), each copied to the host once per batch before the fan-out;
the decoder is the one the serving device implies, never a fallback.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420
from cvm_tpu_torch.utils.batch import pad_rows
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class OverloadedError(RuntimeError):
    """The batcher's bounded request queue is full (shed load, retry later)."""


class _Request:
    __slots__ = ("args", "event", "out", "err", "t_enqueue")

    def __init__(self, args: Tuple[np.ndarray, ...]):
        self.args = args  # each array has leading batch dim 1
        self.event = threading.Event()
        self.out: Optional[Dict[str, np.ndarray]] = None
        self.err: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()


class DynamicBatcher:
    """Coalesce concurrent single-item requests into fixed-size batches.

    model_fn(*data_args) takes batch-first arrays with batch == batch_size
    exactly (the exported program's static shape) and returns a dict of
    batch-first arrays. Items are tuples of (1, ...)-shaped arrays.
    """

    def __init__(
        self,
        model_fn: Callable[..., Dict[str, Any]],
        batch_size: int,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        bucket_sizes: Optional[Sequence[int]] = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model_fn = model_fn
        self.batch_size = batch_size
        # Multi-batch artifacts: pad a short collection window to the
        # smallest bucket that fits instead of the full static batch —
        # 2 requests on a {1,4,8} artifact dispatch at 4, not 8.
        self.bucket_sizes = sorted(b for b in (bucket_sizes or [])
                                   if b <= batch_size)
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        # Stats (single-writer: the batcher thread; benign cross-thread reads).
        self.n_requests = 0
        self.n_batches = 0
        self.n_padded_rows = 0
        self.latency_ms = _Ring(1024)  # enqueue -> result, per request
        self.batch_ms = _Ring(1024)   # model_fn wall, per batch
        self._thread = threading.Thread(
            target=self._loop, name="dynamic-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, args: Sequence[np.ndarray],
               timeout_s: float = 120.0,
               enqueue_timeout_s: float = 1.0) -> Dict[str, np.ndarray]:
        """Block until this item's slice of a batched dispatch returns.

        Raises OverloadedError (not a bare queue.Full) when the bounded queue
        stays full for enqueue_timeout_s — callers map it to backpressure
        (HTTP 503), distinct from a dispatch failure (500).
        """
        req = _Request(tuple(np.asarray(a) for a in args))
        for a in req.args:
            if a.shape[:1] != (1,):
                raise ValueError(
                    f"submit() items are single rows with a leading batch dim "
                    f"of 1, got shape {a.shape}"
                )
        try:
            self._q.put(req, timeout=enqueue_timeout_s)
        except queue.Full:
            raise OverloadedError(
                f"request queue full ({self._q.maxsize} pending)"
            ) from None
        if not req.event.wait(timeout_s):
            raise TimeoutError(f"no result within {timeout_s}s")
        if req.err is not None:
            raise RuntimeError(f"batched dispatch failed: {req.err!r}") from req.err
        assert req.out is not None
        return req.out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    # -- batcher thread ------------------------------------------------------

    def _collect(self):
        """One blocking get, then drain up to batch_size within max_wait."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            n = len(batch)
            try:
                target = self.batch_size
                for b in self.bucket_sizes:
                    if b >= n:
                        target = b
                        break
                data = pad_rows(
                    [np.concatenate([r.args[k] for r in batch], axis=0)
                     for k in range(len(batch[0].args))],
                    target,
                )
                pad = target - n
                t0 = time.perf_counter()
                out = self.model_fn(*data)
                out = {k: _to_numpy(v) for k, v in out.items()}
                dt = time.perf_counter() - t0
                self.batch_ms.add(dt * 1e3)
                self.n_batches += 1
                self.n_padded_rows += pad
                now = time.perf_counter()
                for i, r in enumerate(batch):
                    r.out = {k: v[i : i + 1] for k, v in out.items()}
                    self.latency_ms.add((now - r.t_enqueue) * 1e3)
                    self.n_requests += 1
                    r.event.set()
            except Exception as e:  # fan the failure out, keep serving
                for r in batch:
                    r.err = e
                    r.event.set()

    def stats(self) -> Dict[str, Any]:
        total_rows = self.n_requests + self.n_padded_rows
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "batch_size": self.batch_size,
            "batch_fill": round(self.n_requests / total_rows, 4)
            if total_rows else 0.0,
            "latency_ms": self.latency_ms.percentiles(),
            "model_ms": self.batch_ms.percentiles(),
            "queue_depth": self._q.qsize(),
        }


class _Ring:
    """Fixed-size sample ring for percentile stats (no deps, O(1) add)."""

    def __init__(self, n: int):
        self._buf = np.zeros(n, np.float64)
        self._i = 0
        self._full = False

    def add(self, v: float) -> None:
        self._buf[self._i] = v
        self._i = (self._i + 1) % len(self._buf)
        self._full = self._full or self._i == 0

    def percentiles(self) -> Dict[str, float]:
        vals = self._buf if self._full else self._buf[: self._i]
        if not len(vals):
            return {}
        return {
            "p50": round(float(np.percentile(vals, 50)), 2),
            "p90": round(float(np.percentile(vals, 90)), 2),
            "p99": round(float(np.percentile(vals, 99)), 2),
            "n": int(len(vals)),
        }


# -- result shaping (shared with cli.serve's offline path) --------------------


def result_record(out: Dict[str, np.ndarray], i: int,
                  score_threshold: float = 0.3) -> Dict[str, Any]:
    """One image's JSON-safe record from batch-first model outputs."""
    rec: Dict[str, Any] = {}
    if "boxes" in out:
        keep = out["scores"][i] >= score_threshold
        rec["boxes"] = out["boxes"][i][keep].tolist()
        rec["scores"] = np.round(out["scores"][i][keep], 4).tolist()
        rec["classes"] = out["classes"][i][keep].tolist()
        if "centers3d" in out:
            rec["centers3d"] = np.round(out["centers3d"][i][keep], 3).tolist()
            rec["dims"] = np.round(out["dims"][i][keep], 3).tolist()
            rec["yaw"] = np.round(out["yaw"][i][keep], 3).tolist()
    if "class_map" in out:
        rec["class_histogram"] = np.bincount(
            out["class_map"][i].reshape(-1).astype(np.int64), minlength=1
        ).tolist()
    if "depth" in out:
        rec["depth_mean"] = round(float(out["depth"][i].mean()), 4)
    return rec


class ModelServer:
    """HTTP front end: decode request images (the decoder of ``device``,
    ``data/jpeg.py``), batch on the device. ``model`` is a ServingModel (or
    any callable taking the artifact's batch-first arrays, with the
    geometry passed explicitly)."""

    def __init__(
        self,
        model: Callable[..., Dict[str, Any]],
        batch_size: int,
        pad_hw: Tuple[int, int],
        input_format: str = "rgb",
        with_3d: bool = False,
        meta: Optional[Dict[str, Any]] = None,
        max_wait_ms: float = 5.0,
        score_threshold: float = 0.3,
        device: DeviceLike = "cpu",
    ):
        if meta and meta.get("model") == "dmds":
            raise ValueError(
                "dmds artifacts take two frames per request; the single-image "
                "HTTP daemon does not serve them (use cli.serve --records)"
            )
        self.model = model
        self.meta = dict(meta or {})
        self.batch_size = int(batch_size)
        self.pad_hw = tuple(pad_hw)
        self.input_format = input_format
        self.with_3d = bool(with_3d)
        self.score_threshold = float(score_threshold)
        self.device = resolve_device(device)
        self.t_start = time.time()
        self.n_shed = 0    # 503 backpressure responses
        self.n_errors = 0  # 500 decoder or dispatch failures/timeouts
        self.warm = threading.Event()
        self.batcher = DynamicBatcher(
            model, self.batch_size, max_wait_ms=max_wait_ms,
            bucket_sizes=(self.meta.get("batch_sizes")
                          or getattr(model, "bucket_sizes", None)),
        )
        self._httpd: Optional[ThreadingHTTPServer] = None

    # one request's (1, ...) args from raw image bytes
    def _decode(self, body: bytes,
                intrinsics: Optional[Sequence[float]]) -> Tuple[np.ndarray, ...]:
        h, w = self.pad_hw
        if self.input_format == "yuv420":
            y, u, v, hw = decode_jpeg_batch_yuv420([body], h, w, 1, device=self.device)
            if tuple(hw[0]) == (1, 1):
                raise ValueError("image decode failed")
            args: Tuple[np.ndarray, ...] = (y, u, v, hw)
        else:
            img, hw = decode_jpeg_batch([body], h, w, 1, device=self.device)
            if tuple(hw[0]) == (1, 1):
                raise ValueError("image decode failed")
            args = (img, hw)
        if self.with_3d:
            k = np.asarray(
                [intrinsics if intrinsics is not None
                 else (1.0, 1.0, 0.0, 0.0)], np.float32)
            if k.shape != (1, 4):
                raise ValueError("X-Intrinsics must be fx,fy,cx,cy")
            args += (k,)
        return args

    def warmup(self, timeout_s: float = 1800.0) -> None:
        """Serve one synthetic batch so /healthz implies a loaded, working
        program (the first call also builds the kernels and allocates), with
        its own long budget and retries: a warmup that gave up while that is
        in flight would leave /healthz 503 on a server about to work."""
        h, w = self.pad_hw
        rng = np.random.default_rng(0)
        if self.input_format == "yuv420":
            args: Tuple[np.ndarray, ...] = (
                rng.integers(0, 255, (1, h, w), dtype=np.uint8),
                rng.integers(0, 255, (1, h // 2, w // 2), dtype=np.uint8),
                rng.integers(0, 255, (1, h // 2, w // 2), dtype=np.uint8),
                np.asarray([[h, w]], np.int32),
            )
        else:
            args = (
                rng.integers(0, 255, (1, h, w, 3), dtype=np.uint8),
                np.asarray([[h, w]], np.int32),
            )
        if self.with_3d:
            args += (np.asarray([[1.0, 1.0, 0.0, 0.0]], np.float32),)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                self.batcher.submit(
                    args, timeout_s=max(deadline - time.monotonic(), 1.0))
                break
            except (TimeoutError, OverloadedError):
                # Early client requests may already occupy the queue; they
                # warm the program just as well — keep trying until one
                # batch (ours or theirs) has actually been served.
                if self.batcher.n_batches > 0:
                    break
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        self.warm.set()

    def stats(self) -> Dict[str, Any]:
        s = self.batcher.stats()
        s.update(
            model=self.meta.get("model", "?"),
            input_format=self.input_format,
            pad_hw=list(self.pad_hw),
            uptime_s=round(time.time() - self.t_start, 1),
            warm=self.warm.is_set(),
            shed=self.n_shed,
            errors=self.n_errors,
        )
        return s

    def metrics_text(self) -> str:
        """Prometheus text exposition (v0.0.4) of the /stats counters — the
        format every standard scrape/alert stack ingests without an adapter.
        Latency percentiles are exposed as summary-style quantile gauges
        (computed over a bounded sample ring, not a true streaming summary)."""
        s = self.stats()
        model = str(s.get("model", "?"))
        lines = []

        def metric(name, mtype, value, help_, labels=""):
            lines.append(f"# HELP cvm_{name} {help_}")
            lines.append(f"# TYPE cvm_{name} {mtype}")
            lines.append(f'cvm_{name}{{model="{model}"{labels}}} {value}')

        metric("requests_total", "counter", s["requests"],
               "Rows served (including the warmup batch)")
        metric("batches_total", "counter", s["batches"],
               "Device dispatches")
        metric("shed_total", "counter", s["shed"],
               "Requests shed with HTTP 503 (queue saturated)")
        metric("errors_total", "counter", s["errors"],
               "Requests failed with HTTP 500 (dispatch error/timeout)")
        metric("queue_depth", "gauge", s["queue_depth"],
               "Requests waiting for a batch slot")
        metric("batch_fill", "gauge", s["batch_fill"],
               "Fraction of dispatched rows that were real requests")
        metric("uptime_seconds", "gauge", s["uptime_s"],
               "Seconds since server start")
        metric("warm", "gauge", int(s["warm"]),
               "1 once the warmup batch has been served")
        for name, help_ in (("request_latency_ms",
                             "End-to-end request latency (sampled)"),
                            ("model_ms", "Device dispatch time (sampled)")):
            key = "latency_ms" if name == "request_latency_ms" else "model_ms"
            pct = s.get(key) or {}
            lines.append(f"# HELP cvm_{name} {help_}")
            lines.append(f"# TYPE cvm_{name} gauge")
            for q, label in (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99")):
                if q in pct:
                    lines.append(
                        f'cvm_{name}{{model="{model}",quantile="{label}"}} '
                        f"{pct[q]}")
        return "\n".join(lines) + "\n"

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet by default; errors still go to stderr via log_error
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def _json(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/healthz"):
                    code = 200 if server.warm.is_set() else 503
                    self._json(code, {"status": "ok" if code == 200
                                      else "warming",
                                      "model": server.meta.get("model", "?")})
                elif self.path.startswith("/stats"):
                    self._json(200, server.stats())
                elif self.path.startswith("/metrics"):
                    body = server.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                if not self.path.startswith("/predict"):
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if n <= 0 or n > 64 << 20:
                    self._json(400, {"error": "need image bytes in body"})
                    return
                body = self.rfile.read(n)
                intr = None
                if self.headers.get("X-Intrinsics"):
                    try:
                        intr = [float(x) for x in
                                self.headers["X-Intrinsics"].split(",")]
                    except ValueError:
                        self._json(400, {"error": "bad X-Intrinsics"})
                        return
                try:
                    args = server._decode(body, intr)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except RuntimeError as e:  # the decoder failed, not the body
                    server.n_errors += 1
                    self._json(500, {"error": str(e)})
                    return
                try:
                    out = server.batcher.submit(args)
                except OverloadedError as e:
                    server.n_shed += 1
                    self._json(503, {"error": str(e)})
                    return
                except (RuntimeError, TimeoutError) as e:
                    server.n_errors += 1
                    self._json(500, {"error": str(e)})
                    return
                self._json(200, result_record(out, 0, server.score_threshold))

        return Handler

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000,
                      ready_cb: Optional[Callable[[int], None]] = None) -> None:
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        actual_port = self._httpd.server_address[1]
        try:
            # Supervisors stop daemons with SIGTERM: drain cleanly (close the
            # listener + batcher) instead of dying mid-dispatch. Only valid
            # on the main thread — tests run serve_forever on a worker thread
            # and shut down via .shutdown() instead.
            import signal

            signal.signal(signal.SIGTERM,
                          lambda *_: threading.Thread(
                              target=self.shutdown, daemon=True).start())
        except ValueError:
            pass
        # Bind BEFORE warmup so a supervisor sees the socket early, but
        # /healthz stays 503 until the warmup batch has been served.
        t = threading.Thread(target=self.warmup, daemon=True)
        t.start()
        if ready_cb:
            ready_cb(actual_port)
        try:
            self._httpd.serve_forever(poll_interval=0.2)
        finally:
            self._httpd.server_close()
            self.batcher.close()

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()


def serve_artifact(artifact_dir: str, host: str = "127.0.0.1", port: int = 8000,
                   device: DeviceLike = "cuda", ready_cb=None, **kw) -> ModelServer:
    """Build a ModelServer over an exported artifact on ``device`` and
    serve it (blocking)."""
    from cvm_tpu_torch.infer.runtime import ServingModel

    server = server_for_artifact(ServingModel(artifact_dir, device=device), **kw)
    server.serve_forever(host, port, ready_cb=ready_cb)
    return server


def server_for_artifact(model, **kw) -> ModelServer:
    """A ModelServer over a loaded ``ServingModel``: its batch size, pad,
    input format, 3D intrinsics and device."""
    meta = dict(model.meta)
    return ModelServer(model, batch_size=int(meta.get("batch_size", 1)),
                       pad_hw=tuple(meta.get("pad_hw", (0, 0))),
                       input_format=model.input_format,
                       with_3d="intrinsics" in model.keys, meta=meta,
                       device=model.device, **kw)
