"""The traffic: the same for the same seed, another for another seed, and
an open loop that counts a late request's wait into its latency."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cvbench.runners import open_loop_batcher as olb
from cvbench.trace import Tracer
from cvbench.traffic import generator as g

MIX = {"pool": 3, "buffer_hw": [64, 96], "src_h": [30, 64], "src_w": [30, 96], "max_objects": 4}


def _pool(seed):
    return g.frame_pool(np.random.default_rng(seed), MIX, 5)


def test_same_seed_same_traffic():
    a, b, c = _pool(7), _pool(7), _pool(8)
    for fa, fb in zip(a, b):
        for k in fa:
            assert np.array_equal(fa[k], fb[k])
    assert any(not np.array_equal(fa["y"], fc["y"]) for fa, fc in zip(a, c))
    s1 = g.poisson_schedule(np.random.default_rng(1), 100.0, 2.0)
    s2 = g.poisson_schedule(np.random.default_rng(1), 100.0, 2.0)
    s3 = g.poisson_schedule(np.random.default_rng(2), 100.0, 2.0)
    assert np.array_equal(s1, s2) and not np.array_equal(s1[:10], s3[:10])
    assert s1.max() < 2.0 and 120 < len(s1) < 280


def test_frames_are_valid_yuv420():
    for f in _pool(3):
        h, w = f["image_hw"][0]
        assert h % 2 == 0 and w % 2 == 0 and h <= 64 and w <= 96
        assert f["u"].shape == (1, 32, 48) and f["y"].dtype == np.uint8


def test_request_order_covers_the_pool():
    o = g.request_order(np.random.default_rng(0), 4, 10)
    assert sorted(o[:4]) == [0, 1, 2, 3] and sorted(o[4:8]) == [0, 1, 2, 3]


def test_reservoir_is_seeded():
    def sample(seed):
        r = g.Reservoir(np.random.default_rng(seed), 5)
        for i in range(100):
            r.offer(i)
        return sorted(r.items)
    assert sample(1) == sample(1) and len(sample(1)) == 5 and sample(1) != sample(2)


class _SlowBatcher:
    """Answers one request at a time, 20 ms each."""

    def __init__(self):
        self.n_requests = self.n_batches = self.n_padded_rows = 0
        self.lock = threading.Lock()

    def submit(self, args, timeout_s=None, enqueue_timeout_s=None):
        with self.lock:
            time.sleep(0.02)
            self.n_requests += 1
            self.n_batches += 1
        return {"scores": np.zeros((1, 1))}


def test_lateness_counts_into_latency():
    pool = _pool(1)
    st = {"batcher": _SlowBatcher(), "pool": pool, "senders": ThreadPoolExecutor(4)}
    try:
        w = olb.window(st, 200.0, 0.5, np.random.default_rng(0),
                       Tracer(False, 0, 0, "/nonexistent", torch.device("cpu")), timeout_s=10)
    finally:
        st["senders"].shutdown(wait=True)
    n = len(w["latency_ms"])
    assert n > 60 and np.isfinite(w["latency_ms"]).all()
    # 50 requests a second are served; the last one waits behind the backlog
    # of ~n requests, timed from when it was due, not from when it was sent.
    assert w["latency_ms"][-1] > 0.5 * (n * 20.0 - 500.0)
    assert olb.p95(w["latency_ms"]) >= np.percentile(w["latency_ms"], 90)
    assert w["requests"] == n


def test_a_missing_request_is_infinitely_late():
    lat = np.array([1.0] * 95 + [np.inf] * 5)
    assert np.isfinite(olb.p95(lat))
    assert np.isinf(olb.p95(np.array([1.0] * 94 + [np.inf] * 6)))
