"""The JPEG serving surfaces of cvm_tpu_torch on the CPU at a tiny size
(``backbone="tiny"``, 32x32 input, a 48x48 pad): ``result_record``, the
HTTP ``ModelServer`` and ``cli.serve --records / --images / --http``.

* ``result_record``: the same output dict gives the reference's JSON line.
* ``ModelServer`` on ``127.0.0.1:0`` over a tiny ``w8a8_fused`` artifact
  (yuv420, buckets 1 and 4; K2's plain version on the CPU): ``/healthz``
  503 until the warmup batch is served, then 200; a POST returns what
  ``ServingModel`` gives for the same decoded image (exactly: the same
  bucket), 16 concurrent POSTs coalesce into batches and each equals its
  direct call (1e-5: another bucket's program); a full queue is 503, bad
  bytes 400, a fault of the decoder itself 500, DMDS refused; ``/metrics`` names are the reference's; a 3D
  model gets each request's ``X-Intrinsics`` (400 when malformed).
* ``cli.serve --records`` and ``--images``: every output line equals the
  line made from the port's eager ``InferencePipeline`` (the artifact's
  posture and calibration) on the same loader batches; ``--http``
  rejects a malformed address, as the reference's CLI does.

Every socket, join and wait has a timeout.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvm_tpu.infer.server import ModelServer as RefServer
from cvm_tpu.infer.server import result_record as ref_result_record
from cvm_tpu.models import get_model
from cvm_tpu_torch.cli.export import calibration_scales, export_model
from cvm_tpu_torch.cli.serve import main as serve_main
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.data.jpeg import decode_jpeg_batch_yuv420
from cvm_tpu_torch.data.loader import RecordLoader
from cvm_tpu_torch.data.records import RecordDataset
from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.infer.runtime import ServingModel
from cvm_tpu_torch.infer.server import DynamicBatcher, ModelServer, result_record
from cvm_tpu_torch.infer.server import server_for_artifact
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.train.loop import Trainer

from test_torch_export import CFG, PAD, write_checkpoint
from test_torch_model import random_bn_stats
from test_torch_records import encode, make_shard

THRESHOLD = 0.0  # every decoded box goes into the record


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jp = get_model("centernet").params_cls(**CFG)
    variables = random_bn_stats(
        get_model("centernet").create_model(jp).init(
            jax.random.PRNGKey(7), jnp.zeros((1, 32, 32, 3)), train=False),
        np.random.default_rng(23))
    cfg = CenternetParams(**dict(CFG, batch_size=4))
    root = tmp_path_factory.mktemp("serve")
    ckdir = write_checkpoint(root / "ck", cfg, convert_variables(variables))
    art = str(root / "art")
    export_model("centernet", ckdir, art, batch_size=4, pad_hw=PAD, quantize="w8a8_fused",
                 input_format="yuv420", batch_sizes=[1, 4], device="cpu")
    tr = Trainer(cfg, "cpu", checkpoint_dir=ckdir)
    tr.init_state()
    model = tr.eval_model()
    eager = InferencePipeline(cfg, model, "cpu", input_format="yuv420",
                              w8a8=calibration_scales(cfg, model, PAD, 3, 4, "cpu"),
                              w8a8_fused=True)
    shard = make_shard(root / "s.cvrec", [(40, 44), (90, 80), (30, 48), (48, 36), (44, 40),
                                          (36, 46)], seed=9)
    return dict(art=art, sm=ServingModel(art, device="cpu"), eager=eager, shard=shard,
                root=root)


@pytest.mark.parametrize("seed", [0, 1])
def test_result_record_is_the_reference_record(seed):
    rng = np.random.default_rng(seed)
    out = {"boxes": rng.uniform(0, 100, (2, 6, 4)).astype(np.float32),
           "scores": rng.uniform(0, 1, (2, 6)).astype(np.float32),
           "classes": rng.integers(0, 5, (2, 6)).astype(np.int32),
           "centers3d": rng.normal(0, 9, (2, 6, 3)).astype(np.float32),
           "dims": rng.uniform(1, 4, (2, 6, 3)).astype(np.float32),
           "yaw": rng.uniform(-3, 3, (2, 6)).astype(np.float32),
           "class_map": rng.integers(0, 4, (2, 5, 5)).astype(np.int32),
           "depth": rng.uniform(0, 50, (2, 5, 5, 1)).astype(np.float32)}
    for i in range(2):
        for thr in (0.0, 0.3, 0.8):
            assert (json.dumps(result_record(out, i, thr))
                    == json.dumps(ref_result_record(out, i, thr)))


class _Http:
    """A ModelServer's ``serve_forever`` on a thread at 127.0.0.1:0."""

    def __init__(self, server):
        self.server, self.port = server, None
        ready = threading.Event()

        def cb(port):
            self.port = port
            ready.set()

        self.thread = threading.Thread(target=server.serve_forever, daemon=True,
                                       kwargs=dict(host="127.0.0.1", port=0, ready_cb=cb))
        self.thread.start()
        assert ready.wait(30)

    def request(self, path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=body,
                                     method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                raw = r.read()
                return r.status, (json.loads(raw) if path != "/metrics" else raw.decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def wait_warm(self, timeout=120):
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self.request("/healthz")[0] == 200:
                return
            time.sleep(0.05)
        raise TimeoutError("the server never went warm")

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _jpegs(n, seed=0, hw=(40, 44)):
    from cvm_tpu_torch.data.synthetic import synthetic_sample

    rng = np.random.default_rng(seed)
    return [encode(synthetic_sample(rng, hw, num_classes=3)["image"]) for _ in range(n)]


def _direct(sm, jpeg_bytes):
    planes = decode_jpeg_batch_yuv420([jpeg_bytes], *PAD)
    return {k: v.numpy() for k, v in sm(*planes).items()}


def test_http_server_serves_the_artifact(setup):
    sm = setup["sm"]
    gate = threading.Event()
    real = sm.__call__

    class Gated:
        """The artifact behind a gate, so /healthz is seen before warmup."""
        meta, input_format, keys, device = sm.meta, sm.input_format, sm.keys, sm.device
        bucket_sizes = sm.bucket_sizes

        def __call__(self, *data):
            assert gate.wait(60)
            return real(*data)

    fx = _Http(server_for_artifact(Gated(), max_wait_ms=100.0, score_threshold=THRESHOLD))
    try:
        code, body = fx.request("/healthz")
        assert code == 503 and body["status"] == "warming"
        gate.set()
        fx.wait_warm()
        assert fx.request("/healthz") == (200, {"status": "ok", "model": "centernet"})
        jpegs = _jpegs(17)
        code, rec = fx.request("/predict", jpegs[0])
        assert code == 200
        assert json.dumps(rec) == json.dumps(result_record(_direct(sm, jpegs[0]), 0, THRESHOLD))
        before = fx.request("/stats")[1]["batches"]
        results = [None] * 16

        def client(i):
            results[i] = fx.request("/predict", jpegs[1 + i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, (code, rec) in enumerate(results):
            want = result_record(_direct(sm, jpegs[1 + i]), 0, THRESHOLD)
            assert code == 200 and rec["classes"] == want["classes"], i
            np.testing.assert_allclose(rec["boxes"], want["boxes"], atol=1e-5)
            np.testing.assert_allclose(rec["scores"], want["scores"], atol=1e-4)
        st = fx.request("/stats")[1]
        assert st["requests"] == 18 and st["batches"] - before < 16  # coalesced
        assert st["batch_size"] == 4 and 0 < st["batch_fill"] <= 1
        code, err = fx.request("/predict", b"\xff\xd8 not a jpeg")
        assert code == 400 and "decode" in err["error"]
        code, text = fx.request("/metrics")
        assert code == 200 and 'cvm_warm{model="centernet"} 1' in text
    finally:
        fx.close()


def test_full_queue_is_503_and_metric_names_are_the_references():
    release = threading.Event()

    def blocked(*data):
        assert release.wait(60)
        return {"depth": np.zeros((data[0].shape[0], 2, 2, 1), np.float32)}

    srv = ModelServer(blocked, batch_size=1, pad_hw=PAD, input_format="rgb", max_wait_ms=1.0)
    srv.batcher.close()
    srv.batcher = DynamicBatcher(blocked, 1, max_wait_ms=1.0, max_queue=1)
    fx = _Http(srv)  # its warmup request occupies the blocked model
    try:
        results = []

        def client():
            results.append(fx.request("/predict", _jpegs(1)[0]))

        threads = [threading.Thread(target=client) for _ in range(2)]
        for t in threads:
            time.sleep(0.3)
            t.start()  # the first is queued, the second finds the queue full
        threads[-1].join(timeout=30)
        assert [c for c, _ in results] == [503]
        release.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert sorted(c for c, _ in results) == [200, 503]
        assert srv.stats()["shed"] == 1
        ref = RefServer(lambda img, hw: {}, batch_size=1, pad_hw=PAD)
        try:
            names = [re.findall(r"^# TYPE (\S+ \S+)", m.metrics_text(), re.M)
                     for m in (srv, ref)]
            assert names[0] == names[1] and len(names[0]) == 10
        finally:
            ref.batcher.close()
    finally:
        release.set()
        fx.close()


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_a_decoder_fault_is_500_not_400(monkeypatch, fmt):
    """A decoder that fails on the card (RuntimeError, data/jpeg.py) is the
    server's fault: 500, counted as an error; bad bytes stay 400."""
    import cvm_tpu_torch.infer.server as server_mod

    srv = ModelServer(lambda *data: {"depth": np.zeros((data[0].shape[0], 2, 2, 1), np.float32)},
                      batch_size=1, pad_hw=PAD, input_format=fmt, max_wait_ms=1.0)
    fx = _Http(srv)
    try:
        fx.wait_warm()
        assert fx.request("/predict", b"not a jpeg")[0] == 400

        def fails(*a, **k):
            raise RuntimeError("the JPEG decoder on cuda:0 failed: a CUDA call failed "
                               "(cudaMalloc: out of memory)")

        monkeypatch.setattr(server_mod, "decode_jpeg_batch", fails)
        monkeypatch.setattr(server_mod, "decode_jpeg_batch_yuv420", fails)
        code, body = fx.request("/predict", _jpegs(1)[0])
        assert code == 500 and "cudaMalloc" in body["error"]
        assert srv.stats()["errors"] == 1
    finally:
        fx.close()


def test_dmds_and_malformed_addresses_are_refused():
    with pytest.raises(ValueError, match="dmds"):
        ModelServer(lambda *a: {}, batch_size=1, pad_hw=PAD, meta={"model": "dmds"})
    for bad in ("localhost", "127.0.0.1:", ":", "host:port"):
        with pytest.raises(SystemExit) as e:
            serve_main(["--artifact", "unused", "--http", bad, "--device", "cpu"])
        assert e.value.code == 2
    from cvm_tpu_torch.cli.serve import parse_http

    assert parse_http(None, "[::1]:8000") == ("::1", 8000)
    assert parse_http(None, ":8001") == ("127.0.0.1", 8001)


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out]


def test_cli_serve_records_equals_the_eager_pipeline(setup, capsys):
    assert serve_main(["--artifact", setup["art"], "--records", setup["shard"], "--device",
                       "cpu", "--score_threshold", str(THRESHOLD)]) == 0
    lines = _lines(capsys)
    loader = RecordLoader(RecordDataset([setup["shard"]]), 4, PAD, shuffle=False, loop=False,
                          output_format="yuv420", drop_remainder=False)
    want = []
    for b in loader:
        out = {k: v.numpy() for k, v in setup["eager"](b).items()}
        want += [result_record(out, i, THRESHOLD) for i in range(b["image_hw"].shape[0])]
    assert [line.pop("input") for line in lines] == [f"rec{i}" for i in range(6)]
    assert json.dumps(lines) == json.dumps(want)
    assert serve_main(["--artifact", setup["art"], "--records", setup["shard"], "--device",
                       "cpu", "--max_batches", "1"]) == 0
    assert len(_lines(capsys)) == 4


def test_cli_serve_images_equals_the_eager_pipeline(setup, capsys, tmp_path):
    jpegs = _jpegs(5, seed=3, hw=(44, 40))
    for i, j in enumerate(jpegs):
        (tmp_path / f"im{i}.jpg").write_bytes(j)
    assert serve_main(["--artifact", setup["art"], "--images", str(tmp_path / "*.jpg"),
                       "--device", "cpu", "--score_threshold", str(THRESHOLD)]) == 0
    lines = _lines(capsys)
    assert [line.pop("input") for line in lines] == [f"im{i}.jpg" for i in range(5)]
    want = []
    for s in (0, 4):
        chunk = jpegs[s:s + 4]
        chunk += [chunk[-1]] * (4 - len(chunk))  # the last chunk padded
        Y, U, V, hw = decode_jpeg_batch_yuv420(chunk, *PAD)
        out = {k: v.numpy() for k, v in setup["eager"](dict(y=Y, u=U, v=V,
                                                            image_hw=hw)).items()}
        want += [result_record(out, i, THRESHOLD) for i in range(min(4, 5 - s))]
    assert json.dumps(lines) == json.dumps(want)


def test_x_intrinsics_reach_a_3d_model():
    """A 3D server passes each request's X-Intrinsics (placeholder ones when
    absent) as the model's last argument; a malformed header is a 400."""
    seen = []

    def model(img, hw, intr):
        seen.append(np.asarray(intr))
        return {"depth": np.zeros((img.shape[0], 2, 2, 1), np.float32)}

    fx = _Http(ModelServer(model, batch_size=1, pad_hw=PAD, input_format="rgb",
                           with_3d=True, max_wait_ms=1.0))
    try:
        fx.wait_warm()
        body = _jpegs(1)[0]
        req = urllib.request.Request(f"http://127.0.0.1:{fx.port}/predict", data=body,
                                     method="POST", headers={"X-Intrinsics": "500,501,20,22"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        np.testing.assert_array_equal(seen[-1], [[500, 501, 20, 22]])
        assert fx.request("/predict", body)[0] == 200
        np.testing.assert_array_equal(seen[-1], [[1.0, 1.0, 0.0, 0.0]])
        for bad in ("1,2,3", "a,b,c,d"):
            req = urllib.request.Request(f"http://127.0.0.1:{fx.port}/predict", data=body,
                                         method="POST", headers={"X-Intrinsics": bad})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == 400
            e.value.close()
    finally:
        fx.close()
