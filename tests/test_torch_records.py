"""The record data path of cvm_tpu_torch against the reference, on the CPU at
a tiny size: ``.cvrec`` shards, JPEG decode, ``RecordLoader``.

* Records: the port's ``RecordWriter`` writes byte-identical shards for the
  same meta and blobs (JPEG bytes, uint8, int32, float32, uint16); each
  side reads the other's; ``split_ids`` gives identical ids.
* Decode (``data/jpeg.py``, the port's libjpeg copy, against
  ``cvm_tpu.native``): pixels and ``hw`` identical in RGB and YUV420 at the
  scales 1, 1/2, 1/4 and 1/8 (oversized frames and ``target_hw``), for
  4:4:4, grayscale, odd-sized and corrupt JPEGs, and into a caller's
  buffers; wrong buffers are refused; an unbuildable decoder raises and
  names what is missing; PIL is never needed. A fault of the decoder itself
  (the card decoder's codes 4-6) raises and names it; an image's fault
  (codes 1-3) gives the zero frame.
* The committed fixture (``scripts/make_torch_record_fixture.py``) decodes
  identically here, and the card decoder's arithmetic (modelled in numpy,
  ``test_torch_kernels_cuda.libjpeg_rgb_from_planes``) applied to libjpeg's
  own planes gives libjpeg's RGB identically at full scale, and at 1/2
  within the reference's PIL-fallback gap recorded in the fixture for that
  frame; the numpy model of the RGB -> 4:2:0 conversion
  (``feeder_yuv_from_rgb``) is the libjpeg copy's exactly; and the card
  check's per-frame bounds pass rounding noise and catch a frame off by
  more.
* ``RecordLoader``: the same shards, seed and ids give every array of
  every batch identical to the reference's (RGB and YUV420, ``target_hw``
  on and off, shuffle on and off, a ragged tail, masks and depth resized to
  the decoded frame, 3D labels and intrinsics scaled, two-frame shards,
  raw ``image`` and raw-YUV shards), with the reference's ``stats()``
  keys. A looping loader whose ids cannot fill a batch raises (the
  reference's hangs), and an abandoned iterator releases its thread.
"""

import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import cvm_tpu.native as ref_native
from cvm_tpu.data import records as ref_records
from cvm_tpu.data.loader import RecordLoader as RefLoader
from cvm_tpu_torch.data import jpeg, records
from cvm_tpu_torch.data.images import jpeg_size, read_image_as_jpeg
from cvm_tpu_torch.data.loader import RecordLoader
from cvm_tpu_torch.data.synthetic import synthetic_sample
from cvm_tpu_torch.ops.cuda import _build

PAD = (48, 64)


@pytest.fixture(scope="module", autouse=True)
def reference_decoder():
    """The reference's libjpeg library, loaded (``cvm_tpu.native`` builds it
    with make at first use and falls back to PIL when the load fails, as a
    first build racing another test process's can make it); the load is
    retried until it holds, and the module fails otherwise."""
    yield load_reference_decoder()


def load_reference_decoder():
    for _ in range(120):
        if ref_native.get_lib() is not None:
            return ref_native
        ref_native._TRIED = False
        time.sleep(0.5)
    raise RuntimeError("the reference's libjpeg decoder did not load")


def encode(img, quality=90, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def make_shard(path, sizes, seed=0, mask=False, depth=None, three_d=False, two_frame=False,
               image="jpeg", writer=records.RecordWriter, num_classes=3):
    """A shard of synthetic scenes of the given (H, W) sizes. ``image``:
    "jpeg", "raw" (an ``image`` uint8 blob) or "yuv" (``y``/``u``/``v``
    plane blobs); ``depth``: None, "u16" (KITTI: metres * 256) or "f32"."""
    rng = np.random.default_rng(seed)
    with writer(str(path)) as w:
        for i, (H, W) in enumerate(sizes):
            s = synthetic_sample(rng, (H, W), num_classes=num_classes)
            n = int(s["num_objects"])
            meta = {"id": f"s{i}", "height": H, "width": W,
                    "boxes": s["boxes"][:n].tolist(), "classes": s["classes"][:n].tolist()}
            blobs = {}
            if image == "jpeg":
                blobs["jpeg"] = encode(s["image"])
            elif image == "raw":
                blobs["image"] = s["image"]
            else:
                y, u, v = jpeg._rgb_to_yuv420_np(s["image"][:H - H % 2, :W - W % 2])
                blobs.update(y=y, u=u, v=v)
            if two_frame:
                blobs["jpeg_t1"] = encode(np.roll(s["image"], 2, axis=1))
            if mask:
                blobs["mask"] = s["mask"]
            if depth == "u16":
                blobs["depth"] = (s["depth"] * 256).astype(np.uint16)
            elif depth == "f32":
                blobs["depth"] = s["depth"]
            if three_d or two_frame:
                meta["intrinsics"] = [0.9 * W, 0.9 * W, W / 2.0, H / 2.0]
            if three_d:
                meta["loc3d"] = rng.uniform(1, 30, (n, 3)).round(3).tolist()
                meta["dims3d"] = [[1.6, 1.8, 4.2]] * n
                meta["rot_y"] = rng.uniform(-3, 3, n).round(3).tolist()
            w.write(meta, blobs)
    return str(path)


# -- records ---------------------------------------------------------------


def _blob_set(rng):
    return {"jpeg": encode(rng.integers(0, 255, (20, 28, 3), dtype=np.uint8)),
            "mask": rng.integers(0, 5, (20, 28), dtype=np.uint8),
            "ids": rng.integers(-9, 9, (3, 2), dtype=np.int32),
            "depth": rng.uniform(0, 80, (20, 28)).astype(np.float32),
            "depth16": rng.integers(0, 65535, (20, 28), dtype=np.uint16)}


def test_record_writer_is_byte_identical_and_cross_readable(tmp_path):
    rng = np.random.default_rng(0)
    recs = [({"id": f"r{i}", "height": 20, "width": 28, "boxes": [[1.5, 2, 9, 11]],
              "classes": [i % 3]}, _blob_set(rng)) for i in range(5)]
    for writer, name in ((records.RecordWriter, "port"), (ref_records.RecordWriter, "ref")):
        with writer(str(tmp_path / f"{name}.cvrec")) as w:
            for meta, blobs in recs:
                w.write(meta, blobs)
    port, ref = (tmp_path / "port.cvrec").read_bytes(), (tmp_path / "ref.cvrec").read_bytes()
    assert port == ref
    for reader_cls, path in ((records.RecordReader, "ref.cvrec"),
                             (ref_records.RecordReader, "port.cvrec")):
        r = reader_cls(str(tmp_path / path))
        try:
            assert len(r) == 5
            for (meta, blobs), (m, b) in zip(recs, r):
                assert m == meta and set(b) == set(blobs)
                assert b["jpeg"] == blobs["jpeg"]
                for k in ("mask", "ids", "depth", "depth16"):
                    assert b[k].dtype == blobs[k].dtype
                    np.testing.assert_array_equal(b[k], blobs[k])
        finally:
            r.close()
    with pytest.raises(ValueError, match="unsupported dtype"):
        with records.RecordWriter(str(tmp_path / "bad.cvrec")) as w:
            w.write({}, {"x": np.zeros(3, np.float64)})
    assert not os.path.exists(tmp_path / "bad.cvrec")  # a failed pack publishes nothing


@pytest.mark.parametrize("n,seed", [(10, 0), (37, 3), (96, 1)])
def test_split_ids_are_the_reference_ids(tmp_path, n, seed):
    shards = []
    for k in range(2):
        with records.RecordWriter(str(tmp_path / f"s{k}.cvrec")) as w:
            for i in range(n // 2 + k):
                w.write({"id": i}, {})
        shards.append(str(tmp_path / f"s{k}.cvrec"))
    port = records.RecordDataset([str(tmp_path / "s*.cvrec")])
    ref = ref_records.RecordDataset(shards)
    assert len(port) == len(ref)
    assert port.split_ids(seed=seed) == ref.split_ids(seed=seed)
    assert port.split_ids(0.25, seed, 1, 3) == ref.split_ids(0.25, seed, 1, 3)
    assert port.get(len(port) - 1) == ref.get(len(ref) - 1)
    with pytest.raises(FileNotFoundError):
        records.RecordDataset([str(tmp_path / "none*.cvrec")])


# -- decode ----------------------------------------------------------------


def _frames():
    """JPEGs that decode at each DCT scale into PAD, non-4:2:0 sources, an
    odd-sized frame and corrupt bytes."""
    rng = np.random.default_rng(5)

    def scene(h, w):
        return synthetic_sample(rng, (h, w), num_classes=3)["image"]

    gray = scene(30, 44)[..., 1]
    return [encode(scene(40, 60)),                    # 1/1
            encode(scene(90, 120)),                   # 1/2
            encode(scene(180, 250)),                  # 1/4
            encode(scene(300, 500), quality=70),      # 1/8
            encode(scene(41, 57)),                    # odd extent
            encode(scene(36, 50), subsampling=0),     # 4:4:4
            encode(np.ascontiguousarray(gray)),       # grayscale
            encode(scene(40, 60), progressive=True),
            b"not a jpeg", encode(scene(40, 60))[:300]]


@pytest.mark.parametrize("target", [(0, 0), (20, 30), (40, 56)])
def test_decode_is_the_reference_decode(target):
    frames = _frames()
    got, ghw = jpeg.decode_jpeg_batch(frames, *PAD, 3, target_hw=target)
    want, whw = ref_native.decode_jpeg_batch(frames, *PAD, 3, target_hw=target)
    np.testing.assert_array_equal(ghw, whw)
    np.testing.assert_array_equal(got, want)
    assert whw[8].tolist() == [1, 1] and not got[8].any()
    gy = jpeg.decode_jpeg_batch_yuv420(frames, *PAD, 2, target_hw=target)
    wy = ref_native.decode_jpeg_batch_yuv420(frames, *PAD, 2, target_hw=target)
    for g, w in zip(gy, wy):
        np.testing.assert_array_equal(g, w)
    if target == (0, 0):
        nums = [jpeg._choose_scale_num(*jpeg_size(f), *PAD, 0, 0) for f in frames[:4]]
        assert nums == [8, 4, 2, 1]
        assert [tuple(h) for h in whw[:4]] == [(40, 60), (45, 60), (45, 63), (38, 63)]


def test_decode_into_caller_buffers_and_refusals():
    frames = _frames()[:4]
    want, whw = ref_native.decode_jpeg_batch(frames, *PAD)
    out = np.full((4, *PAD, 3), 7, np.uint8)
    got, ghw = jpeg.decode_jpeg_batch(frames, *PAD, out=out)
    assert got is out
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ghw, whw)
    bufs = (np.full((4, *PAD), 9, np.uint8), np.zeros((4, PAD[0] // 2, PAD[1] // 2), np.uint8),
            np.zeros((4, PAD[0] // 2, PAD[1] // 2), np.uint8))
    got = jpeg.decode_jpeg_batch_yuv420(frames, *PAD, out_yuv=bufs)
    want = ref_native.decode_jpeg_batch_yuv420(frames, *PAD)
    for g, b, w in zip(got[:3], bufs, want[:3]):
        assert g is b
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], want[3])
    for bad in (np.zeros((3, *PAD, 3), np.uint8), np.zeros((4, *PAD, 3), np.int16),
                np.zeros((4, PAD[1], PAD[0], 3), np.uint8).transpose(0, 2, 1, 3)):
        with pytest.raises(ValueError, match="C-contiguous uint8"):
            jpeg.decode_jpeg_batch(frames, *PAD, out=bad)
    with pytest.raises(ValueError, match="out_yuv"):
        jpeg.decode_jpeg_batch_yuv420(frames, *PAD, out_yuv=(bufs[0], bufs[1], bufs[0]))
    with pytest.raises(ValueError, match="even"):
        jpeg.decode_jpeg_batch_yuv420(frames, 47, 64)


def test_decoder_needs_no_pil(monkeypatch):
    frames = _frames()[:2]
    want, _ = ref_native.decode_jpeg_batch(frames, *PAD)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got, _ = jpeg.decode_jpeg_batch(frames, *PAD)
    np.testing.assert_array_equal(got, want)


def test_unbuildable_decoder_raises_and_names_what_is_missing(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no C.. compiler.*no-such-compiler"):
            jpeg.decode_jpeg_batch(_frames()[:1], *PAD)
        with pytest.raises(RuntimeError, match="no C.. compiler"):
            jpeg.decode_jpeg_batch_yuv420(_frames()[:1], *PAD)
    finally:
        _build.load_host_library.cache_clear()
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))
    err = ("jpeg_feeder.cc:19:10: fatal error: jpeglib.h: No such file or directory\n"
           "/usr/bin/ld: cannot find -ljpeg: No such file or directory")
    assert _build._missing(err, ("jpeglib.h",), ("jpeg", "pthread")) == (
        "header jpeglib.h not found; library libjpeg not found")
    assert _build._missing("/usr/bin/ld: cannot find -lnvjpeg", ("nvjpeg.h",),
                           ("nvjpeg",)) == "library libnvjpeg not found"


def test_fixture_decodes_identically_and_the_card_arithmetic_is_libjpegs():
    import chip_smoke
    from test_torch_kernels_cuda import libjpeg_rgb_from_planes

    res = chip_smoke.fixture_decode_check("cpu")
    assert all(res[k]["identical_frames"] == 8 for k in res if k != "case")
    with open(os.path.join(chip_smoke.FIXTURE_DIR, "manifest.json")) as f:
        per_frame = json.load(f)["fallback_gap"]["rgb"]["per_frame"]
    jpegs, _ = chip_smoke.fixture_jpegs()
    Y, U, V, hw = ref_native.decode_jpeg_batch_yuv420(jpegs, 1152, 1152)
    rgb, rhw = ref_native.decode_jpeg_batch(jpegs, 768, 768)
    for i, (h, w) in enumerate(hw.tolist()):
        num = 8 * int(rhw[i][0]) // h
        got = libjpeg_rgb_from_planes(Y[i, :h, :w], U[i, :(h + 1) // 2, :(w + 1) // 2],
                                      V[i, :(h + 1) // 2, :(w + 1) // 2], num)
        want = rgb[i, :rhw[i][0], :rhw[i][1]]
        d = np.abs(got.astype(int) - want)
        if num == 8:
            assert d.max() == 0, i
        else:  # the 1/2-scale frame
            bound = per_frame[i]
            assert d.mean() <= bound["mean_abs"] and d.max() <= bound["max_abs"], (
                d.mean(), d.max())


def test_rgb_to_yuv420_model_is_the_libjpeg_copys():
    import chip_smoke
    from test_torch_kernels_cuda import yuv_follows_rgb

    jpegs, _ = chip_smoke.fixture_jpegs()
    yuv_follows_rgb(jpegs, "cpu", threads=(1,))


def test_other_subsamplings_decode_as_recorded():
    """The fixture's 4:4:4, 4:2:2 and grayscale JPEGs decode to the
    reference's recorded buffers at every scale (and the card check that
    reads them passes here, exactly)."""
    from test_torch_kernels_cuda import check_other_subsamplings

    readings = check_other_subsamplings("cpu")
    assert sorted(readings) == ["422", "444", "gray"]
    assert all(r == (0.0, 0) for v in readings.values() for r in v.values())


@pytest.mark.parametrize("layout", ["4:4:0", "4:1:1"])
def test_440_and_411_planes_have_libjpegs_sizes(layout):
    """``decode_jpeg_planes`` on the CPU: libjpeg's component planes at each
    scale, the chroma of 4:4:0 half as tall and of 4:1:1 a quarter as wide
    as the luma (rounded up), on frames of odd height and width."""
    from test_torch_kernels_cuda import relaid_frames

    data = relaid_frames()[layout]
    H, W = jpeg_size(data)
    assert H % 2 == 1 and W % 2 == 1
    sub_h, sub_w = (2, 1) if layout == "4:4:0" else (1, 4)
    for num in (8, 4, 2, 1):
        Y, U, V = jpeg.decode_jpeg_planes(data, num)
        assert Y.shape == (-(-H * num // 8), -(-W * num // 8))
        assert U.shape == V.shape == (-(-H * num // (8 * sub_h)), -(-W * num // (8 * sub_w)))


def test_440_and_411_upsampling_model_is_libjpegs():
    """The card decoder's arithmetic for 4:4:0 and 4:1:1 (modelled in numpy,
    ``test_torch_kernels_cuda.libjpeg_rgb_upsampled``: h1v2 fancy upsampling
    above 1/8, replication at 1/8; 4:1:1 replicated 4 times across) applied
    to libjpeg's own planes at each scale gives libjpeg's RGB identically,
    at 1/1, 1/2, 1/4 and 1/8, with 1 and 4 threads (the card check
    ``check_440_411``, run here on the CPU decoder); libjpeg's full-scale
    frame is PIL's."""
    from test_torch_kernels_cuda import check_440_411

    assert check_440_411("cpu") == {"4:4:0": (0.0, 0), "4:1:1": (0.0, 0)}


def test_color_space_model_is_libjpegs():
    """libjpeg's guess of a 4:4:4 JPEG's color space from its markers (an
    Adobe transform of 0 or 1, component ids 'R', 'G', 'B', a JFIF marker
    first), as the card decoder copies it: each frame's RGB at every scale
    is libjpeg's planes taken as R, G, B or through the YCbCr tables, as
    ``color_space_frames`` says (the card check ``check_color_spaces``,
    run here on the CPU decoder), and PIL's at full scale."""
    from test_torch_kernels_cuda import check_color_spaces

    assert check_color_spaces("cpu") == {
        name: (0.0, 0) for name in ("adobe 0", "adobe 1", "ids RGB", "JFIF, adobe 0")}


def test_refused_layouts_on_the_cpu():
    """A CMYK JPEG is unreadable to libjpeg (the zero frame, no fault;
    ``check_refused_layouts``)."""
    from test_torch_kernels_cuda import check_refused_layouts

    assert check_refused_layouts("cpu") == {"cmyk": [1, 1]}


def test_whole_ratio_upsampling_model_is_libjpegs():
    """The card decoder's arithmetic for whole-ratio layouts (1x4, 4:1:0,
    its vertical twin, 3x1, a Cr of its own ratio; modelled in numpy,
    ``test_torch_kernels_cuda.libjpeg_rgb_upsampled``: each component at
    libjpeg's DCT size for it, then int_upsample or the fancy 2:1 / 1:2
    upsamplers) applied to libjpeg's own planes at each scale gives
    libjpeg's RGB identically, with 1 and 4 threads (the card check
    ``check_whole_ratios``, run here on the CPU decoder); libjpeg's
    full-scale frame is PIL's."""
    from test_torch_kernels_cuda import check_whole_ratios

    assert check_whole_ratios("cpu") == {
        name: (0.0, 0) for name in ("1x4", "4:1:0", "4:1:0 v", "3x1", "Cr 2x1")}


def _off_by(delta, every, only_frame=None):
    """Wrappers of the CPU decoders that move every ``every``-th valid
    sample of each frame (or of ``only_frame``) by ``delta``."""
    real = jpeg.decode_jpeg_batch, jpeg.decode_jpeg_batch_yuv420

    def nudge(plane, h, w):
        v = plane[:h, :w].copy()
        flat = v.reshape(-1)
        sel = flat[::every].astype(int)
        flat[::every] = np.where(sel + delta <= 255, sel + delta, sel - delta)
        plane[:h, :w] = v

    def rgb(jpegs, *a, device="cpu", **k):
        out, hw = real[0](jpegs, *a, **k)
        for i, (h, w) in enumerate(hw):
            if only_frame in (None, i):
                nudge(out[i], h, w)
        return out, hw

    def yuv(jpegs, *a, device="cpu", **k):
        Y, U, V, hw = real[1](jpegs, *a, **k)
        for i, (h, w) in enumerate(hw):
            if only_frame in (None, i):
                nudge(Y[i], h, w)
                nudge(U[i], (h + 1) // 2, (w + 1) // 2)
        return Y, U, V, hw

    return rgb, yuv


@pytest.mark.parametrize("delta,every,frame,fails", [
    (1, 40, None, None),          # rounding noise: within every bound
    (4, 997, 2, "frame 2 .full"),  # a full-scale frame off by 4 somewhere
    (1, 3, 0, "frame 0 .full"),    # a full-scale frame off by one on a third
    (70, 5000, 7, "frame 7 .reduced"),  # the 1/2 frame beyond its fallback gap
])
def test_card_decode_check_holds_each_frame_to_its_bound(monkeypatch, delta, every, frame,
                                                          fails):
    import chip_smoke

    rgb, yuv = _off_by(delta, every, frame)
    monkeypatch.setattr(jpeg, "decode_jpeg_batch", rgb)
    monkeypatch.setattr(jpeg, "decode_jpeg_batch_yuv420", yuv)
    if fails is None:
        res = chip_smoke.fixture_decode_check(torch.device("cuda"))
        assert res["case"].startswith("b")
        assert res["no_target rgb"]["bound"] == ["idct"] * 7 + ["fallback"]
        assert max(res["target yuv420"]["max_abs"]) == 1
    else:
        with pytest.raises(AssertionError, match=fails):
            chip_smoke.fixture_decode_check(torch.device("cuda"))


class _FaultyDecoder:
    """Stands in for the card decoder's library: every image gets ``code``."""

    def __init__(self, code):
        self.code = code

    def _run(self, n, rc):
        for i in range(n):
            rc[i] = self.code
        return n

    def cvm_decode_batch(self, n, ptrs, lens, out, mh, mw, th, tw, hw, rc, threads):
        return self._run(n, rc)

    def cvm_decode_batch_yuv420(self, n, ptrs, lens, y, u, v, mh, mw, th, tw, hw, rc, threads):
        return self._run(n, rc)

    def cvm_decode_last_error(self):
        return b"cudaMalloc: out of memory"


@pytest.mark.parametrize("code,fails", [(1, None), (3, None), (4, "a CUDA call failed"),
                                        (5, "could not start on the card"),
                                        (6, "nvJPEG failed")])
def test_decoder_faults_raise_and_image_faults_give_zero_frames(monkeypatch, code, fails):
    monkeypatch.setattr(jpeg, "get_lib", lambda device: _FaultyDecoder(code))
    frames = _frames()[:2]
    if fails is None:
        out, hw = jpeg.decode_jpeg_batch(frames, *PAD)
        assert not out.any() and (hw == 1).all()
        Y, U, V, yhw = jpeg.decode_jpeg_batch_yuv420(frames, *PAD)
        assert not Y.any() and (U == 128).all() and (V == 128).all() and (yhw == 1).all()
        return
    for fn in (jpeg.decode_jpeg_batch, jpeg.decode_jpeg_batch_yuv420):
        with pytest.raises(RuntimeError, match=f"{fails}.*cudaMalloc: out of memory"):
            fn(frames, *PAD)


def test_read_image_as_jpeg(tmp_path, monkeypatch):
    img = synthetic_sample(np.random.default_rng(1), (30, 40))["image"]
    data = encode(img)
    (tmp_path / "a.jpg").write_bytes(data)
    (tmp_path / "p.jpeg").write_bytes(encode(img, progressive=True))
    Image.fromarray(img).save(tmp_path / "b.png")
    assert read_image_as_jpeg(str(tmp_path / "a.jpg")) == (data, 30, 40)
    assert read_image_as_jpeg(str(tmp_path / "p.jpeg"))[1:] == (30, 40)
    png, h, w = read_image_as_jpeg(str(tmp_path / "b.png"))
    assert (h, w) == (30, 40) and jpeg_size(png) == (30, 40)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert read_image_as_jpeg(str(tmp_path / "a.jpg"))[0] == data
    with pytest.raises(RuntimeError, match="needs PIL"):
        read_image_as_jpeg(str(tmp_path / "b.png"))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg_size(b"\x89PNG....")


# -- RecordLoader ----------------------------------------------------------

SIZES = [(40, 60), (90, 120), (33, 47), (44, 64), (48, 50), (120, 100), (36, 40)]


def _shard_kwargs(case):
    return {"plain": {}, "dense": dict(mask=True, depth="u16"),
            "dense_f32": dict(mask=True, depth="f32"), "3d": dict(three_d=True),
            "two_frame": dict(two_frame=True), "raw": dict(image="raw"),
            "raw_yuv": dict(image="yuv")}[case]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("case,fmt,target,shuffle", [
    ("plain", "rgb", (0, 0), False), ("plain", "yuv420", (20, 30), True),
    ("dense", "rgb", (20, 30), True), ("dense_f32", "yuv420", (0, 0), False),
    ("3d", "rgb", (20, 30), False), ("3d", "yuv420", (20, 30), True),
    ("two_frame", "rgb", (20, 30), True), ("two_frame", "yuv420", (0, 0), False),
    ("raw", "rgb", (0, 0), True), ("raw", "yuv420", (0, 0), False),
    ("raw_yuv", "rgb", (0, 0), False), ("raw_yuv", "yuv420", (0, 0), True)])
def test_record_loader_batches_are_the_reference_batches(tmp_path, case, fmt, target, shuffle):
    sizes = [s for s in SIZES if case not in ("raw", "raw_yuv") or s[0] <= PAD[0]
             and s[1] <= PAD[1]]
    path = make_shard(tmp_path / "s.cvrec", sizes, seed=len(case), **_shard_kwargs(case))
    kw = dict(batch_size=2, pad_hw=PAD, ids=None, max_objects=6, shuffle=shuffle, seed=3,
              num_decode_threads=2, drop_remainder=False, loop=False, output_format=fmt,
              target_hw=target)
    port = RecordLoader(records.RecordDataset([path]), **kw)
    ref = RefLoader(ref_records.RecordDataset([path]), **kw)
    got, want = list(port), list(ref)
    _assert_batches_equal(got, want)
    assert got[-1]["image_hw"].shape[0] == (len(sizes) % 2 or 2)  # the ragged tail
    if case not in ("raw", "raw_yuv"):  # some frames decoded at a reduced scale
        assert {tuple(h) for b in got for h in b["image_hw"].tolist()} - set(sizes)
    assert set(port.stats()) == set(ref.stats())
    assert port.stats()["batches"] == len(got)


def test_record_loader_loops_and_drops_like_the_reference(tmp_path):
    path = make_shard(tmp_path / "s.cvrec", SIZES, mask=True)
    ds, rds = records.RecordDataset([path]), ref_records.RecordDataset([path])
    train, _ = ds.split_ids(val_fraction=0.3)
    kw = dict(batch_size=2, pad_hw=PAD, ids=train, seed=7, target_hw=(20, 30))
    port, ref = iter(RecordLoader(ds, **kw)), iter(RefLoader(rds, **kw))
    try:
        got = [next(port) for _ in range(5)]   # 5 ids: two epochs and a bit
        want = [next(ref) for _ in range(5)]
    finally:
        port.close()
        ref.close()
    _assert_batches_equal(got, want)


def test_short_shard_raises_instead_of_hanging(tmp_path):
    """7 records under the default 10% split: 7 train ids (int(0.7) = 0 go
    to val) cannot fill a batch of 8. The reference's looping loader never
    yields there and its consumer waits forever; the port's refuses at
    construction. Run on a thread with a timeout."""
    path = make_shard(tmp_path / "s.cvrec", [(40, 48)] * 7)
    ds = records.RecordDataset([path])
    train, val = ds.split_ids()
    assert (len(train), len(val)) == (7, 0)
    result = {}

    def run():
        try:
            next(iter(RecordLoader(ds, 8, PAD, ids=train)))
        except ValueError as e:
            result["err"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert "7 ids cannot fill one batch of 8" in result["err"]
    with pytest.raises(ValueError, match="0 ids"):
        RecordLoader(ds, 8, PAD, ids=[], drop_remainder=False)
    # a non-looping loader just yields nothing; a ragged one yields the 7
    assert list(RecordLoader(ds, 8, PAD, ids=train, loop=False)) == []
    it = iter(RecordLoader(ds, 8, PAD, ids=train, drop_remainder=False))
    try:
        assert next(it)["image_hw"].shape == (7, 2)
    finally:
        it.close()


def test_abandoned_iterator_releases_its_thread(tmp_path):
    path = make_shard(tmp_path / "s.cvrec", SIZES)
    before = set(threading.enumerate())
    it = iter(RecordLoader(records.RecordDataset([path]), 2, PAD, prefetch_batches=1))
    next(it)
    (worker,) = set(threading.enumerate()) - before
    it.close()
    worker.join(timeout=10)
    assert not worker.is_alive()


def test_doctor_reports_the_jpeg_facts(capsys):
    from cvm_tpu_torch.cli import doctor

    report = doctor.run_checks("cpu", probe_iters=2)
    assert report["ok"] and report["model_forward"] == "ok" and report["dispatch_ms"] > 0
    facts = report["jpeg"]
    assert set(facts) == {"jpeglib_h", "libjpeg", "nvjpeg_h", "libnvjpeg", "cxx", "pil",
                          "decoder_cpu", "decoder_cuda"}
    assert facts["decoder_cpu"].startswith("libjpeg") and facts["jpeglib_h"]
    assert doctor.main(["--device", "cpu", "--probe_iters", "1"]) == 0
    assert json.loads(capsys.readouterr().out)["device"] == "cpu"
    bad = doctor.run_checks("cuda:7" if torch.cuda.device_count() < 8 else "tpu")
    assert not bad["ok"]
