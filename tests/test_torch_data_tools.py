"""The port's data tools against the reference's, on the CPU at a tiny size:
``cli.stats`` (``compute_stats``), ``cli.validate`` (``validate``),
``cli.repack`` (``repack_yuv``), ``infer/visualize.py`` and ``cli.inspect``.

* The shards are the adapters' (``test_torch_adapters.build_tree``: COCO
  boxes, KITTI multitask masks and uint16 depth, KITTI-raw two-frame pairs,
  nuScenes 3D labels) and one with planted faults: boxes inverted, out of
  the frame, non-finite or of a class outside the list, a corrupt and a
  truncated JPEG and bytes that are not one, a mask of the wrong size and
  with ids outside the list, negative and non-finite depth, 3D labels of
  the wrong length, a zero focal length, raw-YUV planes of the wrong size
  and an incomplete second frame.
* ``compute_stats`` and ``validate`` return the reference's dicts on each,
  and the CLIs print the same and exit alike (1 on errors).
* ``repack_yuv`` writes the reference's shard byte for byte (the port's
  libjpeg copy against ``cvm_tpu.native``), two-frame records and a
  ``target_hw`` included.
* ``render_sample`` and ``render_record`` write the reference's PNGs pixel
  for pixel: boxes with class names and scores, 3D wireframes, a class map
  and depth overlays (letterboxed), a record's boxes, wireframes, mask and
  sparse uint16 depth, and raw-YUV records; ``cli.inspect`` renders the
  same files with the same summaries (``--t1``, ``--indices`` out of range).
* ``cli.repack --threads 1`` and ``--threads 4`` write byte-equal shards.
* ``cli.validate`` and ``cli.repack`` default to the card.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from cvm_tpu.cli import stats as ref_stats_cli
from cvm_tpu.cli import validate as ref_validate_cli
from cvm_tpu.data.records import RecordWriter
from cvm_tpu_torch.cli import stats as stats_cli
from cvm_tpu_torch.cli import validate as validate_cli

from test_torch_adapters import assert_same_shard, pack_both
from test_torch_records import load_reference_decoder


def _jpeg(rng, hw=(24, 40), quality=85):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_faulty_shard(path: str, seed: int = 0) -> str:
    """A shard whose records each carry faults ``validate`` reports (and a
    clean one first), with a 3-class sidecar."""
    rng = np.random.default_rng(seed)
    good = _jpeg(rng)
    corrupt = bytearray(_jpeg(rng))
    corrupt[len(corrupt) // 2:len(corrupt) // 2 + 40] = bytes(40)
    y = rng.integers(0, 255, (24, 40), dtype=np.uint8)
    uv = rng.integers(0, 255, (12, 20), dtype=np.uint8)
    base = {"height": 24, "width": 40}
    recs = [
        ({"id": "clean", **base, "boxes": [[1.0, 2.0, 10.0, 12.0]], "classes": [2]},
         {"jpeg": good}),
        ({"id": "boxes", **base, "boxes": [[5.0, 5.0, 3.0, 9.0], [30.0, 2.0, 44.5, 20.0],
                                           [1.0, float("nan"), 3.0, 4.0]],
          "classes": [0, 1, 7]}, {"jpeg": good}),
        ({"id": "classes", **base, "boxes": [[1.0, 1.0, 5.0, 5.0]], "classes": []},
         {"jpeg": bytes(corrupt)}),
        ({"id": "truncated", **base}, {"jpeg": good[:150]}),
        ({"id": "not-a-jpeg", **base}, {"jpeg": b"\x89PNG not a jpeg at all"}),
        ({"id": "mask", **base}, {"jpeg": good, "mask": np.full((12, 20), 9, np.uint8)}),
        ({"id": "depth", **base}, {"jpeg": good,
                                   "depth": np.asarray([[1.0, -2.0], [np.inf, 0.0]],
                                                       np.float32)}),
        ({"id": "3d", **base, "boxes": [[1.0, 1.0, 9.0, 9.0]], "classes": [1],
          "dims3d": [[1.5, 0.0, 4.0]], "loc3d": [], "rot_y": [0.1],
          "intrinsics": [0.0, 700.0, 20.0, 12.0]}, {"jpeg": good}),
        ({"id": "size", "height": 30, "width": 40}, {"jpeg": good}),
        ({"id": "yuv", **base}, {"y": y, "u": uv[:11], "y_t1": y, "u_t1": uv, "v_t1": uv}),
        ({"id": "pair", **base}, {"jpeg_t1": good}),
    ]
    with RecordWriter(path) as w:
        for meta, blobs in recs:
            w.write(meta, blobs)
    with open(path + ".meta.json", "w") as f:
        json.dump({"classes": ["a", "b", "c"], "num_records": len(recs)}, f)
    return path


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{name: port-written shard}; the reference's twins are byte-equal."""
    load_reference_decoder()
    root = tmp_path_factory.mktemp("tools")
    out = {}
    for kind in ("coco", "kitti_multitask", "kitti_raw", "nuscenes", "comma10k"):
        _, _, ref_out, port_out = pack_both(kind, root)
        assert_same_shard(ref_out, port_out)
        out[kind] = port_out
    out["faults"] = write_faulty_shard(str(root / "faults.cvrec"))
    return out


def _addresses_out(obj):
    """``obj`` with the object addresses in PIL's messages (``<_io.BytesIO
    object at 0x...>``, which differ from call to call) removed."""
    return json.loads(re.sub(r" at 0x[0-9a-f]+", "", json.dumps(obj)))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


@pytest.mark.parametrize("name", ["coco", "kitti_multitask", "kitti_raw", "nuscenes",
                                  "comma10k", "faults"])
def test_stats_and_validate_are_the_references(shards, name):
    path = shards[name]
    want = ref_stats_cli.compute_stats([path], mask_samples=3, seed=1)
    assert stats_cli.compute_stats([path], mask_samples=3, seed=1) == want
    want = ref_validate_cli.validate([path], sample_decode=16, max_list=40)
    got = validate_cli.validate([path], sample_decode=16, max_list=40, device="cpu")
    assert _addresses_out(got) == _addresses_out(want)
    assert (got["errors"] > 0) == (name == "faults")


def test_validate_reports_each_planted_fault(shards):
    rep = validate_cli.validate([shards["faults"]], sample_decode=16, max_list=40, device="cpu")
    text = "\n".join(rep["error_samples"] + rep["warning_samples"])
    for needle in ("record 1: 1 boxes with x2<=x1", "record 1: non-finite box",
                   "record 1: class id 7 outside [0, 3)", "record 1: box outside the 24x40",
                   "record 2: 1 boxes but 0 classes", "record 3: jpeg", "record 4: jpeg",
                   "record 5: mask (12, 20) != image 24x40", "record 5: mask ids [9]",
                   "record 6: non-finite depth", "record 7: loc3d has 0 entries",
                   "record 7: non-positive 3D", "record 7: non-positive focal",
                   "record 8: jpeg is 24x40 but meta says 30x40",
                   "record 9: u plane (11, 20)", "record 9: raw YUV record missing 'v'",
                   "record 10: jpeg_t1 present without", "record 4: jpeg failed full decode"):
        assert needle in text, needle
    assert rep["sample_decoded_ok"] < rep["records"]


def test_stats_and_validate_clis_print_and_exit_as_the_references(shards, tmp_path):
    for name in ("faults", "kitti_multitask"):
        for argv in (["--data", shards[name], "--json"], ["--data", shards[name]]):
            assert _run(stats_cli.main, argv) == _run(ref_stats_cli.main, argv)
        argv = ["--data", shards[name], "--sample_decode", "4"]
        got = _run(validate_cli.main, argv + ["--device", "cpu"])
        ref = _run(ref_validate_cli.main, argv)
        assert got[0] == ref[0] and _addresses_out(json.loads(got[1])) == _addresses_out(
            json.loads(ref[1]))
        assert got[0] == (1 if name == "faults" else 0)


def test_repack_writes_the_reference_shard(shards, tmp_path):
    from cvm_tpu.cli.repack import repack_yuv as ref_repack
    from cvm_tpu_torch.cli.repack import main as repack_main
    from cvm_tpu_torch.cli.repack import repack_yuv

    for name in ("coco", "kitti_raw", "kitti_multitask"):
        for target in ((0, 0), (12, 20)):
            r, p = str(tmp_path / f"{name}{target}.r"), str(tmp_path / f"{name}{target}.p")
            assert repack_yuv(shards[name], p, target_hw=target, device="cpu") == \
                ref_repack(shards[name], r, target_hw=target)
            assert_same_shard(r, p)
    rc, out = _run(repack_main, ["--src", shards["coco"], "--out", str(tmp_path / "c.cvrec"),
                                 "--target", "12,20", "--device", "cpu"])
    assert rc == 0 and json.loads(out)["written"] == 4
    assert_same_shard(str(tmp_path / "coco(12, 20).r"), str(tmp_path / "c.cvrec"))


def test_repack_threads_write_byte_equal_shards(shards, tmp_path):
    """``cli.repack --threads N`` (the reference's flag, default 4): the
    decoder's thread count changes no byte of the shard."""
    from cvm_tpu_torch.cli.repack import main as repack_main

    outs = []
    for n in ("1", "4"):
        out = tmp_path / f"t{n}.cvrec"
        rc, _ = _run(repack_main, ["--src", shards["coco"], "--out", str(out), "--target",
                                   "12,20", "--threads", n, "--device", "cpu"])
        assert rc == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def _png(path):
    return np.asarray(Image.open(path))


def test_render_sample_is_the_references(tmp_path):
    from cvm_tpu.infer.visualize import render_sample as ref_render
    from cvm_tpu_torch.infer.visualize import render_sample

    rng = np.random.default_rng(3)
    image = rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
    hw = np.asarray([33, 47], np.int32)
    outs = {
        "boxes": dict(boxes=np.float32([[2, 3, 20, 25], [30, 5, 12, 18], [1, 1, 40, 30]]),
                      scores=np.float32([0.9, 0.5, 1.0]), classes=np.int32([1, 4, 2])),
        "3d": dict(boxes=np.float32([[2, 3, 20, 25], [5, 5, 9, 9]]),
                   scores=np.float32([0.8, 0.1]), classes=np.int32([0, 3]),
                   centers3d=np.float32([[0.5, 0.2, 6.0], [1.0, 0.0, 0.2]]),
                   dims=np.float32([[1.5, 1.6, 3.9], [1, 1, 1]]), yaw=np.float32([0.3, -1.0]),
                   intrinsics=np.float32([40.0, 40.0, 23.0, 16.0])),
        "class_map": dict(class_map=rng.integers(0, 5, (32, 48)).astype(np.int32)),
        "depth": dict(depth=rng.uniform(1, 80, (32, 48, 1)).astype(np.float32)),
    }
    names = ["car", "person", "bike", "bus", "truck"]
    for key, out in outs.items():
        for thr, cls in ((0.3, names), (0.0, None)):
            a, b = str(tmp_path / f"{key}_r.png"), str(tmp_path / f"{key}_p.png")
            ref_render(a, image, hw, out, thr, cls)
            render_sample(b, image, hw, out, thr, cls)
            np.testing.assert_array_equal(_png(b), _png(a), err_msg=key)
        arr = render_sample(None, image, hw, out)
        np.testing.assert_array_equal(arr, ref_render(None, image, hw, out))
        assert arr.shape == (33, 47, 3)


def test_render_record_and_cli_inspect_are_the_references(shards, tmp_path):
    from cvm_tpu.cli.inspect import main as ref_inspect
    from cvm_tpu.cli.repack import repack_yuv as ref_repack
    from cvm_tpu.data.records import RecordDataset
    from cvm_tpu.infer.visualize import render_record as ref_render
    from cvm_tpu_torch.cli.inspect import main as inspect_main
    from cvm_tpu_torch.infer.visualize import render_record

    yuv = str(tmp_path / "yuv.cvrec")
    ref_repack(shards["kitti_raw"], yuv)
    drawn = 0
    for name in ("coco", "kitti_multitask", "nuscenes", "comma10k", "yuv"):
        path = yuv if name == "yuv" else shards[name]
        ds = RecordDataset([path])
        for i in range(len(ds)):
            meta, blobs = ds.get(i)
            a, b = str(tmp_path / "r.png"), str(tmp_path / "p.png")
            ref_render(a, meta, blobs, ["c0", "c1", "c2"])
            render_record(b, meta, blobs, ["c0", "c1", "c2"])
            np.testing.assert_array_equal(_png(b), _png(a), err_msg=f"{name} {i}")
            drawn += bool(meta.get("loc3d"))
    assert drawn  # the nuScenes records carry wireframes
    with pytest.raises(ValueError, match="no image blob"):
        render_record(str(tmp_path / "x.png"), {"id": "bare"}, {})

    for name, extra in (("nuscenes", []), ("kitti_raw", ["--t1", "--indices", "0,3,99"]),
                        ("kitti_multitask", ["--num", "2"])):
        got_dir, ref_dir = tmp_path / f"p_{name}", tmp_path / f"r_{name}"
        got = _run(inspect_main, ["--data", shards[name], "--out", str(got_dir)] + extra)
        ref = _run(ref_inspect, ["--data", shards[name], "--out", str(ref_dir)] + extra)
        assert got[0] == ref[0] == 0
        assert got[1].replace(str(got_dir), "OUT") == ref[1].replace(str(ref_dir), "OUT")
        files = sorted(os.listdir(ref_dir))
        assert files == sorted(os.listdir(got_dir)) and files
        for f in files:
            np.testing.assert_array_equal(_png(got_dir / f), _png(ref_dir / f), err_msg=f)


def test_validate_and_repack_default_to_the_card(shards, tmp_path):
    from cvm_tpu_torch.cli.repack import main as repack_main

    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_cli.main(["--data", shards["coco"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repack_main(["--src", shards["coco"], "--out", str(tmp_path / "y.cvrec")])
