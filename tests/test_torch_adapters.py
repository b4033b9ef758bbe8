"""The port's dataset adapters and ``cli.pack`` against the reference's, on
the CPU at a tiny size.

* Each of the nine ``ADAPTERS`` packs a source tree in its dataset's
  published on-disk layout, built from a seed (``build_tree``), once with
  the reference's adapter and once with the port's: the returned counts,
  every record's meta, every blob and the ``.meta.json`` sidecar are equal
  (the shards byte for byte). The trees carry the cases the adapters
  branch on: PNG sources re-encoded and JPEGs passed through, COCO's
  category-id gaps, crowd and sub-area boxes, missing files, KITTI frames
  without labels or masks, ``DontCare`` lines, RGB semantic PNGs, both
  KITTI-raw depth layouts and a drive without depth, comma10k palette
  colours within and outside the tolerance, nuImages non-key frames and
  unmapped categories, nuScenes objects behind the camera and other
  cameras.
* The published formats of ``tests/test_adapter_fixtures.py`` against the
  port: KITTI's devkit label line and P2 row, COCO's official category ids
  with their gaps, and the hand-computed nuScenes pose chain.
* ``cli.pack``: the same argv gives the same stdout and shard on both
  sides, ``--split`` goes to each adapter's own keyword, and the
  reference's refusals are the port's.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from cvm_tpu.data.adapters import ADAPTERS as REF_ADAPTERS
from cvm_tpu_torch.data.adapters import ADAPTERS

# The source images' sizes: COCO-like landscape and portrait, KITTI-like wide.
_HW = ((24, 40), (40, 24))


def _save(path, arr) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _image(rng, hw=(24, 40)):
    return rng.integers(0, 255, (*hw, 3), dtype=np.uint8)


def _dump(path, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _box(rng, h, w):
    x0, y0 = float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2))
    return [round(x0, 2), round(y0, 2), round(float(rng.uniform(4, w / 2)), 2),
            round(float(rng.uniform(4, h / 2)), 2)]


def _kitti_line(rng, cls):
    b = sorted(rng.uniform(0, 40, 2).round(2)), sorted(rng.uniform(0, 24, 2).round(2))
    dims = rng.uniform(1, 4, 3).round(2)
    loc = np.r_[rng.uniform(-5, 5, 2), rng.uniform(5, 40)].round(2)
    return (f"{cls} {rng.uniform(0, 1):.2f} {int(rng.integers(0, 3))} {rng.uniform(-3, 3):.2f} "
            f"{b[0][0]} {b[1][0]} {b[0][1]} {b[1][1]} {dims[0]} {dims[1]} {dims[2]} "
            f"{loc[0]} {loc[1]} {loc[2]} {rng.uniform(-3, 3):.2f}\n")


_P2 = ("P0: 7.0e+02 0.0 6.0e+02 0.0 0.0 7.0e+02 1.8e+02 0.0 0.0 0.0 1.0 0.0\n"
       "P2: 7.215377e+02 0.0 6.095593e+02 4.485728e+01 0.0 7.215377e+02 1.72854e+02 "
       "2.163791e-01 0.0 0.0 1.0 2.745884e-03\n")


def _kitti_frames(root, rng, n=3, labels=True, calib=True):
    for i in range(n):
        fid = f"{i:06d}"
        _save(f"{root}/training/image_2/{fid}.png", _image(rng))
        if labels and i != 1:  # frame 1: no label file (the testing split)
            lines = [_kitti_line(rng, c) for c in ("Car", "Pedestrian", "Cyclist", "Tram")]
            lines.insert(1, "DontCare -1 -1 -10 1.0 2.0 5.0 6.0 -1 -1 -1 -1000 -1000 -1000 -10\n")
            lines.append(_kitti_line(rng, "Misc"))
            os.makedirs(f"{root}/training/label_2", exist_ok=True)
            with open(f"{root}/training/label_2/{fid}.txt", "w") as f:
                f.writelines(lines)
        if calib and i != 2:  # frame 2: no calib (no intrinsics)
            os.makedirs(f"{root}/training/calib", exist_ok=True)
            with open(f"{root}/training/calib/{fid}.txt", "w") as f:
                f.write(_P2)


def _semantic(rng, hw=(24, 40), rgb=False):
    ids = np.asarray([0, 4, 7, 8, 11, 13, 17, 21, 23, 24, 26, 33], np.uint8)
    sem = ids[rng.integers(0, len(ids), hw)]
    return np.repeat(sem[..., None], 3, -1) if rgb else sem


def build_tree(kind: str, root: str, rng) -> tuple:
    """A tiny source tree of ``kind`` (an ``ADAPTERS`` key) under ``root``
    in the dataset's published layout; returns (positional args before the
    output path, keyword args) for the adapter."""
    if kind == "coco":
        cats = [{"id": i, "name": n} for i, n in ((90, "toothbrush"), (1, "person"),
                                                  (13, "stop sign"), (27, "backpack"),
                                                  (11, "fire hydrant"))]
        images, anns = [], []
        for i in range(5):
            h, w = _HW[i % 2]
            name = f"{i:012d}." + ("png" if i == 3 else "jpg")
            if i != 4:  # image 4: listed, not on disk (skipped)
                _save(f"{root}/val2017/{name}", _image(rng, (h, w)))
            images.append({"id": 100 + i, "file_name": name, "height": h, "width": w})
            for k in range(int(rng.integers(0, 4)) if i != 2 else 0):
                x0, y0, bw, bh = _box(rng, h, w)
                anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                             "category_id": int(rng.choice([1, 11, 13, 27, 90])),
                             "bbox": [x0, y0, bw, bh], "area": bw * bh,
                             "iscrowd": int(k == 2)})
        anns.append({"id": len(anns) + 1, "image_id": 100, "category_id": 13,
                     "bbox": [1.0, 1.0, 1.5, 2.0], "area": 3.0, "iscrowd": 0})  # < min area
        _dump(f"{root}/annotations/instances_val2017.json",
              {"images": images, "annotations": anns, "categories": cats})
        return (root,), {"split": "val2017"}
    if kind == "kitti":
        _kitti_frames(root, rng)
        return (root,), {}
    if kind == "kitti_semseg":
        for i in range(3):
            fid = f"{i:06d}"
            _save(f"{root}/training/image_2/{fid}.png", _image(rng))
            if i != 1:  # frame 1: no semantic PNG (skipped)
                _save(f"{root}/training/semantic/{fid}.png", _semantic(rng, rgb=i == 2))
        return (root,), {}
    if kind == "kitti_multitask":
        _kitti_frames(root, rng, n=4)
        for i in range(4):
            fid = f"{i:06d}"
            _save(f"{root}/training/semantic/{fid}.png", _semantic(rng))
            if i != 3:  # frame 3: no depth (skipped)
                d = (rng.uniform(0, 80, (24, 40)) * 256).astype(np.uint16)
                d[rng.uniform(size=d.shape) < 0.7] = 0
                _save(f"{root}/training/proj_depth/{fid}.png", d)
        return (root,), {}
    if kind == "kitti_raw":
        date = f"{root}/2011_09_26"
        os.makedirs(date, exist_ok=True)
        with open(f"{date}/calib_cam_to_cam.txt", "w") as f:
            f.write("calib_time: 09-Jan-2012 13:57:47\nP_rect_02: 7.215377e+02 0.0 "
                    "6.095593e+02 4.485728e+01 0.0 7.215377e+02 1.72854e+02 2.163791e-01 "
                    "0.0 0.0 1.0 2.745884e-03\n")
        layouts = {"0001": "proj_depth/groundtruth/image_02", "0002": None,
                   "0005": "proj_depth/data"}
        for drive, layout in layouts.items():
            ddir = f"{date}/2011_09_26_drive_{drive}_sync"
            for t in range(3):
                _save(f"{ddir}/image_02/data/{t:010d}.png", _image(rng))
                if layout and t != 1:  # frame 1: no GT depth
                    _save(f"{ddir}/{layout}/{t:010d}.png",
                          (rng.uniform(0, 60, (24, 40)) * 256).astype(np.uint16))
        return (root,), {}
    if kind == "kitti_depth":
        for i, rel in enumerate(("drive_a/0000000005.png", "drive_a/0000000006.png",
                                 "drive_b/0000000009.png", "drive_c/0000000001.png")):
            _save(f"{root}/depth/{rel}", (rng.uniform(0, 60, (24, 40)) * 256).astype(np.uint16))
            if i == 2:  # found by its base name elsewhere in the image tree
                _save(f"{root}/images/other/{os.path.basename(rel)}", _image(rng))
            elif i != 3:  # depth 3: no image anywhere (skipped)
                _save(f"{root}/images/{rel}", _image(rng))
        return (f"{root}/images", f"{root}/depth"), {}
    if kind == "comma10k":
        from cvm_tpu_torch.models.semseg.params import SEMSEG_PALETTE

        pal = np.asarray(SEMSEG_PALETTE, np.int64)
        for name, ext in (("0000_a", "png"), ("0001_b", "jpg"), ("0002_c", "png")):
            _save(f"{root}/imgs/{name}.{ext}", _image(rng))
            if name == "0002_c":  # no mask (skipped)
                continue
            mask = pal[rng.integers(0, len(pal), (24, 40))]
            mask = mask + rng.integers(-6, 7, mask.shape)  # within the tolerance
            mask[rng.uniform(size=(24, 40)) < 0.1] = (17, 200, 9)  # no palette colour
            _save(f"{root}/masks/{name}.png", np.clip(mask, 0, 255).astype(np.uint8))
        return (root,), {}
    if kind == "nuimages":
        v = f"{root}/v1.0-mini"
        cats = [("c0", "vehicle.car"), ("c1", "human.pedestrian.adult"),
                ("c2", "movable_object.barrier"), ("c3", "animal"),
                ("c4", "vehicle.bus.rigid")]
        sds, anns = [], []
        for i in range(4):
            fname = f"samples/CAM_FRONT/n{i}.jpg"
            if i != 3:  # sample 3: not on disk
                _save(f"{root}/{fname}", _image(rng, _HW[i % 2]))
            sds.append({"token": f"sd{i}", "filename": fname, "is_key_frame": i != 1})
            for _ in range(3):
                x0, y0, bw, bh = _box(rng, 24, 24)
                anns.append({"sample_data_token": f"sd{i}",
                             "category_token": cats[int(rng.integers(0, 5))][0],
                             "bbox": [x0, y0, x0 + bw, y0 + bh]})
        _dump(f"{v}/sample_data.json", sds)
        _dump(f"{v}/object_ann.json", anns)
        _dump(f"{v}/category.json", [{"token": t, "name": n} for t, n in cats])
        return (root,), {"version": "v1.0-mini"}
    if kind == "nuscenes":
        v = f"{root}/v1.0-mini"
        sds, poses, anns = [], [], []
        for i, cam in enumerate(("CAM_FRONT", "CAM_FRONT", "CAM_BACK", "CAM_FRONT")):
            fname = f"samples/{cam}/f{i}.jpg"
            _save(f"{root}/{fname}", _image(rng, (48, 80)))
            sds.append({"token": f"sd{i}", "sample_token": f"s{i}", "filename": fname,
                        "is_key_frame": i != 3, "ego_pose_token": f"ep{i}",
                        "calibrated_sensor_token": "cs0"})
            yaw = float(rng.uniform(-np.pi, np.pi))
            poses.append({"token": f"ep{i}",
                          "translation": [*rng.uniform(-50, 50, 2).tolist(), 0.0],
                          "rotation": [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]})
            R = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
            for k, ahead in enumerate((12.0, 25.0, -15.0, 0.3)):  # -15: behind the camera
                lateral = float(rng.uniform(-3, 3))
                xy = R @ np.array([ahead, lateral]) + np.asarray(poses[-1]["translation"][:2])
                oy = float(rng.uniform(-np.pi, np.pi))
                anns.append({"token": f"a{i}{k}", "sample_token": f"s{i}",
                             "instance_token": f"in{k}",
                             "translation": [float(xy[0]), float(xy[1]), 1.0],
                             "size": [1.8, 4.2, 1.6],
                             "rotation": [float(np.cos(oy / 2)), 0.0, 0.0, float(np.sin(oy / 2))]})
        _dump(f"{v}/sample_data.json", sds)
        _dump(f"{v}/ego_pose.json", poses)
        _dump(f"{v}/calibrated_sensor.json", [{
            "token": "cs0", "translation": [1.7, 0.0, 1.5], "rotation": [0.5, -0.5, 0.5, -0.5],
            "camera_intrinsic": [[60.0, 0.0, 40.0], [0.0, 60.0, 24.0], [0.0, 0.0, 1.0]]}])
        _dump(f"{v}/category.json", [{"token": "k0", "name": "vehicle.car"},
                                     {"token": "k1", "name": "human.pedestrian.adult"},
                                     {"token": "k2", "name": "static_object.bicycle_rack"}])
        _dump(f"{v}/instance.json", [{"token": f"in{k}", "category_token": f"k{k % 3}"}
                                     for k in range(4)])
        _dump(f"{v}/sample_annotation.json", anns)
        return (root,), {"version": "v1.0-mini"}
    raise KeyError(kind)


def pack_both(kind: str, tmp_path, seed: int = 0):
    """``kind``'s tree packed by the reference and by the port: (reference
    counts, port counts, reference shard, port shard)."""
    args, kw = build_tree(kind, str(tmp_path / kind), np.random.default_rng(seed))
    ref_out, out = str(tmp_path / f"{kind}.ref.cvrec"), str(tmp_path / f"{kind}.cvrec")
    return REF_ADAPTERS[kind](*args, ref_out, **kw), ADAPTERS[kind](*args, out, **kw), \
        ref_out, out


def assert_same_shard(ref_out: str, out: str) -> None:
    from cvm_tpu.data.records import RecordReader as RefReader
    from cvm_tpu_torch.data.records import RecordReader

    ref, port = RefReader(ref_out), RecordReader(out)
    assert len(ref) == len(port)
    for i in range(len(ref)):
        (m0, b0), (m1, b1) = ref.get(i), port.get(i)
        assert m0 == m1, i
        assert sorted(b0) == sorted(b1), i
        for k in b0:
            a, b = b0[k], b1[k]
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            else:
                assert bytes(a) == bytes(b), (i, k)
    with open(ref_out, "rb") as f0, open(out, "rb") as f1:
        assert f0.read() == f1.read()
    assert os.path.exists(ref_out + ".meta.json") == os.path.exists(out + ".meta.json")
    if os.path.exists(out + ".meta.json"):
        with open(ref_out + ".meta.json") as f0, open(out + ".meta.json") as f1:
            assert f0.read() == f1.read()


def test_the_nine_adapters_are_the_reference_keys():
    assert sorted(ADAPTERS) == sorted(REF_ADAPTERS) == [
        "coco", "comma10k", "kitti", "kitti_depth", "kitti_multitask", "kitti_raw",
        "kitti_semseg", "nuimages", "nuscenes"]


# Each tree's shard: how many records, and what the trees make the adapter do.
_EXPECT = {"coco": 4, "kitti": 3, "kitti_semseg": 2, "kitti_multitask": 3, "kitti_raw": 6,
           "kitti_depth": 3, "comma10k": 2, "nuimages": 2, "nuscenes": 2}


@pytest.mark.parametrize("kind", sorted(_EXPECT))
def test_adapter_writes_the_reference_shard(kind, tmp_path):
    ref_stats, stats, ref_out, out = pack_both(kind, tmp_path)
    assert stats == ref_stats
    assert stats["written"] == _EXPECT[kind]
    assert_same_shard(ref_out, out)


@pytest.mark.parametrize("seed", [1, 2])
def test_nuscenes_and_coco_shards_hold_for_other_seeds(seed, tmp_path):
    """Other draws of the pose chains and boxes (nuScenes' behind-camera
    drop and projection, COCO's id map) give the reference's shards too."""
    for kind in ("nuscenes", "coco"):
        ref_stats, stats, ref_out, out = pack_both(kind, tmp_path / str(seed), seed)
        assert stats == ref_stats
        assert_same_shard(ref_out, out)


def test_max_images_and_splits_follow_the_reference(tmp_path):
    """``max_images`` caps every adapter as the reference's does, and a KITTI
    split or a nuScenes version that is not on disk fails alike."""
    for kind in ("kitti", "kitti_raw", "comma10k", "nuimages"):
        args, kw = build_tree(kind, str(tmp_path / kind), np.random.default_rng(3))
        ref = REF_ADAPTERS[kind](*args, str(tmp_path / f"{kind}.r"), max_images=1, **kw)
        got = ADAPTERS[kind](*args, str(tmp_path / f"{kind}.p"), max_images=1, **kw)
        assert got == ref and got["written"] == 1
        assert_same_shard(str(tmp_path / f"{kind}.r"), str(tmp_path / f"{kind}.p"))
    with pytest.raises(FileNotFoundError):
        ADAPTERS["nuimages"](str(tmp_path / "nuimages"), str(tmp_path / "x"), version="v9")
    assert ADAPTERS["kitti"](str(tmp_path / "kitti"), str(tmp_path / "y"),
                             split="testing") == {"written": 0, "num_classes": 7}


# -- the published formats (tests/test_adapter_fixtures.py) -------------------


def test_kitti_published_label_line_and_p2(tmp_path):
    from test_adapter_fixtures import _KITTI_PUBLISHED_CALIB, _KITTI_PUBLISHED_LABELS

    from cvm_tpu_torch.data.adapters.kitti import (KITTI_CLASSES, _parse_calib_p2,
                                                   _parse_label_file)
    from cvm_tpu_torch.data.label_spec import CLASS_MAPS

    (tmp_path / "000000.txt").write_text(_KITTI_PUBLISHED_LABELS)
    (objs,) = _parse_label_file(str(tmp_path / "000000.txt"))  # DontCare dropped
    assert objs["cls"] == KITTI_CLASSES.index("Pedestrian")
    assert (objs["truncated"], objs["occluded"]) == (0.0, 0)
    np.testing.assert_allclose(objs["bbox"], [712.40, 143.00, 810.73, 307.92])
    np.testing.assert_allclose(objs["dims"], [1.89, 0.48, 1.20])
    np.testing.assert_allclose(objs["loc"], [1.84, 1.47, 8.41])
    assert objs["rot_y"] == pytest.approx(0.01)
    (tmp_path / "calib.txt").write_text(_KITTI_PUBLISHED_CALIB)
    np.testing.assert_allclose(_parse_calib_p2(str(tmp_path / "calib.txt")),
                               [721.5377, 721.5377, 609.5593, 172.854])
    assert _parse_calib_p2(str(tmp_path / "missing.txt")) is None
    assert CLASS_MAPS["kitti"] is KITTI_CLASSES  # one home for the class list


def test_coco_official_category_id_gaps(tmp_path):
    from test_adapter_fixtures import _COCO_OFFICIAL_CATS

    from cvm_tpu_torch.data.records import RecordDataset

    root = tmp_path / "coco"
    _save(str(root / "val2017" / "img0.jpg"), np.full((60, 80, 3), 128, np.uint8))
    _dump(str(root / "annotations" / "instances_val2017.json"), {
        "images": [{"id": 7, "file_name": "img0.jpg", "height": 60, "width": 80}],
        "annotations": [
            {"id": 1, "image_id": 7, "category_id": 13, "bbox": [10.0, 20.0, 30.0, 40.0],
             "area": 1200.0, "iscrowd": 0},
            {"id": 2, "image_id": 7, "category_id": 90, "bbox": [5.0, 5.0, 8.0, 6.0],
             "area": 48.0, "iscrowd": 0},
            {"id": 3, "image_id": 7, "category_id": 1, "bbox": [0.0, 0.0, 50.0, 50.0],
             "area": 2500.0, "iscrowd": 1},
            {"id": 4, "image_id": 7, "category_id": 27, "bbox": [1.0, 1.0, 1.0, 1.0],
             "area": 1.0, "iscrowd": 0}],
        "categories": _COCO_OFFICIAL_CATS})
    out = str(tmp_path / "coco.cvrec")
    assert ADAPTERS["coco"](str(root), out, split="val2017") == {
        "written": 1, "skipped": 0, "num_classes": 5}
    meta, _ = RecordDataset([out]).get(0)
    assert meta["classes"] == [2, 4]  # 13 -> 2, 90 -> 4 (sorted ids 1, 11, 13, 27, 90)
    np.testing.assert_allclose(meta["boxes"], [[10.0, 20.0, 40.0, 60.0], [5.0, 5.0, 13.0, 11.0]])
    with open(out + ".meta.json") as f:
        assert json.load(f)["classes"] == ["person", "fire hydrant", "stop sign", "backpack",
                                           "toothbrush"]


def test_nuscenes_hand_computed_pose_chain(tmp_path):
    import test_adapter_fixtures as fx

    from cvm_tpu_torch.data.adapters.nuscenes import _box_to_camera, _project_box, _quat_to_rot
    from cvm_tpu_torch.data.records import RecordDataset

    R_e, t_e = _quat_to_rot(fx._EGO["rotation"]), np.asarray(fx._EGO["translation"])
    R_c, t_c = _quat_to_rot(fx._CAM["rotation"]), np.asarray(fx._CAM["translation"])
    c_c, R_bc, dims, rot_y = _box_to_camera(fx._ANN, R_e, t_e, R_c, t_c)
    np.testing.assert_allclose(c_c, fx._EXPECT_LOC, atol=1e-9)
    np.testing.assert_allclose(dims, fx._EXPECT_DIMS)
    assert rot_y == pytest.approx(fx._EXPECT_ROT_Y, abs=1e-9)
    np.testing.assert_allclose(_project_box(c_c, R_bc, dims, fx._K, (1280, 720)),
                               fx._EXPECT_BOX, atol=1e-3)

    root, img = tmp_path / "nusc", "samples/CAM_FRONT/frame0.jpg"
    _save(str(root / img), np.full((720, 1280, 3), 100, np.uint8))
    tables = {
        "sample_data": [{"token": "sd0", "sample_token": "s0", "ego_pose_token": "ep0",
                         "calibrated_sensor_token": "cs0", "filename": img,
                         "is_key_frame": True}],
        "ego_pose": [{"token": "ep0", **fx._EGO}],
        "calibrated_sensor": [{"token": "cs0", **fx._CAM, "camera_intrinsic": fx._K.tolist()}],
        "category": [{"token": "cat0", "name": "vehicle.car"}],
        "instance": [{"token": "in0", "category_token": "cat0"}],
        "sample_annotation": [{"token": "an0", "sample_token": "s0", "instance_token": "in0",
                               **fx._ANN}]}
    for name, rows in tables.items():
        _dump(str(root / "v1.0-mini" / f"{name}.json"), rows)
    out = str(tmp_path / "nusc.cvrec")
    assert ADAPTERS["nuscenes"](str(root), out, version="v1.0-mini")["written"] == 1
    meta, _ = RecordDataset([out]).get(0)
    assert meta["classes"] == [0]
    np.testing.assert_allclose(meta["loc3d"], [fx._EXPECT_LOC], atol=1e-9)
    np.testing.assert_allclose(meta["dims3d"], [list(fx._EXPECT_DIMS)])
    np.testing.assert_allclose(meta["rot_y"], [fx._EXPECT_ROT_Y], atol=1e-9)
    np.testing.assert_allclose(meta["boxes"], [fx._EXPECT_BOX], atol=1e-3)
    np.testing.assert_allclose(meta["intrinsics"], [800.0, 800.0, 640.0, 360.0])


# -- cli.pack ----------------------------------------------------------------


def _run(main, argv):
    """(exit code, stdout, stderr) of a CLI main."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("kind,extra", [
    ("coco", ["--split", "val2017"]), ("nuimages", ["--split", "v1.0-mini"]),
    ("kitti_raw", ["--max_images", "2"]), ("kitti_multitask", [])])
def test_cli_pack_is_the_reference_cli(kind, extra, tmp_path):
    from cvm_tpu.cli.pack import main as ref_main
    from cvm_tpu_torch.cli.pack import main

    args, _ = build_tree(kind, str(tmp_path / kind), np.random.default_rng(4))
    common = ["--dataset", kind, "--src", args[0]] + extra
    ref = _run(ref_main, common + ["--out", str(tmp_path / "r.cvrec")])
    got = _run(main, common + ["--out", str(tmp_path / "p.cvrec")])
    assert got[:2] == ref[:2] and got[0] == 0
    assert_same_shard(str(tmp_path / "r.cvrec"), str(tmp_path / "p.cvrec"))


@pytest.mark.parametrize("argv", [
    ["--dataset", "kitti_depth", "--src", "S", "--out", "O"],
    ["--dataset", "comma10k", "--src", "S", "--out", "O", "--split", "train"],
    ["--dataset", "kitti_raw", "--src", "S", "--out", "O", "--split", "train"],
    ["--dataset", "imagenet", "--src", "S", "--out", "O"],
    ["--dataset", "coco", "--out", "O"]])
def test_cli_pack_refuses_as_the_reference(argv):
    from cvm_tpu.cli.pack import main as ref_main
    from cvm_tpu_torch.cli.pack import main

    ref, got = _run(ref_main, argv), _run(main, argv)
    assert got[0] == ref[0] == 2
    assert got[2].splitlines()[-1] == ref[2].splitlines()[-1]


def test_cli_pack_kitti_depth_takes_the_depth_dir(tmp_path):
    from cvm_tpu.cli.pack import main as ref_main
    from cvm_tpu_torch.cli.pack import main

    (images, depth), _ = build_tree("kitti_depth", str(tmp_path / "kd"),
                                    np.random.default_rng(5))
    common = ["--dataset", "kitti_depth", "--src", images, "--depth_dir", depth]
    ref = _run(ref_main, common + ["--out", str(tmp_path / "r.cvrec")])
    got = _run(main, common + ["--out", str(tmp_path / "p.cvrec")])
    assert got[:2] == ref[:2] and json.loads(got[1]) == {"written": 3}
    assert_same_shard(str(tmp_path / "r.cvrec"), str(tmp_path / "p.cvrec"))
