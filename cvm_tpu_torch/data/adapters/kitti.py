"""KITTI adapters: 2D/3D object detection + sparse depth → `.cvrec`.

The port's copy of ``cvm_tpu/data/adapters/kitti.py`` (numpy, json and PIL
there too); the shards it writes are the reference's, byte for byte.

Reference: data/kitti upload script (SURVEY.md §2). Covers:
- object detection: image_2/*.png + label_2/*.txt (+ optional calib P2 for
  intrinsics and 3D targets),
- depth completion/prediction: raw images + proj_depth uint16 PNGs
  (depth = png / 256, the KITTI convention).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

from cvm_tpu_torch.data.adapters.common import load_png_u16, read_image_as_jpeg
from cvm_tpu_torch.data.records import RecordWriter

# KITTI class → contiguous id (the reference's OD_CLASS_MAPPING analogue).
KITTI_CLASSES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting", "Cyclist", "Tram")
_KITTI_MAP = {n: i for i, n in enumerate(KITTI_CLASSES)}


def _parse_label_file(path: str) -> List[dict]:
    objs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] in ("DontCare", "Misc"):
                continue
            if parts[0] not in _KITTI_MAP:
                continue
            objs.append(
                {
                    "cls": _KITTI_MAP[parts[0]],
                    "truncated": float(parts[1]),
                    "occluded": int(parts[2]),
                    "bbox": [float(x) for x in parts[4:8]],  # l, t, r, b
                    "dims": [float(x) for x in parts[8:11]],  # h, w, l
                    "loc": [float(x) for x in parts[11:14]],  # x, y, z (cam)
                    "rot_y": float(parts[14]),
                }
            )
    return objs


def _parse_calib_p2(path: str) -> Optional[List[float]]:
    """P2 projection → [fx, fy, cx, cy]."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("P2:"):
                    v = [float(x) for x in line.split()[1:]]
                    return [v[0], v[5], v[2], v[6]]
    except OSError:
        return None
    return None


def pack_kitti_object(
    src_dir: str,
    out_path: str,
    split: str = "training",
    max_images: Optional[int] = None,
    with_3d: bool = True,
) -> Dict[str, int]:
    """src_dir: KITTI object root with <split>/{image_2, label_2, calib}."""
    img_dir = os.path.join(src_dir, split, "image_2")
    lbl_dir = os.path.join(src_dir, split, "label_2")
    cal_dir = os.path.join(src_dir, split, "calib")
    frames = sorted(
        os.path.splitext(os.path.basename(p))[0] for p in glob.glob(os.path.join(img_dir, "*.png"))
    )
    n = 0
    with RecordWriter(out_path) as w:
        for fid in frames:
            if max_images is not None and n >= max_images:
                break
            jpeg, h, wd = read_image_as_jpeg(os.path.join(img_dir, f"{fid}.png"))
            lbl_path = os.path.join(lbl_dir, f"{fid}.txt")
            # The testing split ships no label_2 — pack with empty labels
            # rather than crashing (and never publish a truncated shard).
            objs = _parse_label_file(lbl_path) if os.path.exists(lbl_path) else []
            meta = {
                "id": fid,
                "height": h,
                "width": wd,
                "boxes": [o["bbox"] for o in objs],
                "classes": [o["cls"] for o in objs],
            }
            if with_3d:
                # Keys present even for object-free frames: the loader emits
                # 3D arrays on key presence, keeping the train-step pytree
                # structure identical across batches (no retraces).
                meta["dims3d"] = [o["dims"] for o in objs]
                meta["loc3d"] = [o["loc"] for o in objs]
                meta["rot_y"] = [o["rot_y"] for o in objs]
            intr = _parse_calib_p2(os.path.join(cal_dir, f"{fid}.txt"))
            if intr is not None:
                meta["intrinsics"] = intr
            w.write(meta, {"jpeg": jpeg})
            n += 1
    with open(out_path + ".meta.json", "w") as f:
        json.dump({"classes": list(KITTI_CLASSES), "num_records": n}, f)
    return {"written": n, "num_classes": len(KITTI_CLASSES)}


# Cityscapes labelId → trainId (KITTI semantics uses Cityscapes ids).
# 255 = ignore. 19 training classes, standard mapping.
_CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}
KITTI_SEMSEG_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic_light",
    "traffic_sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)


def pack_kitti_semseg(
    src_dir: str,
    out_path: str,
    split: str = "training",
    max_images: Optional[int] = None,
) -> Dict[str, int]:
    """KITTI pixel-level semantics (data_semantics): image_2 + semantic PNGs.

    Labels carry Cityscapes ids; remapped to the 19-class train-id space at
    pack time (255 = ignore), per BASELINE config A's KITTI semseg workload.
    """
    img_dir = os.path.join(src_dir, split, "image_2")
    sem_dir = os.path.join(src_dir, split, "semantic")
    frames = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(img_dir, "*.png"))
    )
    lut = np.full(256, 255, np.uint8)
    for k, v in _CITYSCAPES_ID_TO_TRAIN.items():
        lut[k] = v
    n = 0
    with RecordWriter(out_path) as w:
        for fid in frames:
            if max_images is not None and n >= max_images:
                break
            spath = os.path.join(sem_dir, f"{fid}.png")
            if not os.path.exists(spath):
                continue
            jpeg, h, wd = read_image_as_jpeg(os.path.join(img_dir, f"{fid}.png"))
            from PIL import Image

            sem = np.asarray(Image.open(spath))
            if sem.ndim == 3:
                sem = sem[..., 0]
            mask = lut[sem]
            w.write({"id": fid, "height": h, "width": wd}, {"jpeg": jpeg, "mask": mask})
            n += 1
    with open(out_path + ".meta.json", "w") as f:
        json.dump({"classes": list(KITTI_SEMSEG_CLASSES), "num_records": n}, f)
    return {"written": n, "num_classes": len(KITTI_SEMSEG_CLASSES)}


def pack_kitti_multitask(
    src_dir: str,
    out_path: str,
    split: str = "training",
    max_images: Optional[int] = None,
) -> Dict[str, int]:
    """Fused KITTI export → one record per frame with EVERY modality:
    jpeg + boxes/classes (+3D when label_2 carries it) + Cityscapes-trainId
    mask + uint16 depth + intrinsics. Feeds the joint multitask heads
    (SURVEY.md §2 "Multitask model", BASELINE config D) from
    <split>/{image_2, label_2, calib, semantic, proj_depth}."""
    from PIL import Image

    dirs = {d: os.path.join(src_dir, split, d)
            for d in ("image_2", "label_2", "calib", "semantic", "proj_depth")}
    frames = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(dirs["image_2"], "*.png"))
    )
    lut = np.full(256, 255, np.uint8)
    for k, v in _CITYSCAPES_ID_TO_TRAIN.items():
        lut[k] = v
    n = 0
    with RecordWriter(out_path) as w:
        for fid in frames:
            if max_images is not None and n >= max_images:
                break
            spath = os.path.join(dirs["semantic"], f"{fid}.png")
            dpath = os.path.join(dirs["proj_depth"], f"{fid}.png")
            if not (os.path.exists(spath) and os.path.exists(dpath)):
                continue
            jpeg, h, wd = read_image_as_jpeg(os.path.join(dirs["image_2"], f"{fid}.png"))
            lbl = os.path.join(dirs["label_2"], f"{fid}.txt")
            objs = _parse_label_file(lbl) if os.path.exists(lbl) else []
            meta = {
                "id": fid,
                "height": h,
                "width": wd,
                "boxes": [o["bbox"] for o in objs],
                "classes": [o["cls"] for o in objs],
                "dims3d": [o["dims"] for o in objs],
                "loc3d": [o["loc"] for o in objs],
                "rot_y": [o["rot_y"] for o in objs],
            }
            intr = _parse_calib_p2(os.path.join(dirs["calib"], f"{fid}.txt"))
            if intr is not None:
                meta["intrinsics"] = intr
            sem = np.asarray(Image.open(spath))
            if sem.ndim == 3:
                sem = sem[..., 0]
            w.write(meta, {
                "jpeg": jpeg,
                "mask": lut[sem],
                "depth": load_png_u16(dpath).astype(np.uint16),
            })
            n += 1
    with open(out_path + ".meta.json", "w") as f:
        json.dump({"det_classes": list(KITTI_CLASSES),
                   "seg_classes": list(KITTI_SEMSEG_CLASSES),
                   "num_records": n}, f)
    return {"written": n}


def _parse_calib_cam_to_cam(path: str) -> Optional[List[float]]:
    """P_rect_02 from a KITTI raw date-level calib_cam_to_cam.txt."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("P_rect_02:"):
                    v = [float(x) for x in line.split()[1:]]
                    return [v[0], v[5], v[2], v[6]]
    except OSError:
        return None
    return None


def pack_kitti_raw(
    src_dir: str,
    out_path: str,
    max_images: Optional[int] = None,
    frame_stride: int = 1,
) -> Dict[str, int]:
    """KITTI raw drives → consecutive two-frame records for DMDS.

    src_dir: raw root with <date>/<drive>_sync/image_02/data/*.png and
    <date>/calib_cam_to_cam.txt. Each record carries frame t (jpeg), frame
    t+stride (jpeg_t1) and [fx, fy, cx, cy] — everything the two-frame
    unsupervised pipeline needs (SURVEY.md §3.4, BASELINE config E). Pairs
    never cross a drive boundary (no fake motion between unrelated scenes).

    When the drive also has GT depth (uint16 depth*256 PNGs), frame t's
    depth is stored too, so an unsupervised DMDS run can be EVALUATED
    (median-scaled delta1, train/evaluate.py) against withheld ground truth.
    Both layouts are recognized:
    - <drive>_sync/proj_depth/groundtruth/image_02/*.png — the official
      depth-devkit annotations merged into the raw tree,
    - <drive>_sync/proj_depth/data/*.png — the flat mirror layout
      scripts/gen_dataset.py emits.
    """
    drive_dirs = sorted(
        d for d in glob.glob(os.path.join(src_dir, "*", "*", "image_02", "data"))
        if os.path.isdir(d)
    )
    n = 0
    with RecordWriter(out_path) as w:
        for ddir in drive_dirs:
            if max_images is not None and n >= max_images:
                break
            date_dir = os.path.dirname(os.path.dirname(os.path.dirname(ddir)))
            intr = _parse_calib_cam_to_cam(
                os.path.join(date_dir, "calib_cam_to_cam.txt"))
            frames = sorted(glob.glob(os.path.join(ddir, "*.png")))
            drive_root = os.path.dirname(os.path.dirname(ddir))
            gdir = None
            for cand in (
                os.path.join(drive_root, "proj_depth", "groundtruth", "image_02"),
                os.path.join(drive_root, "proj_depth", "data"),
            ):
                if os.path.isdir(cand):
                    gdir = cand
                    break
            for a, b in zip(frames, frames[frame_stride:]):
                if max_images is not None and n >= max_images:
                    break
                jpeg, h, wd = read_image_as_jpeg(a)
                jpeg1, _, _ = read_image_as_jpeg(b)
                meta = {"id": os.path.relpath(a, src_dir), "height": h, "width": wd}
                if intr is not None:
                    meta["intrinsics"] = intr
                blobs = {"jpeg": jpeg, "jpeg_t1": jpeg1}
                if gdir is not None:
                    dpath = os.path.join(gdir, os.path.basename(a))
                    if os.path.exists(dpath):
                        blobs["depth"] = load_png_u16(dpath).astype(np.uint16)
                w.write(meta, blobs)
                n += 1
    return {"written": n, "drives": len(drive_dirs)}


def pack_kitti_depth(
    image_dir: str,
    depth_dir: str,
    out_path: str,
    max_images: Optional[int] = None,
) -> Dict[str, int]:
    """Pairs images with uint16 depth PNGs by matching relative filename."""
    depth_files = sorted(glob.glob(os.path.join(depth_dir, "**", "*.png"), recursive=True))
    n = 0
    with RecordWriter(out_path) as w:
        for dpath in depth_files:
            if max_images is not None and n >= max_images:
                break
            rel = os.path.relpath(dpath, depth_dir)
            ipath = os.path.join(image_dir, rel)
            if not os.path.exists(ipath):
                base = os.path.basename(dpath)
                hits = glob.glob(os.path.join(image_dir, "**", base), recursive=True)
                if not hits:
                    continue
                ipath = hits[0]
            jpeg, h, wd = read_image_as_jpeg(ipath)
            depth_u16 = load_png_u16(dpath)
            w.write(
                {"id": rel, "height": h, "width": wd},
                {"jpeg": jpeg, "depth": depth_u16.astype(np.uint16)},
            )
            n += 1
    return {"written": n}
