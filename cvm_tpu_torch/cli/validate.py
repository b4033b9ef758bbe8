"""Dataset validation: hard integrity checks over packed ``.cvrec`` shards.

``python -m cvm_tpu_torch.cli.validate --data 'train-*.cvrec' [--device cuda]``

Mirrors ``cvm_tpu/cli/validate.py`` (``_Report``, ``_check_boxes``,
``_check_blobs``, ``validate``, ``main``): the same checks, the same
report (``tests/test_torch_data_tools.py`` holds it to the reference's).
The headers are verified with PIL, as the reference's are; the sample
decode goes through ``data/jpeg.py::decode_jpeg_batch`` on ``--device``:
nvJPEG on the card (``csrc/jpeg_nvjpeg.cu``), libjpeg on the CPU. The
reference's docstring follows.

cli.stats answers "what is in this dataset"; this answers "is it safe to
train on": decodable images, box geometry inside the frame, class ids
within the shard's class list, masks restricted to valid ids, finite
non-negative depth, consistent 3D label lengths, sane intrinsics, matched
two-frame pairs. The reference's equivalent is eyeballing a visualized
upload (SURVEY.md §4); a production pipeline wants the machine check —
one bad record stops a 100k-step run hours in.

Prints one JSON summary; exit 1 when any ERROR was found (warnings don't
fail). Use --sample_decode N to fully decode N evenly-spaced JPEGs through
the production decoder (headers are verified on every record regardless).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np


class _Report:
    def __init__(self, max_list: int = 20):
        self.errors: List[str] = []
        self.warnings: List[str] = []
        self.n_errors = 0
        self.n_warnings = 0
        self.max_list = max_list

    def error(self, rec: int, msg: str) -> None:
        self.n_errors += 1
        if len(self.errors) < self.max_list:
            self.errors.append(f"record {rec}: {msg}")

    def warn(self, rec: int, msg: str) -> None:
        self.n_warnings += 1
        if len(self.warnings) < self.max_list:
            self.warnings.append(f"record {rec}: {msg}")


def _check_boxes(rep: _Report, i: int, meta: Dict[str, Any],
                 num_classes: Optional[int]) -> None:
    boxes = meta.get("boxes") or []
    classes = meta.get("classes") or []
    h, w = meta.get("height"), meta.get("width")
    if boxes and len(classes) != len(boxes):
        rep.error(i, f"{len(boxes)} boxes but {len(classes)} classes")
    arr = np.asarray(boxes, np.float64).reshape(-1, 4) if boxes else None
    if arr is not None:
        if not np.isfinite(arr).all():
            rep.error(i, "non-finite box coordinates")
        bad_order = (arr[:, 2] <= arr[:, 0]) | (arr[:, 3] <= arr[:, 1])
        if bad_order.any():
            rep.error(i, f"{int(bad_order.sum())} boxes with x2<=x1 or y2<=y1")
        if h and w:
            oob = ((arr[:, [0, 2]] < -1.0) | (arr[:, [0, 2]] > w + 1.0)).any() \
                or ((arr[:, [1, 3]] < -1.0) | (arr[:, [1, 3]] > h + 1.0)).any()
            if oob:
                rep.warn(i, f"box outside the {h}x{w} frame (adapters clamp; "
                            "raw labels may legitimately overhang)")
    for c in classes:
        if int(c) < 0 or (num_classes is not None and int(c) >= num_classes):
            rep.error(i, f"class id {c} outside [0, {num_classes})")
            break
    # 3D labels ride alongside 2D boxes: lengths must agree.
    for k in ("dims3d", "loc3d", "rot_y"):
        if k in meta and len(meta[k]) != len(boxes):
            rep.error(i, f"{k} has {len(meta[k])} entries for {len(boxes)} boxes")
    if "dims3d" in meta:
        d = np.asarray(meta["dims3d"], np.float64)
        if d.size and (d <= 0).any():
            rep.error(i, "non-positive 3D dimensions")
    if "intrinsics" in meta:
        fx, fy = meta["intrinsics"][0], meta["intrinsics"][1]
        if fx <= 0 or fy <= 0:
            rep.error(i, f"non-positive focal length fx={fx} fy={fy}")


def _check_blobs(rep: _Report, i: int, meta: Dict[str, Any],
                 blobs: Dict[str, Any], num_classes: Optional[int]) -> None:
    h, w = meta.get("height"), meta.get("width")
    for key in ("jpeg", "jpeg_t1"):
        if key in blobs:
            from PIL import Image

            try:
                im = Image.open(io.BytesIO(bytes(blobs[key])))
                im.verify()  # header/structure check, no full decode
                if h and w and im.size != (w, h):
                    rep.error(i, f"{key} is {im.size[1]}x{im.size[0]} but "
                                 f"meta says {h}x{w}")
            except Exception as e:
                rep.error(i, f"{key} does not parse as an image: {e}")
    if "y" in blobs:  # raw planar YUV: chroma planes are ceil-half of luma
        y = np.asarray(blobs["y"])
        for c in ("u", "v"):
            if c not in blobs:
                rep.error(i, f"raw YUV record missing {c!r} plane")
            else:
                exp = ((y.shape[0] + 1) // 2, (y.shape[1] + 1) // 2)
                got = np.asarray(blobs[c]).shape
                if tuple(got) != exp:
                    rep.error(i, f"{c} plane {got} != expected {exp}")
    if "mask" in blobs:
        m = np.asarray(blobs["mask"])
        if h and w and m.shape[:2] != (h, w):
            rep.warn(i, f"mask {m.shape[:2]} != image {h}x{w} "
                        "(loader resamples, but adapters emit matched sizes)")
        if num_classes is not None:
            vals = np.unique(m)
            bad = vals[(vals != 255) & (vals >= num_classes)]
            if bad.size:
                rep.error(i, f"mask ids {bad.tolist()} outside "
                             f"[0, {num_classes}) + ignore 255")
    if "depth" in blobs:
        d = np.asarray(blobs["depth"], np.float64)
        if not np.isfinite(d).all():
            rep.error(i, "non-finite depth values")
        elif (d < 0).any():
            rep.error(i, "negative depth values")
    # Two-frame records need the pair complete (single-frame = jpeg only).
    if "jpeg_t1" in blobs and "jpeg" not in blobs:
        rep.error(i, "jpeg_t1 present without the frame-t jpeg")
    if ("y_t1" in blobs) and not all(k in blobs for k in ("u_t1", "v_t1")):
        rep.error(i, "two-frame raw-YUV record missing u_t1/v_t1")


def validate(paths: List[str], sample_decode: int = 8, max_list: int = 20,
             device="cuda") -> Dict[str, Any]:
    from cvm_tpu_torch.data.records import RecordDataset

    ds = RecordDataset(paths)
    n = len(ds)
    rep = _Report(max_list)

    import glob as _glob

    names = None
    for pat in paths:
        for p in sorted(_glob.glob(pat)) or [pat]:
            try:
                with open(p + ".meta.json") as f:
                    names = json.load(f).get("classes") or names
            except (OSError, ValueError):
                pass
    num_classes = len(names) if names else None

    for i in range(n):
        try:
            meta, blobs = ds.get(i)
        except Exception as e:
            rep.error(i, f"record does not parse: {e}")
            continue
        _check_boxes(rep, i, meta, num_classes)
        _check_blobs(rep, i, meta, blobs, num_classes)

    # Full decode through the production decoder on a spread of records
    # (header verify above catches truncation; this catches corrupt entropy
    # data mid-stream).
    decoded = 0
    if sample_decode and n:
        from cvm_tpu_torch.data.jpeg import decode_jpeg_batch

        idx = np.unique(np.linspace(0, n - 1, min(sample_decode, n)).astype(int))
        for i in idx:
            meta, blobs = ds.get(int(i))
            if "jpeg" not in blobs:
                continue
            ph = int(meta.get("height") or 2048)
            pw = int(meta.get("width") or 2048)
            _, hw = decode_jpeg_batch([bytes(blobs["jpeg"])], ph, pw, device=device)
            if tuple(hw[0]) == (1, 1):
                rep.error(int(i), "jpeg failed full decode")
            else:
                decoded += 1

    return {
        "records": n,
        "shards": len(ds.readers),
        "class_names": bool(names),
        "errors": rep.n_errors,
        "warnings": rep.n_warnings,
        "error_samples": rep.errors,
        "warning_samples": rep.warnings,
        "sample_decoded_ok": decoded,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", required=True, nargs="+",
                        help=".cvrec path(s)/glob(s)")
    parser.add_argument("--sample_decode", type=int, default=8,
                        help="fully decode N evenly-spaced JPEG records "
                             "through the production decoder (0 = off)")
    parser.add_argument("--max_list", type=int, default=20,
                        help="cap on listed error/warning samples")
    parser.add_argument("--device", default="cuda",
                        help="'cuda', 'cuda:N' or 'cpu': the sample decode's decoder")
    args = parser.parse_args(argv)

    out = validate(args.data, args.sample_decode, args.max_list, device=args.device)
    print(json.dumps(out, sort_keys=True), flush=True)
    return 1 if out["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
