"""COCO detection → `.cvrec` (reference: data/coco upload script, SURVEY.md §2).

The port's copy of ``cvm_tpu/data/adapters/coco.py`` (numpy, json and PIL
there too); the shards it writes are the reference's, byte for byte.

Parses `instances_<split>.json` with plain json (no pycocotools needed for
box-level packing), maps category ids to a contiguous [0, C) range, and
stores per-image records: verbatim JPEG bytes + xyxy boxes + class ids.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from cvm_tpu_torch.data.adapters.common import read_image_as_jpeg
from cvm_tpu_torch.data.records import RecordWriter


def pack_coco(
    src_dir: str,
    out_path: str,
    split: str = "train2017",
    ann_file: Optional[str] = None,
    max_images: Optional[int] = None,
    min_box_area: float = 4.0,
) -> Dict[str, int]:
    """src_dir: COCO root containing annotations/ and <split>/ image dirs."""
    ann_file = ann_file or os.path.join(src_dir, "annotations", f"instances_{split}.json")
    with open(ann_file) as f:
        coco = json.load(f)

    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat_to_contig = {c["id"]: i for i, c in enumerate(cats)}
    class_names = [c["name"] for c in cats]

    by_image: Dict[int, List[dict]] = {}
    for a in coco["annotations"]:
        if a.get("iscrowd", 0):
            continue
        by_image.setdefault(a["image_id"], []).append(a)

    img_dir = os.path.join(src_dir, split)
    n_written = n_skipped = 0
    with RecordWriter(out_path) as w:
        for img in coco["images"]:
            if max_images is not None and n_written >= max_images:
                break
            path = os.path.join(img_dir, img["file_name"])
            if not os.path.exists(path):
                n_skipped += 1
                continue
            boxes, classes = [], []
            for a in by_image.get(img["id"], []):
                x, y, bw, bh = a["bbox"]
                if bw * bh < min_box_area:
                    continue
                boxes.append([x, y, x + bw, y + bh])
                classes.append(cat_to_contig[a["category_id"]])
            jpeg, h, wd = read_image_as_jpeg(path)
            w.write(
                {
                    "id": img["file_name"],
                    "height": h,
                    "width": wd,
                    "boxes": boxes,
                    "classes": classes,
                },
                {"jpeg": jpeg},
            )
            n_written += 1
    meta_path = out_path + ".meta.json"
    with open(meta_path, "w") as f:
        json.dump({"classes": class_names, "num_records": n_written}, f)
    return {"written": n_written, "skipped": n_skipped, "num_classes": len(class_names)}
