"""nuImages (nuScenes 2D) detection → `.cvrec`.

The port's copy of ``cvm_tpu/data/adapters/nuimages.py`` (numpy, json and PIL
there too); the shards it writes are the reference's, byte for byte.

Reference: data/nuscenes-nuimages upload script (SURVEY.md §2). Works from
the raw nuImages JSON tables (sample_data.json, object_ann.json,
category.json, attribute.json) with plain json — no nuscenes-devkit needed
for 2D box packing. Category names are collapsed to the standard 10-class
nuScenes detection set.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from cvm_tpu_torch.data.adapters.common import read_image_as_jpeg
from cvm_tpu_torch.data.records import RecordWriter

NUSCENES_CLASSES = (
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
)

# nuImages category name prefixes → contiguous class id.
_PREFIX_MAP = {
    "vehicle.car": 0,
    "vehicle.truck": 1,
    "vehicle.bus": 2,
    "vehicle.trailer": 3,
    "vehicle.construction": 4,
    "human.pedestrian": 5,
    "vehicle.motorcycle": 6,
    "vehicle.bicycle": 7,
    "movable_object.trafficcone": 8,
    "movable_object.barrier": 9,
}


def _category_to_class(name: str) -> Optional[int]:
    for prefix, cid in _PREFIX_MAP.items():
        if name.startswith(prefix):
            return cid
    return None


def pack_nuimages(
    src_dir: str,
    out_path: str,
    version: str = "v1.0-train",
    max_images: Optional[int] = None,
) -> Dict[str, int]:
    """src_dir: nuImages root containing <version>/*.json and samples/ dirs."""
    tdir = os.path.join(src_dir, version)
    with open(os.path.join(tdir, "sample_data.json")) as f:
        sample_data = json.load(f)
    with open(os.path.join(tdir, "object_ann.json")) as f:
        object_ann = json.load(f)
    with open(os.path.join(tdir, "category.json")) as f:
        categories = json.load(f)

    cat_by_token = {c["token"]: c["name"] for c in categories}
    anns_by_sd: Dict[str, List[dict]] = {}
    for a in object_ann:
        anns_by_sd.setdefault(a["sample_data_token"], []).append(a)

    n = n_skipped = 0
    with RecordWriter(out_path) as w:
        for sd in sample_data:
            if max_images is not None and n >= max_images:
                break
            if not sd.get("is_key_frame", False):
                continue
            path = os.path.join(src_dir, sd["filename"])
            if not os.path.exists(path):
                n_skipped += 1
                continue
            boxes, classes = [], []
            for a in anns_by_sd.get(sd["token"], []):
                cid = _category_to_class(cat_by_token.get(a["category_token"], ""))
                if cid is None:
                    continue
                boxes.append([float(x) for x in a["bbox"]])  # already xyxy
                classes.append(cid)
            jpeg, h, wd = read_image_as_jpeg(path)
            w.write(
                {
                    "id": sd["filename"],
                    "height": h,
                    "width": wd,
                    "boxes": boxes,
                    "classes": classes,
                },
                {"jpeg": jpeg},
            )
            n += 1
    with open(out_path + ".meta.json", "w") as f:
        json.dump({"classes": list(NUSCENES_CLASSES), "num_records": n}, f)
    return {"written": n, "skipped": n_skipped, "num_classes": len(NUSCENES_CLASSES)}
