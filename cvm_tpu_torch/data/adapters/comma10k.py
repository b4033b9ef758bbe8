"""comma10k semseg → `.cvrec` (reference trains its semseg on these classes).

The port's copy of ``cvm_tpu/data/adapters/comma10k.py`` (numpy, json and PIL
there too); the shards it writes are the reference's, byte for byte.

comma10k: imgs/*.png road scenes + masks/*.png color-coded by class. Colors
are converted to class ids once at pack time (SURVEY.md §2 "Semseg
processor+loss" moves this out of the training hot loop entirely).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

from cvm_tpu_torch.data.adapters.common import (colors_to_class_map, load_png_u8,
                                                read_image_as_jpeg)
from cvm_tpu_torch.data.records import RecordWriter
from cvm_tpu_torch.models.semseg.params import SEMSEG_CLASSES, SEMSEG_PALETTE


def pack_comma10k(
    src_dir: str,
    out_path: str,
    max_images: Optional[int] = None,
    mask_scale: int = 1,
) -> Dict[str, int]:
    """src_dir: comma10k checkout with imgs/ and masks/.

    mask_scale > 1 stores masks downscaled (nearest) to save shard space —
    the device processor resamples to model resolution anyway.
    """
    img_files = sorted(glob.glob(os.path.join(src_dir, "imgs", "*.png")))
    img_files += sorted(glob.glob(os.path.join(src_dir, "imgs", "*.jpg")))
    n = 0
    with RecordWriter(out_path) as w:
        for ipath in img_files:
            if max_images is not None and n >= max_images:
                break
            base = os.path.basename(ipath)
            mpath = os.path.join(src_dir, "masks", os.path.splitext(base)[0] + ".png")
            if not os.path.exists(mpath):
                continue
            jpeg, h, wd = read_image_as_jpeg(ipath)
            mask_rgb = load_png_u8(mpath)
            mask = colors_to_class_map(mask_rgb, SEMSEG_PALETTE)
            if mask_scale > 1:
                mask = mask[::mask_scale, ::mask_scale]
            w.write({"id": base, "height": h, "width": wd}, {"jpeg": jpeg, "mask": mask})
            n += 1
    with open(out_path + ".meta.json", "w") as f:
        json.dump({"classes": list(SEMSEG_CLASSES), "num_records": n}, f)
    return {"written": n, "num_classes": len(SEMSEG_CLASSES)}
