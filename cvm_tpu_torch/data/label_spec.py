"""Canonical label schema (reference: data/label_spec.py, SURVEY.md §2).

The port's copy of ``cvm_tpu/data/label_spec.py``: the KITTI and nuScenes
class lists live in their adapters (``data/adapters/kitti.py``,
``nuimages.py``) and are imported here, as the reference's are.

Defines the framework-wide label contract used by adapters (producers), the
record store (carrier), loaders (assemblers) and processors (consumers):

Record ``meta`` (JSON):
    id          : str — source-unique sample id
    height/width: int — original image size
    boxes       : [[x0, y0, x1, y1], ...] float, original-pixel coords
    classes     : [int, ...] contiguous ids aligned with ``boxes``
    intrinsics  : [fx, fy, cx, cy] (optional; camera tasks)
    dims3d      : [[h, w, l], ...]   (optional; 3D detection)
    loc3d       : [[x, y, z], ...]   (optional; camera-frame center)
    rot_y       : [float, ...]       (optional; yaw)

Record ``blobs`` (binary):
    jpeg     : raw JPEG bytes (the only image encoding in the store)
    jpeg_t1  : next frame for two-frame tasks (DMDS)
    mask     : (H, W) uint8 class ids, 255 = void/ignore
    depth    : (H, W) float32 meters (0 = invalid) or uint16 KITTI (d*256)

Class maps: each dataset adapter ships its own contiguous class list in the
shard's ``.meta.json``; the canonical ones live here for convenience.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from cvm_tpu_torch.data.adapters.kitti import KITTI_CLASSES  # noqa: F401
from cvm_tpu_torch.data.adapters.nuimages import NUSCENES_CLASSES  # noqa: F401
from cvm_tpu_torch.models.semseg.params import SEMSEG_CLASSES, SEMSEG_PALETTE  # noqa: F401

IGNORE_INDEX = 255

# COCO-80 names in contiguous id order (sorted by original category id).
COCO_CLASSES: Tuple[str, ...] = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)

CLASS_MAPS: Dict[str, Sequence[str]] = {
    "coco": COCO_CLASSES,
    "kitti": KITTI_CLASSES,
    "nuscenes": NUSCENES_CLASSES,
    "comma10k": SEMSEG_CLASSES,
}
