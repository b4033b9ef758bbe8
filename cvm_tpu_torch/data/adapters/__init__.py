"""Dataset adapters: raw public datasets -> ``.cvrec`` shards.

The port's copy of ``cvm_tpu/data/adapters/__init__.py`` (numpy and PIL
there too): the same nine ``ADAPTERS``, each writing the shard the
reference's writes for the same source tree, byte for byte
(``tests/test_torch_adapters.py``). Each exposes ``pack(src_dir,
out_path, ...)`` and is wired into ``python -m cvm_tpu_torch.cli.pack``.
Name-compatible with the reference's per-dataset upload scripts (SURVEY.md
§2 "Dataset uploaders": KITTI / COCO / nuScenes-nuImages / comma10k ->
Mongo), but targeting the self-contained packed record store.
"""

from cvm_tpu_torch.data.adapters.coco import pack_coco  # noqa: F401
from cvm_tpu_torch.data.adapters.comma10k import pack_comma10k  # noqa: F401
from cvm_tpu_torch.data.adapters.kitti import (  # noqa: F401
    pack_kitti_depth,
    pack_kitti_multitask,
    pack_kitti_object,
    pack_kitti_raw,
    pack_kitti_semseg,
)
from cvm_tpu_torch.data.adapters.nuimages import pack_nuimages  # noqa: F401
from cvm_tpu_torch.data.adapters.nuscenes import pack_nuscenes  # noqa: F401

ADAPTERS = {
    "coco": pack_coco,
    "kitti": pack_kitti_object,
    "kitti_depth": pack_kitti_depth,
    "kitti_multitask": pack_kitti_multitask,
    "kitti_raw": pack_kitti_raw,
    "kitti_semseg": pack_kitti_semseg,
    "comma10k": pack_comma10k,
    "nuimages": pack_nuimages,
    "nuscenes": pack_nuscenes,
}
