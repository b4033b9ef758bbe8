"""CenterNet processor: raw padded batch -> model input + GT targets.

Mirrors ``cvm_tpu/models/centernet/processor.py::make_processor``: letterbox
(eval) or jitter + photometric augmentation (training), boxes mapped through
the same ROI onto the canvas and divided by the stride, then the GT render.
The reference swaps in its Pallas splat when the backend is a TPU; here the
heatmap comes from ``render_heatmap``, which launches kernel K1 for a CUDA
batch (no lattice is computed) and takes the plain version for a CPU batch.
``use_pallas_splat=False`` selects the plain lattice renderer on both
devices, as the reference's flag does.

With ``with_3d`` and 3D labels in the batch (``loc3d``, ``dims3d``,
``rot_y``), the targets carry the extras: camera z, metric dims and the
yaw as (sin, cos), the cosine negated on horizontally flipped samples (a
mirrored camera sees ry -> pi - ry). Depth is not corrected for the
augmentation's zoom (the CenterNet ddd convention); rotation augmentation
is refused with the reference's message. Without them, ``aug_rotate_deg >
0`` rolls each training image, and its boxes become the axis-aligned box
of their rotated corners, clipped to the canvas.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops.cuda.gaussian_splat import render_heatmap, render_heatmap_reference
from cvm_tpu_torch.ops.heatmap import CenternetTargets, render_centernet_targets_batch
from cvm_tpu_torch.ops.image import clip_boxes, map_boxes_to_output, rotate_boxes
from cvm_tpu_torch.pipeline.preprocess import AugDraws, BatchRows, preprocess_with_rois

Processor = Callable[..., Tuple[torch.Tensor, CenternetTargets]]


def make_processor(params: CenternetParams, train: bool) -> Processor:
    """Returns ``process(generator, batch, draws=None, rows=None) -> (inputs, targets)``.

    batch: image (B, Hmax, Wmax, 3) uint8 or y/u/v planes; image_hw (B, 2);
    boxes (B, K, 4) [x0, y0, x1, y1] source px; classes (B, K);
    num_objects (B,); with ``with_3d`` also loc3d (B, K, 3), dims3d (B, K,
    3), rot_y (B, K) -- tensors on one device. In training the random
    numbers are ``draws`` when given, else drawn from ``generator`` (on the
    batch's device; for the global batch's ``rows`` when given, the
    batch being those rows); eval takes neither.
    """
    if params.with_3d and getattr(params, "aug_rotate_deg", 0.0) > 0.0:
        raise ValueError(
            "aug_rotate_deg is incompatible with with_3d: monocular yaw and "
            "back-projection assume an unrolled camera (keep rotation off "
            "for 3D configs, like the tight aug_scale_range guidance)")
    out_hw = params.input_hw
    splat = render_heatmap if params.use_pallas_splat else render_heatmap_reference

    def process(generator: Optional[torch.Generator], batch,
                draws: Optional[AugDraws] = None, rows: Optional[BatchRows] = None
                ) -> Tuple[torch.Tensor, CenternetTargets]:
        images, rois, angles = preprocess_with_rois(params, train, generator, batch, draws,
                                                     rows)
        out_boxes = map_boxes_to_output(batch["boxes"], rois)
        if angles is not None:
            # Rotated boxes spill past the canvas: clipped, so that the size
            # targets cover visible pixels (a box rotated out of frame
            # degenerates and the renderer drops it).
            center = ((out_hw[1] - 1) / 2.0, (out_hw[0] - 1) / 2.0)
            out_boxes = clip_boxes(rotate_boxes(out_boxes, angles, center), out_hw)
        boxes = out_boxes / params.stride
        K = boxes.shape[1]
        valid = (torch.arange(K, device=boxes.device)[None, :]
                 < batch["num_objects"][:, None])
        extra_values = None
        if params.with_3d and "loc3d" in batch:
            ry = batch["rot_y"]
            flip_sign = torch.where(rois.flip_x, -1.0, 1.0)[:, None]
            extra_values = {"depth3d": batch["loc3d"][..., 2:3], "dims3d": batch["dims3d"],
                            "rot": torch.stack([torch.sin(ry), torch.cos(ry) * flip_sign], -1)}
        targets = render_centernet_targets_batch(boxes, batch["classes"], valid,
                                                 params.map_hw, params.num_classes,
                                                 params.min_overlap, splat, extra_values)
        return images, targets

    return process
