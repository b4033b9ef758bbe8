"""Multitask processor: one ROI drives the image, the boxes, the mask and
the sparse depth.

Mirrors ``cvm_tpu/models/multitask/processor.py::make_processor``. The
boxes map through the image's ROI, divide by ``det_stride`` and render
the CenterNet targets at stride 4; the heatmap comes from
``render_heatmap``, which launches kernel K1 for a CUDA batch (the
reference renders this heatmap with its lattice code, which K1's plain
version is). With ``aug_rotate_deg > 0`` one roll drives every modality:
the image bilinear, the boxes as the clipped box of their rotated corners,
the mask and depth nearest.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from cvm_tpu_torch.models.multitask.params import MultitaskParams
from cvm_tpu_torch.ops.cuda.gaussian_splat import render_heatmap
from cvm_tpu_torch.ops.heatmap import render_centernet_targets_batch
from cvm_tpu_torch.ops.image import clip_boxes, map_boxes_to_output, rotate_boxes
from cvm_tpu_torch.pipeline.preprocess import (AugDraws, BatchRows, preprocess_with_rois,
                                               resample_labels, rotate_labels)


def make_processor(params: MultitaskParams, train: bool) -> Callable[..., Tuple]:
    """Returns ``process(generator, batch, draws=None, rows=None) -> (inputs, {"det":
    CenternetTargets, "classes": (B, H, W) int32, "depth": (B, H, W, 1)})``;
    batch holds the image, image_hw, boxes, classes, num_objects, mask and
    depth."""
    out_hw = params.input_hw

    def process(generator, batch, draws: Optional[AugDraws] = None,
                rows: Optional[BatchRows] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        images, rois, angles = preprocess_with_rois(params, train, generator, batch, draws,
                                                     rows)
        out_boxes = map_boxes_to_output(batch["boxes"], rois)
        if angles is not None:
            # one roll drives every modality, as the shared ROI does
            center = ((out_hw[1] - 1) / 2.0, (out_hw[0] - 1) / 2.0)
            out_boxes = clip_boxes(rotate_boxes(out_boxes, angles, center), out_hw)
        boxes = out_boxes / params.det_stride
        K = boxes.shape[1]
        valid = (torch.arange(K, device=boxes.device)[None, :]
                 < batch["num_objects"][:, None])
        det = render_centernet_targets_batch(boxes, batch["classes"], valid,
                                             params.det_map_hw, params.num_det_classes,
                                             params.min_overlap, render_heatmap)
        seg = rotate_labels(resample_labels(batch, "mask", rois, out_hw, params.ignore_index),
                            angles, params.ignore_index)
        depth = rotate_labels(resample_labels(batch, "depth", rois, out_hw, 0.0), angles, 0.0)
        return images, {"det": det, "classes": seg, "depth": depth[..., None]}

    return process
