"""End-to-end serving: planar YUV420 batch -> preprocess -> CenterNet ->
NMS-free decode -> boxes in source-image coordinates.

Mirrors ``cvm_tpu/infer/pipeline.py::InferencePipeline`` for CenterNet with
``input_format="yuv420"`` in its two serving postures:
  * fp with BN folded (``fold_bn=True``), the default deploy posture;
  * static W8A8 through the fused int8 kernel (``w8a8=<scales>``,
    ``w8a8_fused=True``), optionally with int8-resident ResBlocks
    (``w8a8_chain=True``).
It keeps the reference's refusals. The reference jits one program; here the
same steps run eagerly on the pipeline's device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.ops.decode import decode_centernet
from cvm_tpu_torch.ops.image import map_boxes_to_input
from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch
from cvm_tpu_torch.utils.batch import pad_rows
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


class InferencePipeline:
    """Predict for a CenterNet model on one device, from planar YUV420
    (the reference's ``input_format="yuv420"``; RGB input is not ported).

    ``model`` is left untouched: the pipeline serves a transformed copy.
    ``__call__`` pads a short batch up to ``params.batch_size`` by repeating
    the last row (as the reference pads to its mesh) and slices the results
    back.
    """

    def __init__(self, params: CenternetParams, model: nn.Module, device: DeviceLike,
                 w8a8: Optional[Dict[str, float]] = None, w8a8_fused: bool = False,
                 w8a8_chain: bool = False, fold_bn: bool = False):
        if w8a8_fused and not isinstance(w8a8, dict):
            raise ValueError(
                "w8a8_fused requires calibrated per-conv scales: pass "
                "w8a8={conv module name: scale} (calibrate_activation_scales)")
        if w8a8_chain and not w8a8_fused:
            raise ValueError("w8a8_chain is a mode of the fused kernel path — "
                             "set w8a8_fused=True (with calibrated scales) as well")
        if fold_bn and w8a8_fused:
            raise ValueError(
                "fold_bn and w8a8_fused are mutually exclusive: the fused kernel "
                "applies the BN affine in its epilogue, so folded kernels would "
                "get the BN scale twice")
        if isinstance(w8a8, dict) and not w8a8:
            raise ValueError("w8a8 scales dict is empty — calibration produced no "
                             "per-conv scales; refusing to serve fp as 'int8'")
        if w8a8 is not None and not w8a8_fused:
            raise ValueError("only the fused W8A8 path is ported: set w8a8_fused=True")
        self.cfg = params
        self.device = resolve_device(device)
        self.fused_counts = None
        if fold_bn:
            from cvm_tpu_torch.infer.fold_bn import fold_batchnorm

            model = fold_batchnorm(model)
        else:
            model = copy.deepcopy(model)
        model = model.to(self.device).eval()
        if w8a8_fused:
            from cvm_tpu_torch.infer.quantize import prequantize_fused_weights, swap_fused

            self.fused_counts = swap_fused(model, w8a8, prequantize_fused_weights(model),
                                           chain=w8a8_chain)
            if not self.fused_counts["calls"]:
                raise ValueError("w8a8_fused: no module matched the calibrated scales")
        self.model = model

    @torch.no_grad()
    def predict(self, y, u, v, image_hw) -> Dict[str, torch.Tensor]:
        """Device tensors in, device tensors out: y (B, Hm, Wm), u/v
        (B, Hm/2, Wm/2) uint8, image_hw (B, 2) int."""
        cfg = self.cfg
        proc, rois = preprocess_yuv420_batch(y, u, v, image_hw, cfg.input_hw,
                                             out_dtype=torch.bfloat16)
        out = self.model(proc)
        det = decode_centernet(out["heatmap"], out["offset"], out["size"],
                               stride=cfg.stride, top_k=cfg.top_k)
        return {"boxes": map_boxes_to_input(det.boxes, rois), "scores": det.scores,
                "classes": det.classes}

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """batch: y/u/v planes + image_hw (numpy arrays or tensors)."""
        args = [batch[k] for k in ("y", "u", "v", "image_hw")]
        args = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in args]
        n = int(args[0].shape[0])
        args = pad_rows(args, self.cfg.batch_size)
        out = self.predict(*(torch.from_numpy(a).to(self.device) for a in args))
        return {k: v[:n] for k, v in out.items()}
