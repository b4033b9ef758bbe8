"""End-to-end serving: RGB buffers or planar YUV420 -> preprocess -> model
-> postprocess: for CenterNet and multitask the NMS-free decode with boxes
in source-image coordinates (and, for a ``with_3d`` CenterNet, metric
camera-frame ``centers3d``, ``dims`` and ``yaw`` from per-image
intrinsics); for semseg and multitask the class map; for depth and
multitask the full-resolution depth; for DMDS, which takes two frames
through one ROI, frame t's depth and the forward ego-motion.

Mirrors ``cvm_tpu/infer/pipeline.py`` (``InferencePipeline``,
``_postprocess``) for the whole zoo in the deploy postures (DMDS in fp
only: the reference refuses W8A8 for it):
  * fp, optionally with BN folded (``fold_bn=True``): each conv then runs
    as cuDNN's conv and one epilogue kernel on weights prepared once
    (``infer/fold_bn.py::swap_folded``; ``folded_counts`` says how many
    convs it took and how many it left);
  * W8A8 with dynamic scales (``w8a8=True``) or calibrated static ones
    (``w8a8=<scales>``), every conv an ``Int8Conv``; both compose with
    ``fold_bn`` (the quantizer then sees the folded kernels);
  * static W8A8 through the fused int8 kernel (``w8a8=<scales>``,
    ``w8a8_fused=True``), optionally with int8-resident ResBlocks
    (``w8a8_chain=True``);
  * any of them with horizontal-flip test-time augmentation
    (``tta="hflip"``).
A ``qat`` config without ``w8a8`` serves the fake-quant convs of its train
step (``train/qat.py``), so evals score the int8 numerics it trained for.
It keeps the reference's refusals. The reference jits one program; here the
same steps run eagerly on the pipeline's device, and ``cli/export.py``
records them as one program (``torch.export``) of ``run``.

Sharded serving (``mesh=``, the reference's ``InferencePipeline(mesh=)``,
``cvm_tpu/infer/pipeline.py:295-350``): every rank of a
``parallel/mesh.py`` mesh builds the same pipeline and is called with the
same batch; each data rank predicts its rows and every result is
all-gathered back to every rank in row order. Under a model axis and
``tensor_parallel`` the fp postures (plain, ``fold_bn``, ``hflip``) keep the
stage-5 convs split as training splits them (``parallel/sharding.py``:
the forward all-reduces of ``RowConv``); the int8 postures and a QAT
model's fake-quant convs run them on whole weights (``unshard_module``),
as GSPMD gathers the reference's custom call's operands and keeps every
other op's unsharded semantics: K2's epilogue cannot take a row split's
partial int32 sums. A ``spatial_shard`` semseg head runs H-sharded over the
model axis (``SpatialConv3x3``). ``__call__`` shards its batch through
``shard_predict``, which shards any batch function alike (an artifact's
``predict_batch``).

On a CUDA device and without a mesh, ``predict`` replays one CUDA graph of
the whole step per input signature (``infer/graphs.py``: the first call of
a signature runs eagerly, the second captures; ``graph_counts`` says how
often each path ran); ``run`` always runs eagerly. A mesh's collectives
keep a sharded pipeline eager.

Under a recording ``torch.profiler`` a call shows as the ranges
``cvm.infer.call`` (the whole call) and, inside it, ``cvm.infer.h2d`` and
then either ``cvm.infer.preprocess``, ``cvm.infer.forward`` and
``cvm.infer.postprocess`` (an eager call; for CenterNet and multitask
``cvm.infer.decode`` inside the last) or ``cvm.infer.replay`` (a graph's
replay, which runs no host op of the stages); ``utils/prof.py::span``
lists what each covers. Without a profiler they
record nothing, and an exported ``run`` holds none of them.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from cvm_tpu_torch.infer.graphs import StepGraphs, blocked_by
from cvm_tpu_torch.ops.decode import decode_centernet, decode_centernet_3d, semseg_argmax
from cvm_tpu_torch.ops.image import map_boxes_to_input
from cvm_tpu_torch.ops.warp import scale_intrinsics
from cvm_tpu_torch.parallel.reduce import LOCAL
from cvm_tpu_torch.pipeline.preprocess import preprocess_image_batch, preprocess_yuv420_batch
from cvm_tpu_torch.utils.batch import pad_rows
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device
from cvm_tpu_torch.utils.prof import span

_MODELS = ("centernet", "semseg", "depth", "multitask", "dmds")


def data_keys(model: str, input_format: str, with_3d: bool = False) -> tuple:
    """The batch keys ``predict`` (and an exported program) takes, in order:
    ``(y, u, v, image_hw)`` or ``(image, image_hw)``; DMDS's second frame
    (``y_t1, u_t1, v_t1`` before ``image_hw``, or ``image_t1`` after it);
    a ``with_3d`` model's ``intrinsics`` last."""
    if input_format == "yuv420":
        keys = ("y", "u", "v") + (("y_t1", "u_t1", "v_t1") if model == "dmds" else ()) \
            + ("image_hw",)
    else:
        keys = ("image", "image_hw") + (("image_t1",) if model == "dmds" else ())
    return keys + (("intrinsics",) if with_3d else ())

# The outputs hflip TTA flips back and averages: CenterNet's heatmap and
# size (the sub-pixel offset keeps the plain pass's), and the dense maps.
_TTA_KEYS = ("heatmap", "size", "logits", "depth")


def postprocess(cfg, out: Dict[str, Any], rois,
                intrinsics: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The model's outputs -> what the pipeline serves, by model name:
    ``boxes`` (source-image coordinates), ``scores`` and ``classes`` for
    centernet/multitask (with ``intrinsics`` (B, 4) in source pixels and 3D
    heads, also ``centers3d``, ``dims`` and ``yaw``), ``class_map`` for
    semseg/multitask, ``depth`` (B, H, W, 1) for depth/multitask, and
    ``depth`` (frame t), ``rotation`` and ``translation`` for dmds."""
    res: Dict[str, torch.Tensor] = {}
    if cfg.name in ("centernet", "multitask"):
        stride = getattr(cfg, "stride", getattr(cfg, "det_stride", 4))
        with span("cvm.infer.decode"):
            if intrinsics is not None and "depth3d" in out:
                # Back-projection uses the intrinsics of the model input: the
                # source-image ones through the image's ROI.
                d3 = decode_centernet_3d(out["heatmap"], out["offset"], out["size"],
                                         out["depth3d"], out["dims3d"], out["rot"],
                                         scale_intrinsics(intrinsics, rois), stride=stride,
                                         top_k=cfg.top_k)
                det = d3.det
                res.update(centers3d=d3.centers3d, dims=d3.dims, yaw=d3.yaw)
            else:
                det = decode_centernet(out["heatmap"], out["offset"], out["size"],
                                       stride=stride, top_k=cfg.top_k)
            res.update(boxes=map_boxes_to_input(det.boxes, rois), scores=det.scores,
                       classes=det.classes)
    if cfg.name in ("semseg", "multitask"):
        res["class_map"] = semseg_argmax(out["logits"])
    if cfg.name in ("depth", "multitask"):
        res["depth"] = out["depth"]
    if cfg.name == "dmds":
        res.update(depth=out["depth_a"], rotation=out["motion_fwd"]["rotation"],
                   translation=out["motion_fwd"]["translation"])
    return res


class InferencePipeline:
    """Predict for a model of the zoo on one device, from planar YUV420
    (``input_format="yuv420"``: y (B, Hm, Wm), u/v (B, Hm/2, Wm/2) uint8) or
    from padded RGB buffers (``"rgb"``: image (B, Hm, Wm, 3) uint8), each
    with the valid sizes image_hw (B, 2); DMDS takes the second frame in
    the same format, a ``with_3d`` model the intrinsics (B, 4) [fx, fy, cx,
    cy] in source pixels (``data_keys`` gives the order).

    ``model`` is left untouched: the pipeline serves a transformed copy.
    ``__call__`` pads a short batch up to ``params.batch_size`` by repeating
    the last row (as the reference pads to its mesh) and slices the results
    back. With ``mesh`` (whose device is ``device``), every rank of the
    mesh calls it with the same batch (module docstring); ``model`` may
    then hold a tensor-parallel training model's slices.
    """

    def __init__(self, params, model: nn.Module, device: DeviceLike,
                 input_format: str = "yuv420", tta: str = "none",
                 w8a8: Union[None, bool, Dict[str, float]] = None, w8a8_fused: bool = False,
                 w8a8_chain: bool = False, fold_bn: bool = False, mesh=None):
        if params.name not in _MODELS:
            raise ValueError(f"InferencePipeline: unknown model {params.name!r}")
        if input_format not in ("rgb", "yuv420"):
            raise ValueError(f"input_format must be rgb|yuv420, got {input_format!r}")
        if tta not in ("none", "hflip"):
            raise ValueError(f"tta must be none|hflip, got {tta!r}")
        if tta == "hflip" and getattr(params, "with_3d", False):
            raise ValueError("tta='hflip' is incompatible with with_3d decoding "
                             "(yaw sin/cos flips sign under mirroring)")
        if tta == "hflip" and params.name == "dmds":
            raise ValueError("tta='hflip' is incompatible with dmds (two-frame "
                             "motion mirrors under flip)")
        if params.name == "dmds" and w8a8 not in (None, False):
            raise ValueError("w8a8 serving is not supported for two-frame dmds "
                             "(matches cli.export)")
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
        if w8a8 is False:
            w8a8 = None
        if w8a8 is not None and w8a8 is not True and not isinstance(w8a8, dict):
            raise ValueError(f"w8a8 must be True (dynamic scales) or a scales dict, "
                             f"got {type(w8a8).__name__}")
        self.cfg = params
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"device {self.device} is not the mesh's {mesh.device}")
        self.mesh = mesh
        # dynamic activation scales (w8a8=True, a QAT model's fake quant)
        # are maxima over the whole batch, on every data rank alike
        self._reducer = LOCAL if mesh is None else mesh.reducer
        self.input_format, self.tta = input_format, tta
        self.with_3d = bool(getattr(params, "with_3d", False))
        self.keys = data_keys(params.name, input_format, self.with_3d)
        self._plain_weights = not fold_bn and w8a8 is None
        # A QAT model's fp forward is not what ships: serve the fake-quant
        # convs its train step ran, unless an int8 path already runs.
        self.fake_quant = bool(getattr(params, "qat", False)) and w8a8 is None
        self.fused_counts = self.int8_counts = self.folded_counts = None
        from cvm_tpu_torch.models.layers import bind_spatial_mesh

        model = copy.deepcopy(model).to(self.device).eval()
        self.tensor_parallel = self._place_stage5(model, w8a8 is None and not self.fake_quant)
        bind_spatial_mesh(model, mesh)
        if fold_bn:
            from cvm_tpu_torch.infer.fold_bn import fold_batchnorm, swap_folded

            model = fold_batchnorm(model)
            if w8a8 is None and not self.fake_quant:
                self.folded_counts = swap_folded(model)
        if w8a8_fused:
            from cvm_tpu_torch.infer.quantize import prequantize_fused_weights, swap_fused

            self.fused_counts = swap_fused(model, w8a8, prequantize_fused_weights(model),
                                           chain=w8a8_chain)
            if not self.fused_counts["calls"]:
                raise ValueError("w8a8_fused: no module matched the calibrated scales")
        elif w8a8 is not None:
            from cvm_tpu_torch.infer.quantize import Int8Conv, swap_int8

            self.int8_counts = swap_int8(model, None if w8a8 is True else w8a8)
            for m in model.modules():
                if isinstance(m, Int8Conv):
                    m.reducer = self._reducer
        self.model = model
        self._graphs = StepGraphs(self.run, self.device, blocked_by(self.device, mesh))
        self.graph_counts = self._graphs.counts

    def _place_stage5(self, model: nn.Module, split_ok: bool) -> bool:
        """Split ``model``'s stage-5 convs over the mesh's model axis, keep a
        split model's slices, or gather them whole where the posture needs
        whole weights (``split_ok`` False) or nothing splits; in place.
        Whether the served model is split."""
        from cvm_tpu_torch.parallel.sharding import (ColumnConv, RowConv, shard_module,
                                                     tp_rules_for, unshard_module)

        mesh = self.mesh
        split = (split_ok and mesh is not None and mesh.model > 1
                 and bool(getattr(self.cfg, "tensor_parallel", False)))
        held = [m.mesh for m in model.modules() if isinstance(m, (ColumnConv, RowConv))]
        if held and not split:
            unshard_module(model)
        elif split and not held:
            shard_module(model, mesh, tp_rules_for(self.cfg.name))
        elif held and any(m is not mesh for m in held):
            raise ValueError("the model's tensor-parallel slices belong to another mesh")
        return split

    def update_variables(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Serve new weights (a ``state_dict`` of the model). Valid only for
        the plain fp pipeline: fold_bn/w8a8 pipelines transform the weights
        when they are built; rebuild those."""
        if not self._plain_weights:
            raise ValueError(
                "update_variables on a fold_bn/w8a8 pipeline would serve "
                "untransformed weights — rebuild the pipeline instead")
        self.model.load_state_dict(state_dict, strict=True)

    def heads(self, proc: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The model's outputs on a preprocessed batch. With
        ``tta="hflip"`` the mirrored input's heatmap, size, logits and depth
        (those the model has) are flipped back and averaged with the plain
        pass's (the standard CenterNet flip test); the sub-pixel offset
        keeps the plain pass's."""
        from cvm_tpu_torch.train.qat import fake_quant_training

        with (fake_quant_training(self._reducer) if self.fake_quant
              else contextlib.nullcontext()):
            out = self.model(proc)
            if self.tta == "hflip":
                flipped = self.model(torch.flip(proc, dims=(2,)))
                out = dict(out)
                for k in _TTA_KEYS:
                    if k in out:
                        out[k] = 0.5 * (out[k] + torch.flip(flipped[k], dims=(2,)))
        return out

    @torch.no_grad()
    def predict(self, *data: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Device tensors in, device tensors out, in ``self.keys``' order:
        ``(y, u, v, image_hw)`` for yuv420, ``(image, image_hw)`` for rgb
        (DMDS's second frame and 3D intrinsics as ``data_keys`` says). With
        a mesh, this rank's rows alone: ``__call__`` shards a batch. On a
        CUDA device without a mesh, a graph of the step per input signature
        (module docstring); the outputs are the caller's own."""
        return self._graphs(data)

    def run(self, *data: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``predict`` without its ``no_grad``: the steps ``cli/export.py``
        records as a program."""
        d = dict(zip(self.keys, data))
        with span("cvm.infer.preprocess"):
            proc, rois = self._preprocess(d)
            if self.cfg.name == "dmds":  # frame t+1 through the same ROI (same image_hw)
                proc = torch.cat([proc, self._preprocess(d, "_t1")[0]], dim=-1)
        with span("cvm.infer.forward"):
            out = self.heads(proc)
        with span("cvm.infer.postprocess"):
            return postprocess(self.cfg, out, rois, d.get("intrinsics"))

    def _preprocess(self, d: Dict[str, torch.Tensor], frame: str = ""):
        hw = self.cfg.input_hw
        if self.input_format == "yuv420":
            return preprocess_yuv420_batch(d["y" + frame], d["u" + frame], d["v" + frame],
                                           d["image_hw"], hw, out_dtype=torch.bfloat16)
        return preprocess_image_batch(d["image" + frame], d["image_hw"], hw,
                                      out_dtype=torch.bfloat16)

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """batch: the pipeline's keys (numpy arrays or tensors); other keys
        (labels) are ignored. A ``with_3d`` batch without ``intrinsics``
        gets placeholder ones ([1, 1, 0, 0], as the reference): the 3D
        outputs are then geometrically meaningless but well formed."""
        with span("cvm.infer.call"):
            if self.with_3d and "intrinsics" not in batch:
                n = batch["image_hw"].shape[0]
                batch = dict(batch, intrinsics=np.tile(np.float32([[1.0, 1.0, 0.0, 0.0]]), (n, 1)))
            args = [batch[k] for k in self.keys]
            args = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in args]
            n = int(args[0].shape[0])
            padded = dict(zip(self.keys, pad_rows(args, self.cfg.batch_size)))
            out = shard_predict(self.mesh, self._predict_host)(padded)
            return {k: v[:n] for k, v in out.items()}

    def _predict_host(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return self._graphs([torch.from_numpy(batch[k]) for k in self.keys], h2d=True)


def shard_predict(mesh, predict: Callable[[Dict[str, Any]], Dict[str, Any]]
                  ) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """``predict`` (a batch dict -> a dict of results, e.g. an artifact's
    ``ServingModel.predict_batch``) sharded over ``mesh``'s data ranks:
    every rank is called with the same batch, takes its rows of each array
    with the batch's rows (``image_hw``'s), padded to a multiple of the data
    ranks by repeating the last, and returns every rank's results in row
    order. The identity without a mesh or a data axis."""
    if mesh is None or mesh.data == 1:
        return predict

    def run(batch: Dict[str, Any]) -> Dict[str, Any]:
        n = int(batch["image_hw"].shape[0])
        keys = [k for k, v in batch.items() if getattr(v, "shape", ())[:1] == (n,)]
        host = [v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for v in (batch[k] for k in keys)]
        out = mesh.replicated(predict(dict(zip(keys, mesh.shard_batch(host, n)))))
        return {k: v[:n] for k, v in out.items()}

    return run
