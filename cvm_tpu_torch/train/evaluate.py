"""Evaluation: COCO-style detection mAP (and the numpy semseg, depth and 3D
evaluators), and ``evaluate_model``, which scores a model through the
``InferencePipeline``.

Mirrors ``cvm_tpu/train/evaluate.py``. ``box_iou_matrix``,
``DetectionEvaluator``, ``Detection3dEvaluator``, ``SemsegEvaluator``,
``DepthEvaluator``, ``COCO_IOU_THRESHOLDS`` and ``_COCO_AREA_BUCKETS`` are
numpy only and copied verbatim (``tests/test_torch_vendored.py`` holds them
identical to the originals). ``evaluate_model`` is ported for the whole
zoo, with the GT masks and depth resampled through the eval letterbox
(``sample_nearest``): a ``with_3d`` CenterNet adds the 3D metrics
(``Detection3dEvaluator`` on the 2D-matched detections), and DMDS's
unsupervised, scale-ambiguous depth is scored median-scaled.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cvm_tpu_torch.utils.device import DeviceLike

COCO_IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy → (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


class DetectionEvaluator:
    """Accumulates per-image detections + GT; computes COCO-style mAP."""

    def __init__(self, num_classes: int, iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS):
        self.num_classes = num_classes
        self.thresholds = list(iou_thresholds)
        # per class: list of (score, is_tp_per_threshold) plus GT count
        self._dets: List[List[Tuple[float, np.ndarray]]] = [[] for _ in range(num_classes)]
        self._n_gt = np.zeros(num_classes, np.int64)

    def add_image(
        self,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_classes: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
        score_threshold: float = 0.01,
        gt_ignore: Optional[np.ndarray] = None,
        det_area_range: Optional[Tuple[float, float]] = None,
    ) -> None:
        """``gt_ignore``: (G,) bool — COCO ignore semantics: a detection that
        best-matches an ignored GT is dropped from scoring (neither TP nor
        FP), and ignored GTs don't count toward recall.

        ``det_area_range``: (lo, hi) — COCO dtIg semantics for the
        size-bucketed breakdown: an UNMATCHED detection whose own box area
        falls outside the bucket is also dropped (it's a false positive for
        its own size bucket, not for every bucket). Matched detections are
        never area-filtered (the match already localises them to a bucket
        via the GT)."""
        keep = det_scores >= score_threshold
        det_boxes, det_scores, det_classes = det_boxes[keep], det_scores[keep], det_classes[keep]
        if gt_ignore is None:
            gt_ignore = np.zeros(len(gt_boxes), bool)
        for c in range(self.num_classes):
            sel = gt_classes == c
            gtc = gt_boxes[sel]
            ign = np.asarray(gt_ignore)[sel]
            self._n_gt[c] += int((~ign).sum())
            dc = det_classes == c
            boxes = det_boxes[dc]
            scores = det_scores[dc]
            order = np.argsort(-scores)
            boxes, scores = boxes[order], scores[order]
            iou = box_iou_matrix(boxes, gtc)
            T = len(self.thresholds)
            matched = np.zeros((T, len(gtc)), bool)
            det_areas = (np.prod(np.clip(boxes[:, 2:] - boxes[:, :2], 0, None), -1)
                         if len(boxes) else np.zeros(0))
            for i in range(len(boxes)):
                tp = np.zeros(T, bool)
                ignored = np.zeros(T, bool)
                for t, thr in enumerate(self.thresholds):
                    if len(gtc):
                        # Prefer non-ignored GTs (COCO: match real GTs first).
                        cand = np.where(~matched[t] & (iou[i] >= thr) & ~ign)[0]
                        if len(cand):
                            j = cand[np.argmax(iou[i][cand])]
                            matched[t, j] = True
                            tp[t] = True
                            continue
                        icand = np.where((iou[i] >= thr) & ign)[0]
                        if len(icand):
                            ignored[t] = True  # matched an ignored GT → drop
                            continue
                    if det_area_range is not None and not (
                            det_area_range[0] <= det_areas[i] < det_area_range[1]):
                        ignored[t] = True  # unmatched + out-of-bucket → dtIg
                self._dets[c].append((float(scores[i]), tp, ignored))

    def compute(self, per_class: bool = False) -> Dict[str, float]:
        T = len(self.thresholds)
        ap = np.full((self.num_classes, T), np.nan)
        for c in range(self.num_classes):
            if self._n_gt[c] == 0:
                continue
            dets = sorted(self._dets[c], key=lambda x: -x[0])
            if not dets:
                ap[c] = 0.0
                continue
            tps = np.stack([d[1] for d in dets])   # (D, T)
            igns = np.stack([d[2] for d in dets])  # (D, T)
            for t in range(T):
                use = ~igns[:, t]  # ignored-at-t dets are neither TP nor FP
                tp = tps[use, t].astype(np.float64)
                fp = 1.0 - tp
                ctp, cfp = np.cumsum(tp), np.cumsum(fp)
                recall = ctp / self._n_gt[c]
                precision = ctp / np.maximum(ctp + cfp, 1e-9)
                # COCO 101-point interpolation
                q = np.zeros(101)
                pr = precision.copy()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                idx = np.searchsorted(recall, np.linspace(0, 1, 101), side="left")
                valid = idx < len(pr)
                q[valid] = pr[idx[valid]]
                ap[c, t] = q.mean()
        present = ~np.isnan(ap[:, 0])
        if not present.any():
            return {"mAP": 0.0, "mAP50": 0.0, "mAP75": 0.0}
        m = np.nanmean(ap[present], axis=0)
        out = {"mAP": float(m.mean()), "mAP50": float(m[0])}
        i75 = self.thresholds.index(0.75) if 0.75 in self.thresholds else None
        out["mAP75"] = float(m[i75]) if i75 is not None else float("nan")
        if per_class:
            for c in range(self.num_classes):
                if present[c]:
                    out[f"ap_class_{c}"] = float(np.nanmean(ap[c]))
        return out

    def pr_curves(self, iou: float = 0.5, max_points: int = 101) -> Dict:
        """Per-class operating-point curves at one IoU threshold:
        score → (precision, recall), downsampled to max_points. This is the
        data behind AP — exposed so a deployment score_threshold can be
        picked from measured precision/recall instead of folklore."""
        t = self.thresholds.index(iou)
        curves: Dict[str, Dict[str, list]] = {}
        for c in range(self.num_classes):
            if self._n_gt[c] == 0 or not self._dets[c]:
                continue
            dets = sorted(self._dets[c], key=lambda x: -x[0])
            scores = np.asarray([d[0] for d in dets])
            tps = np.stack([d[1] for d in dets])[:, t]
            use = ~np.stack([d[2] for d in dets])[:, t]
            scores, tp = scores[use], tps[use].astype(np.float64)
            if not len(scores):
                continue
            ctp = np.cumsum(tp)
            cfp = np.cumsum(1.0 - tp)
            recall = ctp / self._n_gt[c]
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            idx = np.unique(np.linspace(0, len(scores) - 1,
                                        min(max_points, len(scores))).astype(int))
            curves[str(c)] = {
                "score": np.round(scores[idx], 4).tolist(),
                "precision": np.round(precision[idx], 4).tolist(),
                "recall": np.round(recall[idx], 4).tolist(),
                "n_gt": int(self._n_gt[c]),
            }
        return {"iou": iou, "classes": curves}


class Detection3dEvaluator:
    """Monocular 3D box quality on 2D-matched true positives.

    Detections are matched to GT greedily on 2D IoU (>= 0.5, class-aware,
    score-ordered); on the matches we accumulate camera-frame center error
    (the nuScenes-style center-distance view of 3D quality) and depth
    abs-rel. Reported alongside the 2D mAP for with_3d configs.
    """

    def __init__(self, iou_threshold: float = 0.5, score_threshold: float = 0.3):
        self.iou = iou_threshold
        self.score = score_threshold
        self.center_err = 0.0
        self.depth_abs_rel = 0.0
        self.n_matched = 0
        self.n_gt = 0

    def add_image(self, det_boxes, det_scores, det_classes, det_centers3d,
                  gt_boxes, gt_classes, gt_loc3d) -> None:
        # GTs without a valid 3D annotation (z <= 0) are excluded up front:
        # they must neither absorb a match (blocking a later valid pairing)
        # nor inflate the matched-fraction denominator.
        valid_gt = np.asarray(gt_loc3d)[:, 2] > 0 if len(gt_boxes) else \
            np.zeros(0, bool)
        self.n_gt += int(valid_gt.sum())
        keep = det_scores >= self.score
        boxes, scores = det_boxes[keep], det_scores[keep]
        classes, centers = det_classes[keep], det_centers3d[keep]
        order = np.argsort(-scores)
        iou = box_iou_matrix(boxes[order], gt_boxes)
        used = np.zeros(len(gt_boxes), bool)
        for r, d in enumerate(order):
            cand = np.where((iou[r] >= self.iou) & ~used & valid_gt
                            & (gt_classes == classes[d]))[0]
            if len(cand) == 0:
                continue
            g = cand[np.argmax(iou[r][cand])]
            used[g] = True
            dz = float(gt_loc3d[g][2])
            err = float(np.linalg.norm(centers[d] - gt_loc3d[g]))
            self.center_err += err
            self.depth_abs_rel += abs(float(centers[d][2]) - dz) / dz
            self.n_matched += 1

    def compute(self) -> Dict[str, float]:
        n = max(self.n_matched, 1)
        return {
            "center_err_3d_m": self.center_err / n,
            "depth3d_abs_rel": self.depth_abs_rel / n,
            "matched_3d_frac": self.n_matched / max(self.n_gt, 1),
        }


class SemsegEvaluator:
    """Streaming confusion matrix → per-class IoU + mIoU + pixel acc."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.C = num_classes
        self.ignore = ignore_index
        self.cm = np.zeros((num_classes, num_classes), np.int64)

    def add(self, pred: np.ndarray, label: np.ndarray) -> None:
        valid = (label != self.ignore) & (label < self.C)
        p = pred[valid].astype(np.int64)
        l = label[valid].astype(np.int64)
        np.add.at(self.cm, (l, p), 1)

    def compute(self, per_class: bool = False,
                confusion: bool = False) -> Dict[str, float]:
        inter = np.diag(self.cm).astype(np.float64)
        union = self.cm.sum(0) + self.cm.sum(1) - inter
        present = union > 0
        iou = inter[present] / np.maximum(union[present], 1)
        acc = inter.sum() / max(self.cm.sum(), 1)
        out = {"miou": float(iou.mean()) if present.any() else 0.0,
               "pixel_acc": float(acc)}
        if per_class:
            full = inter / np.maximum(union, 1)
            for c in range(self.C):
                if present[c]:
                    out[f"iou_class_{c}"] = float(full[c])
        if confusion:
            # Row-normalized (recall-view): confusion[gt][pred] = fraction of
            # GT-class pixels predicted as each class. JSON-safe nested list.
            rows = self.cm.astype(np.float64)
            rows /= np.maximum(rows.sum(1, keepdims=True), 1)
            out["confusion"] = [[round(float(v), 4) for v in r] for r in rows]
        return out


class DepthEvaluator:
    """Streaming masked depth metrics: abs_rel, rmse, delta thresholds.

    ``median_scale=True`` applies the standard unsupervised-monodepth
    protocol (KITTI eval for DMDS-style models, whose depth is only defined
    up to scale): each image's prediction is rescaled by
    median(gt)/median(pred) before scoring."""

    def __init__(self, median_scale: bool = False):
        self.sums = {"abs_rel": 0.0, "sq_rel": 0.0, "se": 0.0, "d1": 0.0, "d2": 0.0, "d3": 0.0}
        self.n = 0
        self.median_scale = median_scale

    def add(self, pred: np.ndarray, gt: np.ndarray) -> None:
        mask = gt > 0
        if not mask.any():
            return
        p, g = pred[mask].astype(np.float64), gt[mask].astype(np.float64)
        if self.median_scale:
            p = p * (np.median(g) / max(np.median(p), 1e-6))
        r = np.maximum(p / g, g / np.maximum(p, 1e-6))
        n = mask.sum()
        self.sums["abs_rel"] += float(np.sum(np.abs(p - g) / g))
        self.sums["sq_rel"] += float(np.sum((p - g) ** 2 / g))
        self.sums["se"] += float(np.sum((p - g) ** 2))
        self.sums["d1"] += float(np.sum(r < 1.25))
        self.sums["d2"] += float(np.sum(r < 1.25**2))
        self.sums["d3"] += float(np.sum(r < 1.25**3))
        self.n += int(n)

    def compute(self) -> Dict[str, float]:
        n = max(self.n, 1)
        return {
            "abs_rel": self.sums["abs_rel"] / n,
            "sq_rel": self.sums["sq_rel"] / n,
            "rmse": float(np.sqrt(self.sums["se"] / n)),
            "delta1": self.sums["d1"] / n,
            "delta2": self.sums["d2"] / n,
            "delta3": self.sums["d3"] / n,
        }


_COCO_AREA_BUCKETS = {"small": (0.0, 32.0**2), "medium": (32.0**2, 96.0**2),
                      "large": (96.0**2, float("inf"))}


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def evaluate_model(spec: str, cfg, model, loader, max_batches: Optional[int] = None,
                   device: DeviceLike = "cuda", input_format: str = "auto",
                   per_class: bool = False,
                   size_buckets: bool = False,
                   confusion: bool = False,
                   pr_curves: bool = False,
                   tta: str = "none",
                   w8a8=None,
                   w8a8_fused: bool = False,
                   w8a8_chain: bool = False,
                   fold_bn: bool = False,
                   predict_fn=None,
                   stats: Optional[Dict[str, float]] = None,
                   mesh=None) -> Dict[str, float]:
    """Run the end-to-end pipeline over a loader and compute the metrics.

    ``spec`` is the model's zoo name (centernet, semseg, depth, multitask
    or dmds); ``model`` the eval-mode model (the pipeline serves a copy,
    so it is left untouched);
    ``device`` where the pipeline runs. ``input_format``: "rgb", "yuv420",
    or "auto" (from the first batch's keys). ``w8a8`` (True for dynamic
    scales, or calibrated ``{conv module name: scale}``), ``w8a8_fused``,
    ``w8a8_chain``,
    ``fold_bn`` and ``tta`` are the ``InferencePipeline`` knobs, so the
    deployed numerics are what is scored. ``predict_fn(batch) -> output
    dict`` replaces the pipeline; ``model`` may then be None. Detection
    models report mAP (``per_class``, ``size_buckets``, ``pr_curves``),
    segmentation models mIoU and pixel accuracy (``per_class``,
    ``confusion``), depth models abs_rel, sq_rel, rmse and delta1-3 (DMDS
    median-scaled); a ``with_3d`` model adds ``center_err_3d_m``,
    ``depth3d_abs_rel`` and ``matched_3d_frac`` where the batches carry
    ``loc3d`` (the pipeline reads their ``intrinsics``).

    ``stats``, when given, receives ``batches``, ``predict_s`` (host seconds
    in the pipeline, copies to and from the device included) and
    ``evaluator_s`` (host seconds in the evaluators).

    ``mesh`` (``parallel/mesh.py``; ``device`` is its device) shards the
    predictions, as the reference's ``evaluate_model(mesh=)``: every rank
    calls this with the same loader, each data rank predicts its rows of a
    batch (``InferencePipeline(mesh=)``, or ``shard_predict`` of
    ``predict_fn``), the predictions are gathered in batch order, and every
    rank's numpy evaluators return the same metrics.
    """
    from cvm_tpu_torch.infer.pipeline import InferencePipeline, shard_predict
    from cvm_tpu_torch.pipeline.preprocess import make_rois, resample_labels

    pipe = None  # built on the first batch once the format is known
    det_eval = seg_eval = dep_eval = det3d_eval = None
    bucket_evals: Dict[str, DetectionEvaluator] = {}
    if spec in ("centernet", "multitask"):
        n_det = getattr(cfg, "num_classes", getattr(cfg, "num_det_classes", 0))
        det_eval = DetectionEvaluator(n_det)
        if size_buckets:
            # COCO-style area breakdown: out-of-bucket GTs are IGNORED
            # (match neither TP nor FP) per the standard protocol.
            bucket_evals = {name: DetectionEvaluator(n_det) for name in _COCO_AREA_BUCKETS}
        if getattr(cfg, "with_3d", False):
            det3d_eval = Detection3dEvaluator()
    if spec in ("semseg", "multitask"):
        seg_eval = SemsegEvaluator(getattr(cfg, "num_classes", getattr(cfg, "num_seg_classes", 0)),
                                   getattr(cfg, "ignore_index", 255))
    if spec in ("depth", "multitask", "dmds"):
        # DMDS depth is unsupervised and scale-ambiguous: the median-scaling
        # protocol.
        dep_eval = DepthEvaluator(median_scale=(spec == "dmds"))

    def resample_gt(key, pad_value):
        # The GT map through the eval letterbox on the CPU: it goes to the
        # numpy evaluators.
        gt = {k: torch.as_tensor(np.asarray(batch[k])) for k in ("image_hw", key)}
        rois = make_rois(gt["image_hw"], cfg.input_hw)
        return resample_labels(gt, key, rois, cfg.input_hw, pad_value).numpy()

    predict_s = evaluator_s = 0.0
    n = 0
    for batch in loader:
        if max_batches is not None and n >= max_batches:
            break
        if pipe is None:
            if predict_fn is not None:
                pipe = shard_predict(mesh, predict_fn)
            else:
                fmt = input_format
                if fmt == "auto":
                    fmt = "yuv420" if "y" in batch and "image" not in batch else "rgb"
                pipe = InferencePipeline(cfg, model, device, input_format=fmt, tta=tta,
                                         w8a8=w8a8, w8a8_fused=w8a8_fused,
                                         w8a8_chain=w8a8_chain, fold_bn=fold_bn, mesh=mesh)
        t0 = time.perf_counter()
        out = {k: _to_numpy(v) for k, v in pipe(batch).items()}
        t1 = time.perf_counter()
        B = batch["image_hw"].shape[0]
        gt_masks = gt_depths = None
        if seg_eval is not None and "mask" in batch:
            gt_masks = resample_gt("mask", getattr(cfg, "ignore_index", 255))
        if dep_eval is not None and "depth" in batch and "depth" in out:
            gt_depths = resample_gt("depth", 0.0)
        for i in range(B):
            if gt_masks is not None:
                seg_eval.add(out["class_map"][i], gt_masks[i])
            if gt_depths is not None:
                dep_eval.add(out["depth"][i][..., 0], gt_depths[i])
            if det_eval is None or "boxes" not in batch:
                continue
            ng = int(batch["num_objects"][i])
            gt_b = np.asarray(batch["boxes"][i][:ng])
            gt_c = np.asarray(batch["classes"][i][:ng])
            det_eval.add_image(out["boxes"][i], out["scores"][i], out["classes"][i],
                               gt_b, gt_c)
            if bucket_evals:
                areas = np.prod(np.clip(gt_b[:, 2:] - gt_b[:, :2], 0, None), -1) \
                    if ng else np.zeros(0)
                for name, (lo, hi) in _COCO_AREA_BUCKETS.items():
                    in_bucket = (areas >= lo) & (areas < hi)
                    bucket_evals[name].add_image(
                        out["boxes"][i], out["scores"][i], out["classes"][i],
                        gt_b, gt_c, gt_ignore=~in_bucket, det_area_range=(lo, hi))
            if det3d_eval is not None and "centers3d" in out and "loc3d" in batch:
                det3d_eval.add_image(out["boxes"][i], out["scores"][i], out["classes"][i],
                                     out["centers3d"][i], gt_b, gt_c,
                                     np.asarray(batch["loc3d"][i][:ng]))
        predict_s += t1 - t0
        evaluator_s += time.perf_counter() - t1
        n += 1

    t0 = time.perf_counter()
    metrics: Dict[str, float] = {}
    if det_eval is not None:
        metrics.update(det_eval.compute(per_class=per_class))
        if pr_curves:
            metrics["pr_curves"] = det_eval.pr_curves()
    for name, ev in bucket_evals.items():
        metrics[f"mAP_{name}"] = ev.compute()["mAP"]
    if det3d_eval is not None:
        metrics.update(det3d_eval.compute())
    if seg_eval is not None:
        metrics.update(seg_eval.compute(per_class=per_class, confusion=confusion))
    if dep_eval is not None:
        metrics.update(dep_eval.compute())
    if stats is not None:
        stats.update(batches=n, predict_s=predict_s,
                     evaluator_s=evaluator_s + time.perf_counter() - t0)
    return metrics
