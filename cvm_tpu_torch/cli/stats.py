"""Dataset statistics CLI: class balance, box sizes, label coverage.

``python -m cvm_tpu_torch.cli.stats --data train.cvrec [val.cvrec ...] --json``

Mirrors ``cvm_tpu/cli/stats.py`` (``compute_stats``, ``_print_human``,
``main``), numpy only there too: the same dict for the same shards
(``tests/test_torch_data_tools.py``). The reference's docstring follows.

The reference's workflow tunes per-class loss weights by eyeballing dataset
balance (SURVEY.md §4 upload-verification loop); this tool computes it from
the packed store directly: record/label coverage, per-class box counts,
COCO-style box-size buckets, image-size distribution, mask class histogram
(sampled — dense blobs are expensive on one core), depth coverage, and a
suggested ``class_weights`` vector (inverse-sqrt frequency, normalized to
mean 1) ready to paste into a semseg/multitask config.

Host-only: no device, no model — runs anywhere the shards are.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Any, Dict, Sequence

import numpy as np

_AREA_BUCKETS = (("small", 0.0, 32.0 ** 2), ("medium", 32.0 ** 2, 96.0 ** 2),
                 ("large", 96.0 ** 2, float("inf")))


def compute_stats(paths: Sequence[str], mask_samples: int = 64,
                  seed: int = 0) -> Dict[str, Any]:
    from cvm_tpu_torch.data.records import RecordDataset

    ds = RecordDataset(list(paths))
    n = len(ds)
    box_classes: Counter = Counter()
    bucket_counts = Counter()
    label_presence = Counter()
    img_hw = []
    boxes_per_frame = []
    depth_cov_sum, depth_cov_n = 0.0, 0
    mask_hist: Counter = Counter()
    mask_hits = 0  # sampled records that actually carried a mask

    rng = np.random.default_rng(seed)
    mask_ids = set(rng.choice(n, size=min(mask_samples, n), replace=False).tolist()) if n else set()

    for i in range(n):
        meta, blobs = ds.get(i)
        h, w = meta.get("height"), meta.get("width")
        if h and w:
            img_hw.append((int(h), int(w)))
        for k in ("boxes", "loc3d", "intrinsics"):
            if k in meta:
                label_presence[k] += 1
        for k in ("mask", "depth", "jpeg", "image", "y", "jpeg_t1", "y_t1"):
            if k in blobs:
                label_presence[k] += 1
        bx = meta.get("boxes") or []
        boxes_per_frame.append(len(bx))
        cls = meta.get("classes") or [0] * len(bx)
        for b, c in zip(bx, cls):
            box_classes[int(c)] += 1
            area = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
            for name, lo, hi in _AREA_BUCKETS:
                if lo <= area < hi:
                    bucket_counts[name] += 1
                    break
        # Dense blobs only on the sampled subset (decode cost).
        if i in mask_ids:
            if "mask" in blobs:
                mask_hits += 1
                vals, cnts = np.unique(np.asarray(blobs["mask"]), return_counts=True)
                for v, c in zip(vals.tolist(), cnts.tolist()):
                    mask_hist[int(v)] += int(c)
            if "depth" in blobs:
                d = np.asarray(blobs["depth"])
                depth_cov_sum += float((d > 0).mean())
                depth_cov_n += 1

    out: Dict[str, Any] = {
        "records": n,
        "shards": len(paths),
        "label_presence": dict(label_presence),
        "boxes_total": int(sum(box_classes.values())),
        "boxes_per_frame_mean": float(np.mean(boxes_per_frame)) if boxes_per_frame else 0.0,
        "boxes_per_frame_max": int(max(boxes_per_frame)) if boxes_per_frame else 0,
        "box_classes": {str(k): v for k, v in sorted(box_classes.items())},
        "box_size_buckets": {k: bucket_counts.get(k, 0) for k, _, _ in _AREA_BUCKETS},
    }
    if img_hw:
        hw = np.asarray(img_hw)
        out["image_hw_min"] = [int(v) for v in hw.min(0)]
        out["image_hw_max"] = [int(v) for v in hw.max(0)]
        out["image_hw_mean"] = [float(v) for v in hw.mean(0).round(1)]
    if mask_hist:
        # 255 is the ignore convention (data/loader.py) — report it apart.
        ignore = mask_hist.pop(255, 0)
        total = sum(mask_hist.values())
        out["mask_sampled_frames"] = mask_hits
        out["mask_class_freq"] = {str(k): round(v / max(total, 1), 6)
                                  for k, v in sorted(mask_hist.items())}
        out["mask_ignore_frac"] = round(ignore / max(total + ignore, 1), 6)
        # Inverse-sqrt-frequency weights, mean-normalized: the standard
        # starting point for class_weights on an imbalanced semseg set.
        ks = sorted(mask_hist)
        freq = np.asarray([mask_hist[k] / total for k in ks], np.float64)
        wts = 1.0 / np.sqrt(np.maximum(freq, 1e-8))
        wts = wts / wts.mean()
        out["suggested_class_weights"] = {str(k): round(float(v), 3)
                                          for k, v in zip(ks, wts)}
    if depth_cov_n:
        out["depth_valid_frac_mean"] = round(depth_cov_sum / depth_cov_n, 4)
    return out


def _print_human(s: Dict[str, Any]) -> None:
    print(f"records: {s['records']}  (shards: {s['shards']})")
    print(f"label presence: {s['label_presence']}")
    print(f"boxes: {s['boxes_total']} total, "
          f"{s['boxes_per_frame_mean']:.1f}/frame mean, "
          f"{s['boxes_per_frame_max']} max")
    if s["box_classes"]:
        print(f"box classes: {s['box_classes']}")
        print(f"box size buckets (COCO areas): {s['box_size_buckets']}")
    if "image_hw_mean" in s:
        print(f"image hw: min {s['image_hw_min']} mean {s['image_hw_mean']} "
              f"max {s['image_hw_max']}")
    if "mask_class_freq" in s:
        print(f"mask class freq (sampled {s['mask_sampled_frames']} frames): "
              f"{s['mask_class_freq']}  ignore={s['mask_ignore_frac']}")
        print(f"suggested class_weights: {s['suggested_class_weights']}")
    if "depth_valid_frac_mean" in s:
        print(f"depth valid fraction: {s['depth_valid_frac_mean']}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", required=True, nargs="+", help=".cvrec shard(s)")
    parser.add_argument("--mask_samples", type=int, default=64,
                        help="frames to sample for dense mask/depth stats")
    parser.add_argument("--json", action="store_true", help="emit one JSON line")
    args = parser.parse_args(argv)
    s = compute_stats(args.data, mask_samples=args.mask_samples)
    if args.json:
        print(json.dumps(s))
    else:
        _print_human(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
