#!/usr/bin/env python3
"""The port's flagship run against the reference's, from their records.

    python3 scripts/compare_flagship.py OUT

OUT is the directory ``scripts/flagship_torch.sh`` wrote (metrics.jsonl,
best.json, eval_<posture>.json, eval.log, card.txt), or a pair of committed
files given as OUT=<prefix> (``<prefix>_metrics.jsonl`` and
``<prefix>_best.json``). Prints the card, the logged loss at steps 100, 500,
1000, 2500 and 5000 beside the reference's, the mean logged loss over steps
100-1000 and 4100-5000, val_mAP at each eval, ms per step (from the logged
steps/s of each 100-step window) and seconds per eval, and each posture's
mAP with its difference from fp. The reference is the run in
``benchmarks/data/results/flagship_512@20260820T083238Z_*``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys

REF = "benchmarks/data/results/flagship_512@20260820T083238Z"
POSTURES = ["fp", "fold_bn", "int8", "w8a8_fused", "w8a8_fused_chain", "tta_hflip"]


def rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def paths(out):
    if os.path.isdir(out):
        return os.path.join(out, "metrics.jsonl"), os.path.join(out, "best.json")
    return f"{out}_metrics.jsonl", f"{out}_best.json"


def mean_loss(recs, lo, hi):
    vals = [r["loss"] for r in recs if "loss" in r and lo <= r["step"] <= hi]
    return statistics.mean(vals), len(vals)


def main(argv) -> int:
    out = argv[0]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    ref = rows(os.path.join(root, f"{REF}_metrics.jsonl"))
    metrics_path, best_path = paths(out)
    port = rows(metrics_path)
    if os.path.isdir(out) and os.path.exists(os.path.join(out, "card.txt")):
        with open(os.path.join(out, "card.txt")) as f:
            print(f"card: {f.readline().strip()}")
    loss = {r["step"]: r["loss"] for r in port if "loss" in r}
    ref_loss = {r["step"]: r["loss"] for r in ref if "loss" in r}
    print("step   port loss   reference loss   port/reference")
    for s in (100, 500, 1000, 2500, 5000):
        if s in loss and s in ref_loss:
            print(f"{s:5d}   {loss[s]:9.4f}   {ref_loss[s]:14.4f}   {loss[s] / ref_loss[s]:.3f}")
    for lo, hi in ((100, 1000), (4100, 5000)):
        (m, n), (rm, rn) = mean_loss(port, lo, hi), mean_loss(ref, lo, hi)
        print(f"mean logged loss, steps {lo}-{hi}: port {m:.4f} ({n} rows), reference "
              f"{rm:.4f} ({rn} rows), ratio {m / rm:.3f}")
    ref_val = {r["step"]: r["val_mAP"] for r in ref if "val_mAP" in r}
    for r in port:
        if "val_mAP" in r:
            print(f"val_mAP @{r['step']}: port {r['val_mAP']:.4f} (mAP50 {r['val_mAP50']:.4f}, "
                  f"mAP75 {r['val_mAP75']:.4f}; {r.get('eval_seconds', float('nan')):.2f} s), "
                  f"reference {ref_val.get(r['step'], float('nan')):.4f}")
    step_ms = [1e3 / r["steps_per_sec"] for r in port if "steps_per_sec" in r and r["step"] > 100]
    if step_ms:
        print(f"ms per step over {len(step_ms)} logged 100-step windows after step 100: median "
              f"{statistics.median(step_ms):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}")
    with open(best_path) as f:
        print(f"best.json: {json.load(f)}")
    if not os.path.isdir(out):
        return 0
    seconds = {}
    log = os.path.join(out, "eval.log")
    if os.path.exists(log):
        for line in open(log):
            m = re.match(r"\[flagship_torch\] (\S+): ([\d.]+) s for the call", line)
            if m:
                seconds[m.group(1)] = float(m.group(2))
    maps = {}
    for p in POSTURES:
        path = os.path.join(out, f"eval_{p}.json")
        if os.path.exists(path):
            with open(path) as f:
                maps[p] = json.load(f)
    fp = maps.get("fp", {}).get("mAP")
    print("posture            mAP      mAP50    mAP75    d vs fp    s for the call")
    for p, m in maps.items():
        d = m["mAP"] - fp if fp is not None else float("nan")
        print(f"{p:17s}  {m['mAP']:.4f}   {m['mAP50']:.4f}   {m['mAP75']:.4f}   {d:+.4f}    "
              f"{seconds.get(p, float('nan')):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
