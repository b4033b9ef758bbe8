#!/usr/bin/env python3
"""The port's semseg flagship run against the reference's, from their records.

    python3 scripts/compare_flagship_semseg.py OUT

OUT is the directory ``scripts/flagship_semseg_torch.sh`` wrote
(metrics.jsonl, best.json, eval_<posture>.json, eval.log, card.txt), or a
pair of committed files given as OUT=<prefix> (``<prefix>_metrics.jsonl``
and ``<prefix>_best.json``, with the postures, their seconds and the
card in ``<prefix>_eval.json`` when present). Prints the card, the logged loss at steps 100, 500, 1000,
2000 and 4000 beside the reference's, val_miou at each eval, ms per step,
and each posture's mIoU with its difference from fp. The reference is the
run in ``benchmarks/data/results/flagship_semseg@20260820T133134Z_*``; its
``w8a8_fused_chain`` score is ``benchmarks/data/results/semseg_eval_chain.json``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys

REF = "benchmarks/data/results/flagship_semseg@20260820T133134Z"
REF_CHAIN = "benchmarks/data/results/semseg_eval_chain.json"
POSTURES = ["fp", "fold_bn", "w8a8_fused", "w8a8_fused_chain"]


def rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def main(argv) -> int:
    out = argv[0]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    ref = rows(os.path.join(root, f"{REF}_metrics.jsonl"))
    with open(os.path.join(root, REF_CHAIN)) as f:
        ref_chain = json.load(f)
    is_dir = os.path.isdir(out)
    port = rows(os.path.join(out, "metrics.jsonl") if is_dir else f"{out}_metrics.jsonl")
    if is_dir and os.path.exists(os.path.join(out, "card.txt")):
        with open(os.path.join(out, "card.txt")) as f:
            print(f"card: {f.readline().strip()}")
    loss = {r["step"]: r["loss"] for r in port if "loss" in r}
    ref_loss = {r["step"]: r["loss"] for r in ref if "loss" in r}
    print("step   port loss   reference loss   port/reference")
    for s in (100, 500, 1000, 2000, 4000):
        if s in loss and s in ref_loss:
            print(f"{s:5d}   {loss[s]:9.4f}   {ref_loss[s]:14.4f}   {loss[s] / ref_loss[s]:.3f}")
    ref_val = {r["step"]: r["val_miou"] for r in ref if "val_miou" in r}
    for r in port:
        if "val_miou" in r:
            print(f"val_miou @{r['step']}: port {r['val_miou']:.4f} (pixel_acc "
                  f"{r['val_pixel_acc']:.4f}; {r.get('eval_seconds', float('nan')):.2f} s), "
                  f"reference {ref_val.get(r['step'], float('nan')):.4f}")
    step_ms = [1e3 / r["steps_per_sec"] for r in port if "steps_per_sec" in r and r["step"] > 100]
    if step_ms:
        print(f"ms per step over {len(step_ms)} logged 100-step windows after step 100: median "
              f"{statistics.median(step_ms):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}")
    with open(os.path.join(out, "best.json") if is_dir else f"{out}_best.json") as f:
        print(f"best.json: {json.load(f)}")
    maps, seconds = {}, {}
    if is_dir:
        for p in POSTURES:
            path = os.path.join(out, f"eval_{p}.json")
            if os.path.exists(path):
                with open(path) as f:
                    maps[p] = json.load(f)
        log = os.path.join(out, "eval.log")
        if os.path.exists(log):
            for line in open(log):
                m = re.match(r"\[flagship_semseg_torch\] (\S+): ([\d.]+) s for the call", line)
                if m:
                    seconds[m.group(1)] = float(m.group(2))
    elif os.path.exists(f"{out}_eval.json"):
        with open(f"{out}_eval.json") as f:
            rec = json.load(f)
        print(f"card: {rec['card']}")
        maps = {p: rec[p] for p in POSTURES if p in rec}
        seconds = {p: m["seconds_for_the_call"] for p, m in maps.items()}
    fp = maps.get("fp", {}).get("miou")
    print("posture            mIoU     pixel_acc   d vs fp    s for the call")
    for p, m in maps.items():
        d = m["miou"] - fp if fp is not None else float("nan")
        print(f"{p:17s}  {m['miou']:.4f}   {m['pixel_acc']:.4f}      {d:+.4f}    "
              f"{seconds.get(p, float('nan')):.2f}")
    print(f"reference: val_miou {ref_val.get(4000, float('nan')):.4f} @4000 (its eval), "
          f"w8a8_fused_chain {ref_chain['miou']:.4f} (d {ref_chain['miou'] - ref_val[4000]:+.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
