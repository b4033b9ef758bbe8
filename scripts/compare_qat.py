#!/usr/bin/env python3
"""The port's int8 deployment run against the reference's, from their
records, with the acceptance bound of each row.

    python3 scripts/compare_qat.py OUT

OUT is the directory ``scripts/qat_torch.sh`` wrote, or the prefix of its
committed records (``<prefix>_<name>``, with ``flagship/x`` named
``flagship_x``). Prints the card, the fp flagship's ``val_mAP`` at step
5000, post-training ``w8a8_static`` and dynamic ``w8a8`` on that
checkpoint (their difference from fp), the QAT fine-tune's evals, and the
artifacts of its best checkpoint beside the direct evals of the same
postures. Each row shows the reference's value and the bound the port is
held to (the reference's less 0.015 for an mAP, less 0.01 for a
difference); the last column says whether it holds. The reference's numbers
come from ``benchmarks/data/results`` (its flagship and QAT runs and the
``qat_eval_*`` JSONs) and, for the paired post-training differences, from
``DESIGN.md`` §8 (a 16-image paired table; no record file holds them).
"""

from __future__ import annotations

import json
import os
import sys

REF_DIR = "benchmarks/data/results"
REF_FLAGSHIP = f"{REF_DIR}/flagship_512@20260820T083238Z_metrics.jsonl"
REF_QAT = f"{REF_DIR}/flagship_512_qat@20260820T112955Z_metrics.jsonl"
REF_ARTIFACTS = {"none": "qat_eval_fp_artifact.json", "w8a8": "qat_eval_w8a8_artifact.json",
                 "w8a8_fused": "qat_eval_w8a8_fused_artifact.json",
                 "w8a8_fused_chain": "qat_eval_chain_artifact.json"}
REF_DIRECT = {"w8a8_fused": "qat_eval_fused_direct.json",
              "w8a8_fused_chain": "qat_eval_chain_direct.json"}
# DESIGN.md §8, "Deployed-numerics accuracy at flagship scale": paired
# differences from bf16 on the fp flagship checkpoint.
REF_DELTA = {"w8a8_static": -0.007, "w8a8": -0.015}
# The artifact of each posture and the direct eval it is held to.
TWIN = {"none": "fold_bn", "w8a8": "w8a8_static", "w8a8_fused": "w8a8_fused",
        "w8a8_fused_chain": "w8a8_fused_chain"}


def _path(out: str, name: str) -> str:
    if os.path.isdir(out):
        return os.path.join(out, name)
    return f"{out}_{name.replace('/', '_')}"


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _map(path):
    try:
        with open(path) as f:
            return json.load(f)["mAP"]
    except (OSError, KeyError, ValueError):
        return None


def _fmt(v, signed=False):
    if v is None:
        return "missing"
    return f"{v:+.4f}" if signed else f"{v:.4f}"


def main(argv) -> int:
    out = argv[0]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    ref = lambda name: os.path.join(root, name)  # noqa: E731
    table = []  # (what, port, reference, bound, holds)

    def row(what, port, reference, lo=None, hi_abs=None, signed=False):
        if port is None:
            holds = "missing"
        elif lo is not None:
            holds = "yes" if port >= lo else "NO"
        elif hi_abs is not None:
            holds = "yes" if abs(port) <= hi_abs else "NO"
        else:
            holds = "-"
        bound = (f">= {lo:+.4f}" if signed else f">= {lo:.4f}") if lo is not None else (
            f"|d| <= {hi_abs}" if hi_abs is not None else "-")
        table.append((what, _fmt(port, signed), _fmt(reference, signed)
                      if isinstance(reference, float) else reference, bound, holds))

    card = _path(out, "card.txt")
    if os.path.exists(card):
        with open(card) as f:
            print(f"card: {f.readline().strip()}")

    ref_fp = {r["step"]: r["val_mAP"] for r in _rows(ref(REF_FLAGSHIP)) if "val_mAP" in r}
    fp_rows = _rows(_path(out, "flagship/metrics.jsonl"))
    fp_val = {r["step"]: r["val_mAP"] for r in fp_rows if "val_mAP" in r}
    row("fp flagship val_mAP @5000", fp_val.get(5000), ref_fp[5000], lo=ref_fp[5000] - 0.015)
    fp5000 = _map(_path(out, "eval_fp5000_fp.json"))
    row("cli.evaluate fp, step-5000 checkpoint", fp5000, "-")
    for q in ("w8a8_static", "w8a8"):
        m = _map(_path(out, f"eval_fp5000_{q}.json"))
        d = None if m is None or fp5000 is None else m - fp5000
        row(f"post-training {q}: mAP {_fmt(m)}, d vs fp", d, REF_DELTA[q],
            lo=REF_DELTA[q] - 0.01, signed=True)

    ref_qat = {r["step"]: r["val_mAP"] for r in _rows(ref(REF_QAT)) if "val_mAP" in r}
    qat = {r["step"]: r["val_mAP"] for r in _rows(_path(out, "qat_metrics.jsonl"))
           if "val_mAP" in r}
    for step in sorted(qat):
        row(f"QAT fake-quant eval @{step}", qat[step], ref_qat.get(step, "-"))
    with open(_path(out, "qat_best.json")) as f:
        best = json.load(f)
    ref_best = max(ref_qat.values())
    row(f"QAT fake-quant eval, best (step {best['step']})", best["value"], ref_best,
        lo=ref_best - 0.015)

    art = {q: _map(_path(out, f"eval_qat_artifact_{q}.json")) for q in TWIN}
    direct = {q: _map(_path(out, f"eval_qat_direct_{q}.json"))
              for q in ("fp", "fold_bn", "w8a8_static", "w8a8_fused", "w8a8_fused_chain")}
    for q, ref_file in REF_ARTIFACTS.items():
        r = _map(ref(f"{REF_DIR}/{ref_file}"))
        row(f"artifact {q}", art[q], r, lo=None if q == "none" else r - 0.015)
    for q in ("fp", "fold_bn", "w8a8_static", "w8a8_fused", "w8a8_fused_chain"):
        r = _map(ref(f"{REF_DIR}/{REF_DIRECT[q]}")) if q in REF_DIRECT else "-"
        row(f"direct {q} (QAT checkpoint)", direct[q], r)
    fc = (None if art["w8a8_fused"] is None or art["w8a8_fused_chain"] is None
          else art["w8a8_fused"] - art["w8a8_fused_chain"])
    row("artifact w8a8_fused - w8a8_fused_chain", fc,
        _map(ref(f"{REF_DIR}/{REF_ARTIFACTS['w8a8_fused']}"))
        - _map(ref(f"{REF_DIR}/{REF_ARTIFACTS['w8a8_fused_chain']}")), hi_abs=0.002,
        signed=True)
    for q, twin in TWIN.items():
        d = None if art[q] is None or direct[twin] is None else art[q] - direct[twin]
        row(f"artifact {q} - direct {twin}", d, "-", hi_abs=0.002, signed=True)

    w = max(len(t[0]) for t in table)
    print(f"{'':{w}}  {'port':>9}  {'reference':>9}  {'bound':>14}  holds")
    for what, port, reference, bound, holds in table:
        print(f"{what:{w}}  {port:>9}  {reference:>9}  {bound:>14}  {holds}")
    return 1 if any(t[4] in ("NO", "missing") for t in table) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
