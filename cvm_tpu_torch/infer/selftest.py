"""Artifact integrity self-test: a golden fingerprint recorded at export.

Mirrors ``cvm_tpu/infer/selftest.py`` (``SELFTEST_SEED``, ``synth_inputs``,
``fingerprint``, ``compare``, ``run_selftest``). An artifact is a program
and the weights it was traced against; a folded program served with
unfolded weights, a ``weights.npz`` from another run or a truncated copy
all still run and serve garbage. So ``cli.export`` runs the artifact it
just wrote on deterministic inputs made from ``artifact.json`` alone and
records per-output statistics; ``ServingModel.selftest()`` and
``cli.serve --selftest`` run the same inputs again and compare. Shapes and
finiteness compare exactly, means and stds within a tolerance: a
weights/program mismatch moves them by orders of magnitude, not percent.

One difference from the reference, on purpose: an artifact without a
recorded fingerprint fails its selftest. The reference pins the
fingerprint at the first deployment of an artifact it could not run at
export, so that run is trusted unverified; here export always runs the
artifact (a fused one exported on the CPU runs K2's plain version, which
equals the kernel exactly), so there is nothing to defer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

SELFTEST_SEED = 20260818


def synth_inputs(meta: Dict[str, Any], seed: int = SELFTEST_SEED) -> Tuple[np.ndarray, ...]:
    """Deterministic inputs in the artifact's call signature, made from
    its meta alone (so export and serving make the same bytes): planar
    YUV420 ``(y, u, v, image_hw)`` or RGB ``(image, image_hw)``, batch
    ``meta["batch_size"]`` on the ``pad_hw`` canvas; a dmds artifact's
    second frame (after the first frame's planes, or after ``image_hw``),
    a ``with_3d`` artifact's intrinsics last, drawn in the reference's
    order."""
    B = int(meta.get("batch_size", 1))
    h, w = (int(v) for v in meta.get("pad_hw", (64, 64)))
    two_frame = meta.get("model") == "dmds"
    rng = np.random.default_rng(seed)
    hw = np.tile(np.asarray([[h, w]], np.int32), (B, 1))
    if meta.get("input_format", "rgb") == "yuv420":
        def planes():
            return (rng.integers(0, 256, (B, h, w), dtype=np.uint8),
                    rng.integers(0, 256, (B, h // 2, w // 2), dtype=np.uint8),
                    rng.integers(0, 256, (B, h // 2, w // 2), dtype=np.uint8))

        args = planes() + (planes() if two_frame else ()) + (hw,)
    else:
        args = (rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8), hw)
        if two_frame:
            args += (rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8),)
    if (meta.get("params_cfg") or {}).get("with_3d", False):
        args += (np.tile(np.asarray([[200.0, 200.0, w / 2.0, h / 2.0]], np.float32), (B, 1)),)
    return args


def fingerprint(outputs: Dict[str, Any]) -> Dict[str, Any]:
    """Per-output shape and summary statistics, JSON-safe."""
    fp: Dict[str, Any] = {}
    for k in sorted(outputs):
        v = outputs[k]
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        d = a.astype(np.float64)
        fp[k] = {"shape": list(a.shape), "mean": float(d.mean()), "std": float(d.std()),
                 "finite": bool(np.isfinite(d).all())}
    return fp


def compare(expected: Dict[str, Any], got: Dict[str, Any], rtol: float = 0.05,
            atol: float = 1e-3) -> List[str]:
    """Mismatch descriptions (empty = pass): shapes and finiteness exact,
    mean and std within ``rtol * max(|mean|, std, 1e-6) + atol``."""
    problems: List[str] = []
    if sorted(expected) != sorted(got):
        return [f"output keys differ: expected {sorted(expected)}, got {sorted(got)}"]
    for k, e in expected.items():
        g = got[k]
        if list(e["shape"]) != list(g["shape"]):
            problems.append(f"{k}: shape {g['shape']} != {e['shape']}")
            continue
        if e["finite"] and not g["finite"]:
            problems.append(f"{k}: non-finite values appeared")
            continue
        scale = max(abs(e["mean"]), e["std"], 1e-6)
        for stat in ("mean", "std"):
            if abs(g[stat] - e[stat]) > rtol * scale + atol:
                problems.append(f"{k}: {stat} {g[stat]:.6g} vs expected {e[stat]:.6g} "
                                f"(tol {rtol * scale + atol:.2g})")
    return problems


def run_selftest(model, rtol: float = 0.05, atol: float = 1e-3) -> List[str]:
    """Verify a ``ServingModel`` against the fingerprint its export
    recorded: mismatch strings, [] = verified. Raises when the artifact
    carries no fingerprint."""
    st = model.meta.get("selftest") or {}
    if "outputs" not in st:
        raise ValueError("artifact has no selftest fingerprint: re-export it with cli.export")
    out = model(*synth_inputs(model.meta, seed=int(st.get("seed", SELFTEST_SEED))))
    return compare(st["outputs"], fingerprint(out), rtol=rtol, atol=atol)
