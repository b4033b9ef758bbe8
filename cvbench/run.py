"""Run one cell of the benchmark once.

    python -m cvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Phases: set-up (imports, weights and data from the seed, the program's own
set-up, warm-up of every shape the cell's traffic uses), the measured window
of ``--seconds``, then the check of what the window produced against the
plain reference and the report. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics instead),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: every
number the check compared, beside its limit. Earlier lines and standard
error carry progress; the compared numbers are also the last lines of
standard error.

The cell's configuration, traffic mix, runner, checks, limits and metric
readers are all found by the names ``BENCHMARK.json`` gives. A run needs a
CUDA card (as many as the cell asks for) and exits non-zero without one,
and exits non-zero when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "cvbench" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "cvbench" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(name: str, bench: dict) -> dict:
    """The cell ``name`` with its configuration, traffic mix, limits and
    metrics, each read from its own file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return {"cell": cell, "config": load_json(ROOT / conf["file"]),
            "mix": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": layer}


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cvbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def Context(**kw) -> SimpleNamespace:
    """What a run hands its per-layer metric readers: the reduced trace
    (``trace``, None when nothing was traced), the window's counters
    (``counters``), the card's dense bf16 peak (``peak``) and name."""
    return SimpleNamespace(**kw)


def compare(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [[name, value, limit], ...])``: each number at or under
    its limit; a number without a reading fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = values.get(name)
        rows.append([name, v, limit])
        ok = ok and v is not None and v == v and v <= limit
    return ok, rows


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, tmp: str,
             overrides: Optional[dict] = None) -> dict:
    """Set-up, window and check of one cell on ``device``; returns the
    result's fields (no device check, no printing)."""
    cfg = dict(spec["config"], **(overrides or {}).get("config", {}))
    mix = dict(spec["mix"], **(overrides or {}).get("mix", {}), cell=spec["cell"]["name"])
    from cvbench import program

    cfg = program.cell_config(cfg, mix)
    runner = importlib.import_module(f"cvbench.runners.{mix['runner']}")
    check = importlib.import_module(
        f"cvbench.checks.{mix.get('check', {}).get('module', cfg['model'])}")
    out = runner.run(cfg, mix, seed, seconds, trace, device, tmp, T_PROCESS)
    values = check.compare(out["samples"], out["weights"], program.ref_cfg(cfg), device)
    for name, v in values.items():
        print(f"reading {name} = {v!r}", file=sys.stderr, flush=True)
    out["correct"], out["compared"] = compare(values, spec["limits"])
    out["correct"] = out["correct"] and out["failed"] == 0
    return out


def report(spec: dict, out: dict, trace: bool, device) -> dict:
    import torch

    from cvbench.reference.kernels import bf16_peak
    from cvbench.trace import reduce

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": int(spec["cell"]["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    res = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
           "failed": int(out["failed"])}
    if not trace:
        e2e = {"setup_s": out["setup_s"], **out["e2e"]}
        res["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in spec["end_to_end"] if m["name"] in e2e}
    else:
        tr = reduce(out["trace_events"]) if out.get("trace_events") else None
        ctx = Context(trace=tr, counters=out["counters"], peak=bf16_peak(kind), card=kind)
        metrics = {}
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        res["metrics"] = metrics
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
            res["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                                "idle_gaps": [list(x) for x in tr.idle_gaps]}
    res["device"] = dev
    res["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in out["compared"]}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    spec = cell_spec(args.workload, manifest())

    import torch

    from cvbench.guard import assert_clean

    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cvbench: the cell needs {need} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    import cvm_tpu_torch  # noqa: F401  (the program under test; absent: no result)

    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="cvbench-") as tmp:
        out = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, tmp)
    assert_clean("the run")
    res = report(spec, out, bool(args.trace), device)
    for name, row in res["compared"].items():
        print(f"compared {name} = {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
