"""One rank of a multi-card cell (``runners/train_records_dp.py`` starts
them through the program's local launcher, one per card):

    python -m cvbench.rank --cell <cell.json> --seed <n> --seconds <s> --trace <0|1>
        --rank <r> --world <n> --port <p> --out <dir>

It joins the NCCL group on 127.0.0.1:<port>, runs the single-card runner
that the cell's mix names (``rank_runner``), with the configuration and mix
the parent wrote to ``<cell.json>``, as its rank of the (data) mesh, and rank 0 writes what the parent
needs (metrics, counters, the check's samples, the trace's events) to
``<dir>/rank0.pt``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    from cvbench import run

    p = argparse.ArgumentParser(description=__doc__)
    for name in ("--cell", "--out"):
        p.add_argument(name, required=True)
    for name in ("--seed", "--rank", "--world", "--port", "--trace"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda", help="cuda (NCCL), or cpu (gloo) in tests")
    a = p.parse_args(argv)
    run.cache_env()
    spec = run.load_json(a.cell)
    import torch

    from cvm_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown_distributed

    cfg, mix = spec["config"], spec["mix"]
    runner = importlib.import_module(f"cvbench.runners.{mix['rank_runner']}")
    if a.device == "cpu":
        torch.set_num_threads(1)
    device = init_distributed(f"127.0.0.1:{a.port}", a.world, a.rank, a.device)
    try:
        mesh = make_mesh(1, device)
        out = runner.run(cfg, mix, a.seed, a.seconds, bool(a.trace) and a.rank == 0, device,
                         a.out, T_PROCESS, mesh=mesh)
    finally:
        shutdown_distributed()
    if a.rank == 0:
        keep = {k: out[k] for k in ("t_window", "e2e", "attempted", "failed",
                                    "memory_peak_bytes", "samples", "counters", "trace_events")}
        keep["weights"] = {k: v.cpu() for k, v in out["weights"].items()}
        for k in ("g1", "p0", "p3"):
            keep["samples"][k] = {n: v.cpu() for n, v in keep["samples"][k].items()}
        torch.save(keep, os.path.join(a.out, "rank0.pt.tmp"))
        os.replace(os.path.join(a.out, "rank0.pt.tmp"), os.path.join(a.out, "rank0.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
