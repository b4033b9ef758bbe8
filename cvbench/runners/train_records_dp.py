"""Whole-host training: one NCCL rank per card, each running
``train_records`` as its rank of a data-parallel mesh (global BatchNorm, the
gradients all-reduced, each rank reading its share of the records), all
started by the program's local launcher (``run_local_ranks``, as ``cli.train``
starts them on a multi-card host). This process waits for every rank, then
takes rank 0's result: its window, its trace, and the samples of the first
steps, which the check compares with the reference at the global batch.
"""

from __future__ import annotations

import json
import os
import sys

import torch


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, tmp: str,
        t_process: float) -> dict:
    from cvm_tpu_torch.parallel.mesh import run_local_ranks

    n = int(mix["ranks"])
    cell = os.path.join(tmp, "cell.json")
    with open(cell, "w") as f:
        json.dump({"config": cfg, "mix": mix}, f)

    def command(rank: int, port: int):
        return [sys.executable, "-m", "cvbench.rank", "--cell", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(trace)),
                "--rank", str(rank), "--world", str(n), "--port", str(port), "--out", tmp,
                "--device", device.type]

    rc, _, problems = run_local_ranks(n, command, timeout_s=float(mix["ranks_timeout_s"]),
                                      cwd=os.getcwd())
    if rc:
        raise RuntimeError(f"the ranks exited {rc}:\n" + "\n".join(problems))
    out = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    # set-up from this process's start to rank 0's first timed step (one
    # monotonic clock for every process of the host)
    out["setup_s"] = out["t_window"] - t_process
    out["weights"] = {k: v.to(device) for k, v in out["weights"].items()}
    return out
