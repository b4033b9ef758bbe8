#!/usr/bin/env python3
"""Whether ``os.execv`` with a kernel in flight leaves the card usable for
the new process image, and how long that takes.

``python3 scripts/watchdog_exec_probe.py [--sleeps 20 60]`` (on the card's
machine, from the root of a checkout) runs ``tests/torch_hang_child.py`` on
config B (batch 8, 768^2 synthetic scenes, threshold 4 s): once without a
stall, for the time from a cold process start to its first completed step;
then once per ``--sleeps`` value, where step 4 sleeps on the device that
many seconds and the watchdog re-execs the process while the sleep runs.
It prints, per run, the detection latency (the exec after the stalled step
was enqueued) and the time from the exec to the new image's first
completed step, with the card's name and power limit, one JSON line each.
If the new image waits for the old image's kernel, that time grows with
the sleep; if the exec tears the old context down at once, it does not.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "torch_hang_child.py")


def tagged(out: str, tag: str):
    return [line.split()[1:] for line in out.splitlines() if line.startswith(tag)]


def run(workdir: str, mode: str, steps: int, sleep_s: float) -> dict:
    env = dict(os.environ, CVM_STALL_THRESHOLD_S="4", CVM_HANG_S=str(sleep_s))
    env.pop("CVM_RESTART_COUNT", None)
    t0 = time.time()
    proc = subprocess.run([sys.executable, CHILD, workdir, str(steps), "cuda", "B", mode],
                          capture_output=True, text=True, env=env, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"child exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr[-3000:]}")
    out = proc.stdout
    firsts = [float(f[0]) for f in tagged(out, "FIRST")]
    res = {"mode": mode, "first_step_after_start_s": round(firsts[0] - t0, 3)}
    if mode == "hang":
        exec_at = float(tagged(out, "RESUMED")[1][1])
        res.update(device_sleep_s=sleep_s,
                   detect_s=round(exec_at - float(tagged(out, "HANGING")[0][0]), 3),
                   first_step_after_exec_s=round(firsts[1] - exec_at, 3),
                   restarted="AUTO-RESTART 1/1" in proc.stderr,
                   done=tagged(out, "DONE")[-1])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sleeps", type=float, nargs="+", default=[20.0, 60.0])
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as wd:
        rows = [run(os.path.join(wd, "cold"), "pause", 6, 0.0)]
        for i, s in enumerate(args.sleeps):
            rows.append(run(os.path.join(wd, f"hang{i}"), "hang", 8, s))
    for r in rows:
        print(json.dumps(dict(r, card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
