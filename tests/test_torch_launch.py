"""The local launcher (``parallel/mesh.py::launch_local``, ``run_local_ranks``):
a CLI without ``--coordinator`` runs one rank per visible card, or
``--num_processes N`` ranks, on this host. On the CPU (gloo) at a tiny size:

* ``cli.train --device cpu --num_processes 2`` writes the
  ``metrics.jsonl`` (every value but the rate and the time stamp) and the
  checkpoint of the hand-launched ``--coordinator`` pair, and streams
  rank 0's output;
* a rank that raises ends the job at once with a non-zero exit, the other
  rank killed (long before a collective's 60 s timeout) and no rank left
  (their pids, which the launcher prints, are gone);
* SIGTERM to the launcher reaches every rank: they stop after the same
  step, and rank 0 checkpoints that step for both;
* ``--auto_restart 1`` with rank 1 stalled in step 4
  (``torch_hang_child.py``'s stall, through ``torch_dist_child.py``'s
  ``local`` mode): its watchdog exits with the restart code, the launcher
  kills rank 0 and starts both again on a fresh port with
  ``CVM_RESTART_COUNT`` 1; they resume from step 2 and finish.

``cli.benchmark`` over the launcher: ``test_torch_launch_benchmark.py``.
Each test is one launch of ranks (the pair of the first is two), each rank
on one thread.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import torch

from cvm_tpu_torch.parallel.mesh import launch_ranks
from cvm_tpu_torch.train.checkpoints import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_dist_child.py")
TINY = ["--model", "centernet", "--data", "synthetic", "--device", "cpu", "--pad_hw", "80,96",
        "--input_hw", "64,64", "--backbone", "tiny", "--neck_features", "32",
        "--head_features", "16", "--num_classes", "3", "--batch_size", "4",
        "--warmup_steps", "2", "--log_every", "1"]


def env(**extra):
    e = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    e.pop("CVM_RESTART_COUNT", None)
    return e


def rows(work):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def pids(err):
    return [int(p) for p in re.search(r"launched 2 local ranks, pids \[(\d+), (\d+)\]",
                                      err).groups()]


def gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_local_ranks_equal_the_hand_launched_pair(tmp_path):
    local, hand = str(tmp_path / "local"), str(tmp_path / "hand")
    flags = TINY + ["--steps", "3", "--checkpoint_every", "3"]
    proc = subprocess.run([sys.executable, "-m", "cvm_tpu_torch.cli.train", *flags,
                           "--workdir", local, "--num_processes", "2"],
                          capture_output=True, text=True, env=env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "mesh=(data=2, model=1)" in proc.stdout and "done at step 3" in proc.stdout
    assert all(gone(p) for p in pids(proc.stderr))
    launch_ranks(2, lambda r, port: [
        sys.executable, "-m", "cvm_tpu_torch.cli.train", *flags, "--workdir", hand,
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(r)],
        300, cwd=REPO)
    got, want = rows(local), rows(hand)
    assert [r["step"] for r in got] == [1, 2, 3]
    for g, w in zip(got, want):
        clock = ("steps_per_sec", "ts")
        assert {k: v for k, v in g.items() if k not in clock} == \
            {k: v for k, v in w.items() if k not in clock}
    a = CheckpointManager(os.path.join(local, "checkpoints")).restore_latest()
    b = CheckpointManager(os.path.join(hand, "checkpoints")).restore_latest()
    assert a["step"] == b["step"] == 3 and a["host"] == b["host"]
    for k in b["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k


def test_a_failing_rank_ends_every_rank(tmp_path):
    out = str(tmp_path / "launch.json")
    argv = TINY + ["--steps", "50", "--workdir", str(tmp_path / "w"), "--num_processes", "2"]
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, CHILD, "--device", "cpu", "--out", out,
                           "--fail_rank", "1", "--hang_step", "2", "local", "--module",
                           "cvm_tpu_torch.cli.train", "--argv", json.dumps(argv)],
                          capture_output=True, text=True, env=env(), cwd=REPO, timeout=300)
    seconds = time.monotonic() - t0
    assert proc.returncode == 0, proc.stderr
    with open(out) as f:
        assert json.load(f)["rc"] == 1
    assert "rank 1 exited 1" in proc.stderr and "rank 1 fails in step 2" in proc.stderr
    assert not os.path.exists(out + ".rank0")  # killed, not finished
    assert all(gone(p) for p in pids(proc.stderr))
    assert seconds < 45, seconds  # rank 0 did not wait out the 60 s collective timeout


def test_sigterm_to_the_launcher_checkpoints_every_rank(tmp_path):
    work = str(tmp_path / "w")
    proc = subprocess.Popen([sys.executable, "-m", "cvm_tpu_torch.cli.train", *TINY,
                             "--steps", "500", "--checkpoint_every", "1000", "--workdir", work,
                             "--num_processes", "2"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env(), cwd=REPO)
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if os.path.exists(os.path.join(work, "metrics.jsonl")) and len(rows(work)) >= 3:
                break
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    stopped = int(re.search(r"stopped at step (\d+)", out).group(1))
    assert 3 <= stopped < 500 and stopped % 1000
    assert rows(work)[-1]["step"] == stopped
    ck = CheckpointManager(os.path.join(work, "checkpoints"))
    assert ck.all_steps() == [stopped]
    assert len(ck.restore_latest()["host"]["data_ranks"]) == 2
    assert all(gone(p) for p in pids(err))


def test_auto_restart_starts_every_rank_again(tmp_path):
    out, work = str(tmp_path / "launch.json"), str(tmp_path / "w")
    argv = TINY + ["--steps", "8", "--checkpoint_every", "2", "--workdir", work,
                   "--num_processes", "2", "--auto_restart", "1"]
    proc = subprocess.run([sys.executable, CHILD, "--device", "cpu", "--out", out,
                           "--hang_rank", "1", "--hang_step", "4", "local", "--module",
                           "cvm_tpu_torch.cli.train", "--argv", json.dumps(argv)],
                          capture_output=True, text=True, env=env(CVM_STALL_THRESHOLD_S="3"),
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(out) as f:
        assert json.load(f)["rc"] == 0, proc.stderr
    assert "asked for restart 1" in proc.stderr
    assert proc.stderr.count("launched 2 local ranks") == 2
    results = []
    for r in range(2):
        with open(f"{out}.rank{r}") as f:
            results.append(json.load(f))
    assert [res["rc"] for res in results] == [0, 0]
    assert "start_step=2" in results[0]["stdout"] and "done at step 8" in results[0]["stdout"]
    assert [res["k1"] for res in results] == [0, 0]  # the CPU renders with K1's plain version
    events = []
    for r in range(2):
        with open(f"{out}.rank{r}.events") as f:
            events += [line.split() for line in f]
    names = [(e[0], e[1], e[3]) for e in events]
    assert names.count(("hang", "1", "-")) == 1
    # the stalled step stalls both ranks (rank 0 waits in its collectives):
    # either watchdog may be first
    assert {("restart", "0", "-"), ("restart", "1", "-")} & set(names)
    # the second image of both ranks, with the count the launcher gave
    assert ("start", "0", "1") in names and ("start", "1", "1") in names
    assert ("first_step", "0", "1") in names
    assert [r["step"] for r in rows(work)][-1] == 8
    assert CheckpointManager(os.path.join(work, "checkpoints")).latest_step() == 8
