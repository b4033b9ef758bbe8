"""``cli.benchmark`` over the local launcher (``parallel/mesh.py::launch_local``)
on the CPU: two local ranks (``--num_processes 2``) on two tiny configs
(``tests/torch_dist_child.py --tiny_benchmark``): the training leg (E, here
a tiny CenterNet) runs on both ranks, each on its rows of the global
batch, the serving leg (A) on rank 0 alone while rank 1 waits, and rank 0
prints one line each, the training line with ``processes``. One launch of
two ranks, each on one thread.
"""

import json
import subprocess
import sys

from test_torch_launch import CHILD, REPO, env


def test_benchmark_trains_over_the_ranks_and_serves_on_one(tmp_path):
    out = str(tmp_path / "launch.json")
    argv = ["--configs", "A,E", "--iters", "2", "--device", "cpu", "--num_processes", "2"]
    proc = subprocess.run([sys.executable, CHILD, "--device", "cpu", "--out", out,
                           "--tiny_benchmark", "local", "--module", "cvm_tpu_torch.cli.benchmark",
                           "--argv", json.dumps(argv)],
                          capture_output=True, text=True, env=env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    results = []
    for r in range(2):
        with open(f"{out}.rank{r}") as f:
            results.append(json.load(f))
    assert [res["rc"] for res in results] == [0, 0] and results[1]["stdout"] == ""
    a, e = [json.loads(line) for line in results[0]["stdout"].splitlines()]
    assert (a["config"], a["mode"], e["config"], e["mode"]) == ("A", "infer", "E", "train")
    assert "processes" not in a and a["images_per_sec"] > 0
    assert e["processes"] == 2 and e["batch_size"] == 2 and e["steps_per_sec"] > 0
