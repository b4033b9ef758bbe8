"""Profiling helpers (``utils/prof.py``) and ``cli.train --profile_steps /
--debug_nans`` on the CPU, after the reference's ``tests/test_prof.py``.

``StepTimer`` sections and their report; ``trace`` writes a Chrome trace
that names the ops run inside it; ``start_server`` raises (PyTorch has no
remote-capture server); ``--profile_steps 2`` traces two steps after the
warm-up and still trains every step; ``--debug_nans`` lets a finite run
through unchanged (bit for bit) and raises ``FloatingPointError`` at the
first step a huge learning rate makes non-finite, naming the step and the
tensors. Exact: control flow and file contents.
"""

import json
import os

import pytest
import torch

from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.utils.prof import StepTimer, start_server, trace

BASE = ["--model", "centernet", "--device", "cpu", "--pad_hw", "96,96", "--input_hw", "64,64",
        "--backbone", "tiny", "--neck_features", "32", "--head_features", "16",
        "--num_classes", "3", "--batch_size", "2", "--log_every", "1"]


def test_step_timer_sections():
    t = StepTimer()
    x = torch.ones(64, 64)
    with t.section("mul"):
        y = x * 2
    for _ in range(2):
        with t.section("sum", block_on={"y": [y]}):
            s = y.sum()
    assert float(s) == 8192.0
    assert set(t.summary()) == {"mul", "sum"} and t.counts == {"mul": 1, "sum": 2}
    assert all(v >= 0 for v in t.summary().values()) and "mul=" in t.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_start_server_has_no_counterpart():
    with pytest.raises(NotImplementedError, match="no remote capture server"):
        start_server(9999)


def test_cli_train_profile_steps(tmp_path):
    wd = tmp_path / "run"
    assert train_main(BASE + ["--workdir", str(wd), "--steps", "6", "--warmup_steps", "1",
                              "--profile_steps", "2", "--checkpoint_every", "6"]) == 0
    events = json.load(open(wd / "trace" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "aten::convolution" for e in events)
    steps = [json.loads(line)["step"] for line in open(wd / "metrics.jsonl")]
    assert steps == [1, 2, 3, 4, 5, 6]


def test_debug_nans_passes_a_finite_run_and_names_a_non_finite_step(tmp_path):
    args = BASE + ["--steps", "3", "--warmup_steps", "1", "--checkpoint_every", "10"]
    assert train_main(args + ["--workdir", str(tmp_path / "a")]) == 0
    assert train_main(args + ["--workdir", str(tmp_path / "b"), "--debug_nans"]) == 0
    loss = [[json.loads(line)["loss"] for line in open(tmp_path / w / "metrics.jsonl")]
            for w in ("a", "b")]
    assert loss[0] == loss[1]
    # constant schedule, one warm-up step at lr 0: the second update moves
    # every weight by ~1e30, and the third step's forward overflows
    with pytest.raises(FloatingPointError, match=r"step 3: non-finite model outputs: \['heatmap'"):
        train_main(BASE + ["--workdir", str(tmp_path / "c"), "--steps", "6", "--debug_nans",
                           "--warmup_steps", "1", "--lr_schedule", "constant",
                           "--learning_rate", "1e30", "--checkpoint_every", "10"])
    assert not os.path.exists(tmp_path / "c" / "checkpoints" / "3")
