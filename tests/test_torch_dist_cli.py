"""``cli.train``'s multi-process flags and ``entry.dryrun_multichip`` on the
CPU (gloo), at a tiny size.

* Two ``cli.train`` processes with ``--coordinator / --num_processes 2 /
  --process_id``, 3 steps: only rank 0 prints, writes ``metrics.jsonl``
  (one row per step, not two) and the checkpoint with each rank's data
  stream; both resume from it to step 5; ``cli.evaluate`` scores the
  checkpoint in one process. Then on a model axis of 2 with
  ``--tensor_parallel true`` and evals with ``--keep_best``: both ranks
  score, rank 0 keeps whole-tensor checkpoints.
* The reference's argument checks: ``--coordinator`` without the other two
  flags, ``--tensor_parallel true`` without ``--model_parallel >= 2``, a
  model axis that does not divide the processes, a global batch that does
  not divide over the data ranks, and ``--auto_restart`` under a group;
  ``--dcn_slices`` raises with the reason it is not ported.
* ``dryrun_multichip(4, "cpu")``: a (data 2, model 2) step with tensor
  parallelism, the EMA and gradient accumulation, then the serving leg
  sharded over the same mesh, the stage-5 convs served split.
"""

import json
import os
import sys

import pytest

from cvm_tpu_torch.cli.evaluate import main as eval_main
from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.entry import dryrun_multichip
from cvm_tpu_torch.parallel.mesh import launch_ranks
from cvm_tpu_torch.train.checkpoints import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "centernet", "--data", "synthetic", "--device", "cpu", "--pad_hw", "80,96",
        "--input_hw", "64,64", "--backbone", "tiny", "--neck_features", "32",
        "--head_features", "16", "--num_classes", "3", "--batch_size", "4",
        "--warmup_steps", "2", "--log_every", "1"]


def _cli_ranks(work, steps):
    return launch_ranks(2, lambda r, port: [
        sys.executable, "-m", "cvm_tpu_torch.cli.train", *TINY, "--workdir", work, "--steps",
        str(steps), "--checkpoint_every", "3", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(r)], 300, cwd=REPO)


def test_two_cli_processes_train_and_rank0_writes(tmp_path, capsys):
    work = str(tmp_path / "w")
    outs = _cli_ranks(work, 3)
    assert "mesh=(data=2, model=1)" in outs[0] and "done at step 3" in outs[0]
    assert outs[1] == ""
    rows = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]
    ck = CheckpointManager(os.path.join(work, "checkpoints"))
    assert ck.all_steps() == [3]
    saved = ck.restore_latest()
    assert len(saved["host"]["data_ranks"]) == 2
    assert saved["host"]["data_ranks"][0] != saved["host"]["data_ranks"][1]
    # resumed: rank 0 reads step 3 and broadcasts it; each rank continues
    # its own data stream
    outs = _cli_ranks(work, 5)
    assert "start_step=3" in outs[0] and "done at step 5" in outs[0] and outs[1] == ""
    rows = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    capsys.readouterr()
    assert eval_main(["--model", "centernet", "--workdir", work, "--device", "cpu",
                      "--pad_hw", "80,96", "--batches", "1"]) == 0
    out = capsys.readouterr()
    assert "WARNING: no checkpoint restored" not in out.err and "mAP" in out.out


def test_two_cli_processes_with_tensor_parallel_evals(tmp_path):
    """Two ranks on one model axis: every eval runs on both ranks with the
    stage-5 convs kept split (``evaluate_model(mesh=)``), rank 0 alone logs
    and keeps the best checkpoint, and both stop together."""
    work = str(tmp_path / "w")
    outs = launch_ranks(2, lambda r, port: [
        sys.executable, "-m", "cvm_tpu_torch.cli.train", *TINY, "--workdir", work, "--steps",
        "4", "--checkpoint_every", "4", "--eval_every", "2", "--eval_batches", "1",
        "--keep_best", "mAP", "--model_parallel", "2", "--tensor_parallel", "true",
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(r)],
        300, cwd=REPO)
    assert outs[0].count("eval@") == 2 and "mesh=(data=1, model=2)" in outs[0]
    assert outs[1] == ""
    rows = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [r["step"] for r in rows if "val_mAP" in r] == [2, 4]
    best = CheckpointManager(os.path.join(work, "best")).restore_latest()
    last = CheckpointManager(os.path.join(work, "checkpoints")).restore_latest()
    assert last["step"] == 4 and best["step"] in (2, 4)
    name = "backbone.s5b0.c1.conv.weight"
    assert best["model"][name].shape == last["model"][name].shape == (256, 256, 3, 3)


@pytest.mark.parametrize("extra, message", [
    (["--coordinator", "127.0.0.1:1"], "--coordinator requires --num_processes and "
                                       "--process_id"),
    (["--tensor_parallel", "true"], "--tensor_parallel true requires --model_parallel >= 2"),
    (["--model_parallel", "2"], "1 processes not divisible by --model_parallel 2"),
    (["--coordinator", "127.0.0.1:1", "--num_processes", "3", "--process_id", "0"],
     "batch_size 4 not divisible by 3 data-parallel processes"),
    (["--coordinator", "127.0.0.1:1", "--num_processes", "2", "--process_id", "0",
      "--auto_restart", "1"], "--auto_restart re-execs one process, which cannot rejoin"),
])
def test_cli_refuses_what_the_reference_refuses(extra, message, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        train_main(TINY + ["--workdir", str(tmp_path), "--steps", "1"] + extra)
    assert e.value.code == 2 and message in capsys.readouterr().err


def test_cli_dcn_slices_is_not_ported(tmp_path):
    with pytest.raises(SystemExit, match="--dcn_slices is not ported: .* NCCL picks its own"):
        train_main(TINY + ["--workdir", str(tmp_path), "--dcn_slices", "2"])


def test_dryrun_multichip_four_ranks(capsys):
    dryrun_multichip(4, "cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[dryrun_multichip] mesh=(data=2, model=2) over 4 gloo processes "
                             "step ok, loss=")
    assert "tp s5b0.c1 kernel (128, 256, 3, 3)" in out[0] and "ema+accum on" in out[0]
    assert out[1].startswith("[dryrun_multichip] sharded serving ok: decode batch B=4 on "
                             "mesh=(data=2, model=2), 2 rows per data rank")
    assert out[1].endswith("tp_serving=on")
