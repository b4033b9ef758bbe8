"""The asynchronous ``CheckpointManager`` (``train/checkpoints.py``), on the CPU:

* ``save`` returns while the write is held (``torch.save`` gated on an
  event), and the file appears only once it is released and waited for;
* the snapshot is taken at ``save``: in-place changes to the tensors and
  host objects of the state after ``save`` returns do not reach the file;
* a write that fails raises at ``wait`` (never swallowed), leaves no
  temporary file and the previous checkpoint whole, and the next save
  works;
* keep-N drops the oldest step only once the new file is whole;
* a manager opened on the directory while a write is held (as
  ``cli.evaluate``, ``cli.infer``, ``cli.video`` and ``cli.export`` open
  one through their ``Trainer``) removes nothing, and the write lands;
* a ``cli.train`` process SIGKILLed while its step-4 write is held leaves
  step 2 whole (its temporary file stays, ignored), and the run resumes
  from it, logging what the killed run logged for the steps after 2.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.train import checkpoints
from cvm_tpu_torch.train.checkpoints import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "centernet", "--data", "synthetic", "--device", "cpu", "--pad_hw", "80,96",
        "--input_hw", "64,64", "--backbone", "tiny", "--neck_features", "32",
        "--head_features", "16", "--num_classes", "3", "--batch_size", "2",
        "--warmup_steps", "2", "--log_every", "1", "--checkpoint_every", "2"]


@pytest.fixture
def gate(monkeypatch):
    """``torch.save`` held until ``gate.set()``; ``gate.entered`` is set once
    the writer is in it."""
    release, entered, real = threading.Event(), threading.Event(), torch.save

    def held(obj, path):
        entered.set()
        assert release.wait(60), "the test never released the write"
        real(obj, path)

    monkeypatch.setattr(checkpoints.torch, "save", held)
    release.entered = entered
    yield release
    release.set()


def state(v: float):
    return {"step": 1, "model": {"w": torch.full((3, 4), v)},
            "optimizer": {"mu": [torch.full((2,), v), torch.zeros(1)], "count": 5},
            "host": {"data": {"draws": [1, 2, 3]}}}


def test_save_returns_while_the_write_is_held(tmp_path, gate):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state(1.0))
    assert gate.entered.wait(30)
    assert ck.latest_step() is None  # issued, not written
    gate.set()
    ck.wait()
    assert ck.all_steps() == [1]
    assert torch.equal(ck.restore_latest()["model"]["w"], torch.full((3, 4), 1.0))


def test_changes_after_save_do_not_reach_the_file(tmp_path, gate):
    ck = CheckpointManager(str(tmp_path))
    st = state(1.0)
    ck.save(1, st)
    assert gate.entered.wait(30)
    st["model"]["w"].add_(1.0)
    st["optimizer"]["mu"][0].mul_(3.0)
    st["host"]["data"]["draws"].append(4)
    gate.set()
    ck.close()
    got = ck.restore_latest()
    assert torch.equal(got["model"]["w"], torch.full((3, 4), 1.0))
    assert torch.equal(got["optimizer"]["mu"][0], torch.full((2,), 1.0))
    assert got["host"]["data"]["draws"] == [1, 2, 3] and got["optimizer"]["count"] == 5


def test_a_write_error_raises_at_wait(tmp_path, monkeypatch):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state(1.0))
    ck.wait()

    def fail(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints.torch, "save", fail)
    ck.save(2, state(2.0))
    with pytest.raises(RuntimeError, match="checkpoint write .* failed: disk full"):
        ck.wait()
    ck.wait()  # raised once
    assert sorted(os.listdir(tmp_path)) == ["1.pt"]
    monkeypatch.undo()
    ck.save(3, state(3.0))
    ck.wait()
    assert ck.all_steps() == [1, 3]


def test_keep_n_prunes_only_after_the_new_file_is_whole(tmp_path, gate):
    ck = CheckpointManager(str(tmp_path), keep=2)
    gate.set()
    ck.save(1, state(1.0))
    ck.save(2, state(2.0))  # waits for step 1's write first
    ck.wait()
    gate.clear()
    gate.entered.clear()
    ck.save(3, state(3.0))
    assert gate.entered.wait(30)
    assert ck.all_steps() == [1, 2]
    gate.set()
    ck.wait()
    assert ck.all_steps() == [2, 3]


def test_a_manager_opened_during_a_write_lets_it_land(tmp_path, monkeypatch):
    release, entered, real = threading.Event(), threading.Event(), torch.save

    def held(obj, path):  # the temporary file open and partly written, then held
        with open(path, "wb") as f:
            f.write(b"")
            entered.set()
            assert release.wait(60), "the test never released the write"
            real(obj, f)

    monkeypatch.setattr(checkpoints.torch, "save", held)
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state(1.0))
    assert entered.wait(30)
    (tmp_path / "7.pt.99.tmp").write_bytes(b"a write of another process")
    before = sorted(os.listdir(tmp_path))
    reader = CheckpointManager(str(tmp_path))  # a writer, as a trainer's CLI opens it
    assert reader.latest_step() is None
    assert sorted(os.listdir(tmp_path)) == before  # nothing removed
    release.set()
    ck.wait()
    assert reader.all_steps() == [1]
    assert torch.equal(reader.restore_latest()["model"]["w"], torch.full((3, 4), 1.0))


KILLED = """
import sys, threading, torch
real = torch.save

def held(obj, path):
    if "/4.pt." in path:  # step 4's write: part of it, then held for good
        with open(path, "wb") as f:
            f.write(b"partial")
        print("HELD", flush=True)
        threading.Event().wait()
    real(obj, path)

torch.save = held
from cvm_tpu_torch.cli.train import main
main(sys.argv[1:])
"""


def test_a_process_killed_in_its_write_resumes_from_the_previous_step(tmp_path, capsys):
    work = str(tmp_path / "w")
    argv = TINY + ["--workdir", work, "--steps", "6"]
    proc = subprocess.Popen([sys.executable, "-c", KILLED, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        for line in proc.stdout:
            if line.startswith("HELD"):
                break
        proc.kill()
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    ckdir = os.path.join(work, "checkpoints")
    left = [n for n in os.listdir(ckdir) if n.startswith("4.pt.") and n.endswith(".tmp")]
    assert len(left) == 1
    assert CheckpointManager(ckdir, writer=False).all_steps() == [2]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        killed = {r["step"]: r for r in map(json.loads, f)}
    capsys.readouterr()
    # one thread here (the root conftest's) as in the killed process
    # (OMP_NUM_THREADS=1): only then does the resumed run repeat its numbers
    assert train_main(argv) == 0
    assert "start_step=2" in capsys.readouterr().out
    assert sorted(os.listdir(ckdir)) == sorted(["2.pt", "4.pt", "6.pt", "params.json", *left])
    with open(os.path.join(work, "metrics.jsonl")) as f:
        resumed = [json.loads(line) for line in f][len(killed):]
    assert [r["step"] for r in resumed] == [3, 4, 5, 6]
    clock = ("steps_per_sec", "ts")
    for r in resumed:
        if r["step"] in killed:
            assert {k: v for k, v in r.items() if k not in clock} == \
                {k: v for k, v in killed[r["step"]].items() if k not in clock}
