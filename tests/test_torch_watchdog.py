"""The port's stall watchdog and ``--auto_restart`` (``train/loop.py``)
against the reference's behaviour (``tests/test_fault_injection.py::
test_device_hang_auto_restart``, ``tests/test_preempt.py::
test_sigstop_pause_does_not_trigger_auto_restart``), on the CPU with a
short threshold: a step that never returns is reported as the device's and
re-execs the command once, which resumes from the newest checkpoint and
finishes; a process stopped and continued for longer than the threshold is
not restarted; a starved input pipeline is reported as the host's and is
not restarted, also in the step after the batch arrives; the restart
budget runs out. The child is the port's own
(``tests/torch_hang_child.py``); the card twin is in
``tests/test_torch_kernels_cuda.py``. Exact: these are control-flow checks.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_hang_child.py")


def child_env(threshold: str) -> dict:
    env = dict(os.environ, CVM_STALL_THRESHOLD_S=threshold)
    env.pop("CVM_RESTART_COUNT", None)
    return env


def parse(out: str, tag: str):
    return [line.split()[1:] for line in out.splitlines() if line.startswith(tag)]


def test_device_stall_re_execs_and_resumes(tmp_path):
    proc = subprocess.run([sys.executable, CHILD, str(tmp_path / "ck"), "8", "cpu", "tiny",
                           "hang"], capture_output=True, text=True, env=child_env("3"),
                          cwd=REPO, timeout=240)
    out, err = proc.stdout, proc.stderr
    assert proc.returncode == 0, out + err
    assert len(parse(out, "HANGING")) == 1, out
    assert "looks stalled" in err and "AUTO-RESTART 1/1" in err, err
    # one process, two images: exec keeps the pid and the pipes
    resumed = parse(out, "RESUMED")
    assert [r[0] for r in resumed] == ["0", "2"], resumed
    assert float(resumed[1][1]) > float(parse(out, "HANGING")[0][0])
    # the resumed image checkpointed past its resume point: the budget is back
    assert parse(out, "DONE") == [["8", "0", "-"]], out


def test_a_stopped_process_is_not_restarted(tmp_path):
    proc = subprocess.Popen([sys.executable, CHILD, str(tmp_path / "ck"), "50", "cpu", "tiny",
                             "pause"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=child_env("3"), cwd=REPO)
    lines = []
    first = threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("FIRST"):
                first.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    try:
        assert first.wait(120), "".join(lines)
        proc.send_signal(signal.SIGSTOP)
        time.sleep(7.0)  # more than twice the threshold
        proc.send_signal(signal.SIGCONT)
        assert proc.wait(timeout=240) == 0, "".join(lines)
        t.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out = "".join(lines)
    assert "AUTO-RESTART" not in out and "looks stalled" not in out, out
    assert parse(out, "DONE")[0][0] == "50" and len(parse(out, "RESUMED")) == 1, out


def _tiny_trainer(tmp_path, restart_argv, max_restarts=1):
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.train.loop import Trainer

    cfg = CenternetParams(input_hw=(64, 64), num_classes=3, max_objects=8, backbone="tiny",
                          neck_features=32, head_features=16, batch_size=2, warmup_steps=2)
    tr = Trainer(cfg, "cpu", checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=100,
                 log_every=100, restart_argv=restart_argv, max_restarts=max_restarts)
    tr.init_state()
    return tr


def test_a_starved_input_pipeline_is_the_hosts(tmp_path, monkeypatch, capfd):
    from cvm_tpu_torch.data.synthetic import SyntheticIterator

    monkeypatch.setenv("CVM_STALL_THRESHOLD_S", "2")
    tr = _tiny_trainer(tmp_path, ["/nonexistent/python"])
    execs = []
    monkeypatch.setattr(os, "execv", lambda *a: execs.append(a))
    src = SyntheticIterator(0, 2, (96, 96), num_classes=3)

    def slow():
        for i in range(6):
            if i in (3, 4):
                time.sleep(5.0)  # the input starves, twice
            yield next(src)

    real_step, calls = tr.train_step, [0]

    def step(*a):
        # The steps after the waits (batches are prefetched two ahead, so
        # steps 2 and 3) take 1.5 s, within the 2 s threshold: the watcher
        # wakes during them and must not count the input's 5 s against the
        # device.
        calls[0] += 1
        if calls[0] in (2, 3):
            time.sleep(1.5)
        return real_step(*a)

    tr.train_step = step
    m = tr.fit(slow(), 6)
    assert tr.state.step == 6 and np.isfinite(m["loss"])
    err = capfd.readouterr().err
    assert "HOST input pipeline is starved" in err, err
    assert not execs and "AUTO-RESTART" not in err


def test_restart_budget_and_exec(tmp_path, monkeypatch, capfd):
    tr = _tiny_trainer(tmp_path, ["/bin/true", "x"], max_restarts=2)
    execs = []
    monkeypatch.setattr(os, "execv", lambda *a: execs.append(a))
    monkeypatch.delenv("CVM_RESTART_COUNT", raising=False)
    tr._maybe_auto_restart(7.0)
    assert execs == [("/bin/true", ["/bin/true", "x"])]
    assert os.environ["CVM_RESTART_COUNT"] == "1"
    monkeypatch.setenv("CVM_RESTART_COUNT", "2")
    tr._maybe_auto_restart(7.0)
    assert len(execs) == 1
    err = capfd.readouterr().err
    assert "AUTO-RESTART 1/2" in err and "giving up on auto-recovery" in err
    # no checkpoint directory: warn only
    tr.ckpt = None
    monkeypatch.setenv("CVM_RESTART_COUNT", "0")
    tr._maybe_auto_restart(7.0)
    assert len(execs) == 1


def test_cli_train_builds_the_restart_command(tmp_path, monkeypatch):
    from cvm_tpu_torch.cli import train as cli
    from cvm_tpu_torch.train import loop

    seen = {}
    real = loop.Trainer.__init__

    def spy(self, *a, **k):
        seen.update(restart_argv=k.get("restart_argv"), max_restarts=k.get("max_restarts"))
        real(self, *a, **k)

    monkeypatch.setattr(loop.Trainer, "__init__", spy)
    argv = ["--model", "centernet", "--device", "cpu", "--workdir", str(tmp_path / "w"),
            "--steps", "1", "--pad_hw", "96,96", "--input_hw", "64,64", "--backbone", "tiny",
            "--neck_features", "32", "--head_features", "16", "--num_classes", "3",
            "--batch_size", "2", "--warmup_steps", "1", "--auto_restart", "2"]
    assert cli.main(argv) == 0
    assert seen == {"restart_argv": [sys.executable, "-m", "cvm_tpu_torch.cli.train"] + argv,
                    "max_restarts": 2}
