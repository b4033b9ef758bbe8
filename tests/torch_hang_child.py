"""Child process for the port's stall watchdog (``cvm_tpu_torch/train/loop.py``).

``python tests/torch_hang_child.py CKDIR TOTAL_STEPS DEVICE CONFIG MODE``
trains CenterNet on synthetic scenes for TOTAL_STEPS (the total: a resumed
process trains the rest) with a checkpoint every 2 steps, the watchdog's
re-exec armed (``restart_argv`` is this command, at most 1 restart), and:

* MODE ``hang``: on the first process image (``CVM_RESTART_COUNT`` unset)
  step 4 stalls: on a card the device sleeps (``torch.cuda._sleep``) for
  ``CVM_HANG_S`` seconds (default 30) inside the step, while the host goes
  on enqueueing until ``Trainer.MAX_INFLIGHT`` steps are in flight; on the
  CPU the step blocks the host for an hour (the reference's
  ``tests/hang_child.py``). The watchdog must see the device's stall and
  re-exec; the new image resumes from the newest checkpoint and finishes.
* MODE ``pause``: no stall; the parent stops and continues the process.

CONFIG ``tiny`` (64x64, ``tiny`` backbone, batch 2) or ``B`` (config B:
512x512, ``small``, 80 classes, batch 8, 768x768 scenes). It prints
``HANGING <t>`` when it arms the stall, ``RESUMED <step> <exec_t>`` at
start (``exec_t``: when the previous image re-exec'd, or -1), ``FIRST
<t>`` when the first step of this image has completed on the device,
``DONE <step> <k1 launches> <CVM_RESTART_COUNT or ->`` at the end (times
from ``time.time()``; the count is cleared by a checkpoint past the resume
point, so that the restart budget is per stall).
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cvm_tpu_torch.data.synthetic import SyntheticIterator  # noqa: E402
from cvm_tpu_torch.models.centernet.params import CenternetParams  # noqa: E402
from cvm_tpu_torch.ops.cuda import gaussian_splat  # noqa: E402
from cvm_tpu_torch.train.loop import Trainer  # noqa: E402

CONFIGS = {
    "tiny": (dict(input_hw=(64, 64), num_classes=3, max_objects=8, backbone="tiny",
                  neck_features=32, head_features=16, batch_size=2), (96, 96)),
    "B": (dict(batch_size=8), (768, 768)),
}


def stall(on_card: bool) -> None:
    """Stall the step that calls this: print ``HANGING <t>``, then on a card
    sleep on the device for ``CVM_HANG_S`` seconds (default 30; the host
    goes on enqueueing), on the CPU block the host for an hour."""
    print(f"HANGING {time.time()!r}", flush=True)
    if on_card:
        # ~1.98e9 cycles a second at the H100's boost clock
        torch.cuda._sleep(int(float(os.environ.get("CVM_HANG_S", "30")) * 2e9))
    else:
        time.sleep(3600)


def main(ckdir: str, total_steps: int, device: str, config: str, mode: str) -> int:
    torch.set_num_threads(1)
    fields, pad_hw = CONFIGS[config]
    cfg = CenternetParams(**fields, warmup_steps=2, total_steps=100)
    trainer = Trainer(cfg, device, checkpoint_dir=ckdir, checkpoint_every=2, log_every=5,
                      restart_argv=[sys.executable, os.path.abspath(__file__), ckdir,
                                    str(total_steps), device, config, mode],
                      max_restarts=1)
    restart = trainer._maybe_auto_restart

    def stamped_restart(quiet_s):
        os.environ["CVM_EXEC_AT"] = repr(time.time())
        restart(quiet_s)

    trainer._maybe_auto_restart = stamped_restart
    first_image = int(os.environ.get("CVM_RESTART_COUNT", "0")) == 0
    on_card = trainer.device.type == "cuda"
    real_step = trainer.train_step
    calls = [0]

    def step(state, raw, gen):
        calls[0] += 1
        if mode == "hang" and first_image and calls[0] == 4:
            stall(on_card)
        out = real_step(state, raw, gen)
        if calls[0] == 1:
            float(out[1]["loss"])  # waits for the device
            print(f"FIRST {time.time()!r}", flush=True)
        return out

    trainer.train_step = step
    it = SyntheticIterator(0, cfg.batch_size, pad_hw, num_classes=min(cfg.num_classes, 10))
    trainer.init_state()
    if trainer.data_state is not None:
        it.load_state_dict(trainer.data_state)
    start = trainer.state.step
    print(f"RESUMED {start} {os.environ.get('CVM_EXEC_AT', '-1')}", flush=True)
    gaussian_splat.reset_counts()
    trainer.fit(it, max(0, total_steps - start))
    if on_card:
        torch.cuda.synchronize()
    print(f"DONE {trainer.state.step} {gaussian_splat.render_heatmap.launches} "
          f"{os.environ.get('CVM_RESTART_COUNT', '-')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]))
