"""Training entry point: ``python -m cvm_tpu_torch.cli.train --model centernet
--data synthetic --device cuda ...``.

Mirrors ``cvm_tpu/cli/train.py::main``: every ``CenternetParams`` field is a
``--field value`` flag; ``--steps`` is the TOTAL step target, so a run that
resumes from ``<workdir>/checkpoints`` trains only the remainder; SIGTERM
and ``--max_seconds`` stop cleanly after the current step with a checkpoint
of it. Metrics go to ``<workdir>/metrics.jsonl``.

Flags whose machinery is not ported raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

# flag -> (value that means "off", ROADMAP Queue 1 item that ports it)
_NOT_PORTED = {
    "eval_every": (0, "12"), "keep_best": (None, "12"), "early_stop": (0, "12"),
    "auto_restart": (0, "11 (the stall watchdog)"), "tensorboard": (False, "16"),
    "model_parallel": (1, "17"), "dcn_slices": (1, "17"), "coordinator": (None, "17"),
}
_NOT_PORTED_CFG = {"qat": (False, "13"), "remat": (False, "16"),
                   "aug_rotate_deg": (0.0, "16"), "tensor_parallel": (False, "17"),
                   "with_3d": (False, "15")}


def _not_ported(flag: str, item: str) -> SystemExit:
    return SystemExit(f"--{flag} is not ported yet (ROADMAP Queue 1 item {item})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True, help="zoo name (centernet is ported)")
    parser.add_argument("--data", default="synthetic",
                        help="'synthetic' (.cvrec record data is not ported yet)")
    parser.add_argument("--steps", type=int, default=1000,
                        help="TOTAL training steps (global step target): a run resumed "
                             "from a checkpoint trains only the remainder")
    parser.add_argument("--workdir", default="runs/default")
    parser.add_argument("--checkpoint_every", type=int, default=1000)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--pad_hw", default=None,
                        help="loader pad size 'H,W' (default: 1.5x input)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    parser.add_argument("--max_seconds", type=float, default=0, metavar="S",
                        help="after S seconds, finish the current step, checkpoint it "
                             "and exit 0 (re-invoke to continue toward --steps)")
    parser.add_argument("--eval_every", type=int, default=0)
    parser.add_argument("--keep_best", default=None)
    parser.add_argument("--early_stop", type=int, default=0)
    parser.add_argument("--auto_restart", type=int, default=0)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument("--dcn_slices", type=int, default=1)
    parser.add_argument("--coordinator", default=None)
    args, overrides = parser.parse_known_args(argv)

    for flag, (off, item) in _NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise _not_ported(flag, item)
    if args.model != "centernet":
        raise SystemExit(f"--model {args.model} is not ported yet (ROADMAP Queue 1 "
                         "item 15); centernet is")
    if args.data != "synthetic":
        raise SystemExit("--data: .cvrec record data is not ported yet (ROADMAP Queue 1 "
                         "item 11, the record loader); use --data synthetic")

    from cvm_tpu_torch.data.synthetic import SyntheticIterator
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.train.loop import Trainer
    from cvm_tpu_torch.utils.config import parse_hw

    cfg = CenternetParams.from_cli(overrides)
    for field, (off, item) in _NOT_PORTED_CFG.items():
        if getattr(cfg, field) != off:
            raise _not_ported(field, item)
    pad_hw = (parse_hw(args.pad_hw, "--pad_hw") if args.pad_hw
              else (int(cfg.input_hw[0] * 1.5), int(cfg.input_hw[1] * 1.5)))

    trainer = Trainer(cfg, args.device, checkpoint_dir=f"{args.workdir}/checkpoints",
                      metrics_path=f"{args.workdir}/metrics.jsonl",
                      checkpoint_every=args.checkpoint_every, log_every=args.log_every,
                      seed=args.seed)

    def stop(reason: str) -> None:
        trainer.request_stop()
        print(f"[cvm_tpu_torch] {reason}: checkpointing the current step, then exiting "
              "cleanly (resume with the same --workdir)", file=sys.stderr, flush=True)

    old_handler = signal.signal(signal.SIGTERM, lambda signum, frame: stop("SIGTERM"))
    timer = None
    if args.max_seconds > 0:
        timer = threading.Timer(args.max_seconds, stop,
                                args=(f"--max_seconds {args.max_seconds:g} reached",))
        timer.daemon = True
        timer.start()
    try:
        # The reference's synthetic stream: batch_size scenes per batch, at
        # most 10 classes, padded to its default of 8 boxes (no max_objects).
        it = SyntheticIterator(args.seed, cfg.batch_size, pad_hw,
                               num_classes=min(cfg.num_classes, 10))
        trainer.init_state()
        if trainer.data_state is not None:
            it.load_state_dict(trainer.data_state)
        start_step = trainer.state.step
        print(f"[cvm_tpu_torch] model={args.model} device={trainer.device} "
              f"start_step={start_step}", flush=True)
        steps = args.steps
        if start_step > 0 and steps > 0:
            steps = max(0, steps - start_step)
            print(f"[cvm_tpu_torch] resume: {steps} of the --steps total remain", flush=True)
        metrics = trainer.fit(it, steps) if steps > 0 else {}
    finally:
        if timer is not None:
            timer.cancel()
        signal.signal(signal.SIGTERM, old_handler)
        if trainer.metrics_writer is not None:
            trainer.metrics_writer.close()
    if trainer.stop_requested:
        print(f"[cvm_tpu_torch] stopped at step {trainer.state.step}: checkpoint "
              "committed, exiting cleanly", flush=True)
        return 0
    print(f"[cvm_tpu_torch] done at step {trainer.state.step}: {metrics}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
