"""Training entry point: ``python -m cvm_tpu_torch.cli.train --model
centernet|semseg|depth|multitask|dmds --data synthetic|<.cvrec glob>[,glob]
--device cuda ...``.

Mirrors ``cvm_tpu/cli/train.py::main``: every field of the model's params
class (``models/registry.py``) is a ``--field value`` flag, with the
class's defaults; ``--steps`` is the TOTAL step target, so a run that
resumes from ``<workdir>/checkpoints`` trains only the remainder; SIGTERM
and ``--max_seconds`` stop cleanly after the current step with a checkpoint
of it. Metrics go to ``<workdir>/metrics.jsonl``. The synthetic scenes
carry two frames for ``--model dmds`` and 3D labels for ``--with_3d
true``, as the reference's.

``--data <glob>[,<glob>]`` trains from ``.cvrec`` shards instead
(``data/loader.py::RecordLoader``, one process: the train ids of
``split_ids()``), decoding each JPEG at the smallest power-of-2 DCT scale
that covers ``--decode_target`` (``auto``: 1.3x ``input_hw``; ``off``;
or ``H,W``), with the decoder of ``--device`` (``data/jpeg.py``). Its
evals read the val split through a loader that does not loop, and the
run ends by printing the loader's per-stage host times. A resumed run
starts the record stream from its beginning, as the reference's does.

``--eval_every N`` trains in chunks that end at multiples of N and scores
the model after each (``evaluate_model`` on fixed-seed synthetic scenes or
the records' val split, ``val_*`` rows in ``metrics.jsonl``); ``--keep_best
METRIC`` keeps the best checkpoint by that metric in ``<workdir>/best``
(loadable by ``cli.evaluate --checkpoint_dir``); ``--early_stop P`` stops
after P evals without improvement. The chunks end at multiples of N (the
reference ends them N steps after the start), so a run that is stopped and
resumed evaluates at the same steps as one that is not.

``--qat true`` trains with fake-quantized convs (``train/qat.py``). Flipped
on a run resumed from an fp checkpoint (the reference's QAT fine-tune
recipe), it takes effect, and ``<workdir>/checkpoints/params.json`` is
rewritten to say so, since evaluation and export read the config there.

``--auto_restart N`` re-execs this command (``python -m
cvm_tpu_torch.cli.train`` and the same arguments) up to N times when the
stall watchdog finds the device stalled (``train/loop.py``); the new
process resumes from the newest checkpoint. Over the local ranks (below)
the stalled rank exits instead, and the launcher starts every rank again
from the newest checkpoint. ``--tensorboard`` also writes
the metrics as TensorBoard events to ``<workdir>/tb``, and ``--eval_images
N`` renders N eval samples' predictions (``infer/visualize.py``) into them
at every eval. ``--profile_steps N`` trains up to 20 warm-up steps, then
records N steps with ``torch.profiler`` into ``<workdir>/trace``
(``utils/prof.py::trace``). ``--debug_nans`` raises at the first step with
a non-finite output, loss, gradient or parameter, naming it.
``--aug_rotate_deg`` and ``--remat true`` are the reference's.

Multi-process training, one process per card. By default the command runs
over every visible card of the host, as the reference's ``Trainer`` runs
over every chip: with ``--device cuda`` and more than one card
(``CUDA_VISIBLE_DEVICES`` narrows them), or with ``--num_processes N``,
this process launches one rank per card (N ranks) on 127.0.0.1 and waits
for them (``parallel/mesh.py::launch_local``): rank 0's output streams
through it, SIGTERM and SIGINT reach every rank, and when one rank fails
the others are killed and the command exits non-zero. One card, or
``--device cpu`` without ``--num_processes``, is one process. Over hosts,
or by hand: ``--coordinator HOST:PORT --num_processes N --process_id R``
on every process (the same arguments but R), rank 0 serving the
rendezvous at HOST:PORT. NCCL between cards (``--device cuda``: rank R on
``cuda:{R % cards}``), gloo on the CPU, or ``--backend gloo``, with which
ranks may share a card (``parallel/mesh.py``). ``--model_parallel M`` lays the N ranks out as
N/M data x M model, and ``--tensor_parallel true`` (which needs M >= 2)
splits the stage-5 blocks over the model axis (``parallel/sharding.py``).
``--batch_size`` stays the global batch, divided over the N/M data ranks;
data rank d reads the synthetic stream seeded ``seed + d * 7919`` or the
records' d-th stride of the train ids, as the reference's processes do.
Rank 0 alone prints, writes ``metrics.jsonl``, TensorBoard, checkpoints
(whole tensors: ``cli.evaluate`` loads them in one process) and the best
checkpoint. Every eval runs on every rank, each data rank predicting its
rows (``evaluate_model(mesh=)``, as the reference's). ``--auto_restart``
is refused with ``--coordinator``: it would re-exec one rank, which cannot
rejoin the group, and the job spans processes no launcher here owns.
``--dcn_slices`` is not ported (``_DCN_NOT_PORTED``).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

_DCN_NOT_PORTED = (
    "--dcn_slices is not ported: it orders a multi-slice TPU mesh's devices slice-major, so "
    "that XLA's all-reduces stay on ICI within a slice and cross DCN once; NCCL picks its own "
    "ring or tree over the nodes (ROADMAP 'Not to port')")


def _record_qat_flip(workdir: str, cfg, keep_best: bool, params_cls, load_params_cfg) -> None:
    """A resumed run whose ``--qat`` differs from its saved config trains
    with the flag; the saved config is rewritten, so that evaluation and
    export of the checkpoints from here on see it. A best checkpoint kept
    before the flip was scored with the other numerics, so ``--keep_best``
    then refuses."""
    import os

    ckdir = os.path.join(workdir, "checkpoints")
    try:
        saved = load_params_cfg(ckdir, params_cls)
    except (FileNotFoundError, OSError):
        return
    if bool(saved.qat) == bool(cfg.qat):
        return
    if keep_best and os.path.exists(os.path.join(workdir, "best", "best.json")):
        raise SystemExit(f"--qat {str(cfg.qat).lower()} flips the config of {workdir}, whose "
                         f"best checkpoint was scored with qat={str(saved.qat).lower()}: "
                         "fine-tune in a new workdir seeded with the checkpoint")
    with open(os.path.join(ckdir, "params.json"), "w") as f:
        f.write(saved.replace(qat=bool(cfg.qat)).to_json())
    print(f"[cvm_tpu_torch] qat={str(cfg.qat).lower()} on a run saved with "
          f"qat={str(saved.qat).lower()}: {ckdir}/params.json updated", file=sys.stderr,
          flush=True)


def main(argv=None) -> int:
    from cvm_tpu_torch.parallel.mesh import (RESTART_EXIT, add_process_args, launch_local,
                                             process_count, process_mesh)

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True,
                        help="zoo name: centernet, semseg, depth, multitask or dmds")
    parser.add_argument("--data", default="synthetic",
                        help="'synthetic' or .cvrec glob(s); comma-separate to mix datasets "
                             "(matched label spaces)")
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
    parser.add_argument("--eval_every", type=int, default=0,
                        help="run evaluation every N steps (0 = off)")
    parser.add_argument("--eval_batches", type=int, default=20)
    parser.add_argument("--keep_best", default=None, metavar="METRIC",
                        help="with --eval_every: keep the best checkpoint by this eval "
                             "metric (e.g. mAP, miou, delta1) in <workdir>/best")
    parser.add_argument("--keep_best_mode", default="max", choices=["max", "min"],
                        help="whether higher (max) or lower (min) is better")
    parser.add_argument("--early_stop", type=int, default=0, metavar="PATIENCE",
                        help="with --keep_best: stop after PATIENCE consecutive evals "
                             "without improvement on the --keep_best metric")
    parser.add_argument("--eval_images", type=int, default=0, metavar="N",
                        help="with --eval_every and --tensorboard: render N eval samples' "
                             "predictions into the TensorBoard Images tab at every eval")
    parser.add_argument("--auto_restart", type=int, default=0, metavar="N",
                        help="on a device stall, re-exec this command up to N times and "
                             "resume from the latest checkpoint")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also write TensorBoard events to <workdir>/tb")
    parser.add_argument("--model_parallel", type=int, default=1, metavar="N",
                        help="size of the mesh 'model' axis (tensor-parallel degree); "
                             "required >= 2 when the model config sets tensor_parallel")
    parser.add_argument("--dcn_slices", type=int, default=1, metavar="N",
                        help="not ported (the device order of a multi-slice TPU mesh)")
    add_process_args(parser)
    parser.add_argument("--profile_steps", type=int, default=0, metavar="N",
                        help="record N steady-state steps with torch.profiler into "
                             "<workdir>/trace (after up to 20 warm-up steps)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="raise at the first step with a non-finite output, loss, "
                             "gradient or parameter, naming it")
    parser.add_argument("--decode_target", default="auto",
                        help="scale-aware JPEG decode target: 'auto' (1.3x input), 'off', "
                             "or 'H,W'")
    args, overrides = parser.parse_known_args(argv)

    if args.keep_best and args.eval_every <= 0:
        parser.error("--keep_best requires --eval_every (the best checkpoint "
                     "is selected by the eval metric)")
    if args.eval_images > 0 and (args.eval_every <= 0 or not args.tensorboard):
        parser.error("--eval_images requires --eval_every and --tensorboard "
                     "(images land in the TB events file)")
    if args.early_stop > 0 and not args.keep_best:
        parser.error("--early_stop requires --keep_best (it defines the "
                     "watched metric and direction)")
    world = process_count(parser, args)
    if args.dcn_slices != 1:
        raise SystemExit(_DCN_NOT_PORTED)
    if args.model_parallel < 1 or world % args.model_parallel:
        parser.error(f"{world} processes not divisible by --model_parallel "
                     f"{args.model_parallel}")
    if args.auto_restart > 0 and args.coordinator is not None and not args.restart_by_exit:
        parser.error("--auto_restart re-execs one process, which cannot rejoin the process "
                     "group of the others: restart the whole job instead (every rank "
                     "resumes from the newest checkpoint); without --coordinator the "
                     "launcher restarts every rank")

    from cvm_tpu_torch.models.registry import get_model
    from cvm_tpu_torch.utils.config import parse_hw

    try:
        spec = get_model(args.model)
    except KeyError as e:
        parser.error(str(e))
    cfg = spec.params_cls.from_cli(overrides)
    if getattr(cfg, "tensor_parallel", False) and args.model_parallel < 2:
        # Without a model axis the rules would shard nothing: fail here.
        parser.error("--tensor_parallel true requires --model_parallel >= 2 (the mesh "
                     "'model' axis the TP rules shard over)")
    data_ranks = world // args.model_parallel
    if cfg.batch_size % data_ranks:
        parser.error(f"batch_size {cfg.batch_size} not divisible by {data_ranks} "
                     "data-parallel processes")
    if world > 1 and args.auto_restart > 255 - RESTART_EXIT:
        parser.error(f"--auto_restart over local ranks counts at most {255 - RESTART_EXIT} "
                     "restarts (a rank's exit code carries the count)")
    rc = launch_local(args, world, "cvm_tpu_torch.cli.train", argv)
    if rc is not None:
        return rc
    pad_hw = (parse_hw(args.pad_hw, "--pad_hw") if args.pad_hw
              else (int(cfg.input_hw[0] * 1.5), int(cfg.input_hw[1] * 1.5)))
    nc = min(getattr(cfg, "num_classes", getattr(cfg, "num_det_classes", 3)), 10)
    scenes = dict(two_frame=args.model == "dmds", with_3d=bool(getattr(cfg, "with_3d", False)))
    records = target_hw = None
    if args.data != "synthetic":
        from cvm_tpu_torch.data.records import RecordDataset

        records = RecordDataset([p for p in args.data.split(",") if p])
        if args.decode_target == "auto":
            target_hw = (int(cfg.input_hw[0] * 1.3), int(cfg.input_hw[1] * 1.3))
        elif args.decode_target == "off":
            target_hw = (0, 0)
        else:
            target_hw = parse_hw(args.decode_target, "--decode_target")
    with process_mesh(args, args.device, args.model_parallel) as (device, mesh):
        return _train(args, argv, spec, cfg, pad_hw, nc, scenes, records, target_hw, device,
                      mesh)


def _train(args, argv, spec, cfg, pad_hw, nc, scenes, records, target_hw, device, mesh) -> int:
    """The run of ``main`` once the arguments are checked (and, with
    ``--coordinator``, the process group formed)."""
    import contextlib

    import numpy as np
    import torch

    from cvm_tpu_torch.data.loader import RecordLoader
    from cvm_tpu_torch.data.synthetic import SyntheticIterator, synthetic_batch
    from cvm_tpu_torch.train.checkpoints import BestCheckpoint, load_params_cfg
    from cvm_tpu_torch.train.early_stop import EarlyStopper
    from cvm_tpu_torch.train.evaluate import evaluate_model
    from cvm_tpu_torch.train.loop import Trainer

    rank0 = mesh is None or mesh.is_rank0
    data_index, data_ranks = (0, 1) if mesh is None else (mesh.data_index, mesh.data)
    local_bs = cfg.batch_size // data_ranks

    def log(msg: str, err: bool = False) -> None:
        if rank0:
            print(msg, file=sys.stderr if err else sys.stdout, flush=True)

    if rank0:
        _record_qat_flip(args.workdir, cfg, bool(args.keep_best), spec.params_cls,
                         load_params_cfg)

    # A programmatic caller's argv, not the host process's command line: the
    # restart must re-exec the training command.
    restart_argv = ([sys.executable, "-m", "cvm_tpu_torch.cli.train"]
                    + list(argv if argv is not None else sys.argv[1:])
                    if args.auto_restart > 0 else None)
    trainer = Trainer(cfg, device, checkpoint_dir=f"{args.workdir}/checkpoints",
                      metrics_path=f"{args.workdir}/metrics.jsonl",
                      tensorboard_dir=f"{args.workdir}/tb" if args.tensorboard else None,
                      checkpoint_every=args.checkpoint_every, log_every=args.log_every,
                      seed=args.seed, restart_argv=restart_argv,
                      max_restarts=args.auto_restart, debug_nans=args.debug_nans, mesh=mesh,
                      restart_by_exit=args.restart_by_exit)
    best = (BestCheckpoint(f"{args.workdir}/best", args.keep_best, args.keep_best_mode,
                           params_cfg=cfg) if args.keep_best and rank0 else None)
    stopper = (EarlyStopper(args.keep_best, args.early_stop, args.keep_best_mode)
               if args.early_stop > 0 else None)

    def run_eval(it):
        # Held-out data: scenes from their own generator, or the records'
        # val split; the training streams (data, augmentation) and the
        # training model are not touched. Under a group every rank scores
        # its rows of each eval batch (evaluate_model(mesh=), a tensor-
        # parallel model kept split) and gets the same metrics; rank 0
        # alone then logs, writes and keeps the best checkpoint while the
        # others wait on the store (a long write trips no collective).
        model = trainer.eval_model()
        ck_state = (trainer.checkpoint_state(it.state_dict() if hasattr(it, "state_dict")
                                             else None) if args.keep_best else None)
        if records is None:
            rng = np.random.default_rng(999)
            val = [synthetic_batch(rng, cfg.batch_size, pad_hw, num_classes=nc, **scenes)
                   for _ in range(args.eval_batches)]
        else:
            val = RecordLoader(records, cfg.batch_size, pad_hw,
                               ids=records.split_ids()[1], shuffle=False, loop=False,
                               max_objects=getattr(cfg, "max_objects", 128),
                               device=trainer.device)
        t0 = time.perf_counter()
        m = evaluate_model(args.model, cfg, model, val, max_batches=args.eval_batches,
                           device=trainer.device, mesh=mesh)
        seconds = time.perf_counter() - t0
        step = trainer.state.step
        log(f"[cvm_tpu_torch] eval@{step}: {m} ({seconds:.2f} s)")
        shown = eval_image_predictions(model, val) if args.eval_images > 0 else None

        def record():
            trainer.metrics_writer.write(step, {**{f"val_{k}": v for k, v in m.items()},
                                                "eval_seconds": seconds})
            if best is not None:
                if args.keep_best not in m:
                    log(f"[cvm_tpu_torch] --keep_best {args.keep_best!r} not in eval "
                        f"metrics {sorted(m)} — no best checkpoint recorded", err=True)
                elif best.update(step, ck_state, m[args.keep_best]):
                    log(f"[cvm_tpu_torch] new best {args.keep_best}={m[args.keep_best]:.4f} "
                        f"@step {step} -> {args.workdir}/best")
            if shown is not None:
                write_eval_images(*shown, step)

        if mesh is None:
            record()
        else:
            mesh.from_rank0("best", record)
        return m

    def eval_image_predictions(model, val):
        """The first eval batch (host arrays) and its predictions, for
        ``--eval_images``; None without an RGB batch. Every rank predicts
        its rows."""
        from cvm_tpu_torch.infer.pipeline import InferencePipeline

        if isinstance(val, list):
            batch0 = val[0]
        else:
            stream = iter(val)  # the records' val split, read anew
            batch0 = next(stream, None)
            stream.close()  # stops the loader's worker thread
        if batch0 is None or "image" not in batch0:
            log("[cvm_tpu_torch] --eval_images: no RGB eval batch — skipping image "
                "summaries", err=True)
            return None
        host = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in batch0.items()}
        pipe = InferencePipeline(cfg, model, trainer.device, input_format="rgb", mesh=mesh)
        return host, {k: v.cpu().numpy() for k, v in pipe(host).items()}

    def write_eval_images(host, out, step):
        """The predictions drawn on their images (``infer/visualize.py::
        render_sample``) into the TensorBoard Images tab: the reference's
        headless stand-in for its OpenCV windows."""
        from cvm_tpu_torch.infer.visualize import render_sample

        n = min(args.eval_images, int(host["image"].shape[0]))
        for i in range(n):
            vis = {k: v[i] for k, v in out.items()}
            if "centers3d" in out and "intrinsics" in host:
                vis["intrinsics"] = host["intrinsics"][i]
            rgb = render_sample(None, host["image"][i], host["image_hw"][i], vis)
            trainer.metrics_writer.write_image(step, f"eval/sample_{i}", rgb)
        log(f"[cvm_tpu_torch] wrote {n} eval image summaries @step {step}")

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
    it = None
    try:
        if records is None:
            # The reference's synthetic stream: batch_size scenes per batch,
            # at most 10 classes, padded to its default of 8 boxes (no
            # max_objects); data rank d seeded seed + d * 7919.
            it = SyntheticIterator(args.seed + data_index * 7919, local_bs, pad_hw,
                                   num_classes=nc, **scenes)
        else:
            train_ids = records.split_ids(shard_index=data_index, num_shards=data_ranks)[0]
            loader = RecordLoader(records, local_bs, pad_hw, ids=train_ids,
                                  max_objects=getattr(cfg, "max_objects", 128),
                                  seed=args.seed, target_hw=target_hw, device=trainer.device)
            it = iter(loader)
        trainer.init_state()
        if trainer.data_state is not None and records is None:
            it.load_state_dict(trainer.data_state)
        start_step = trainer.state.step
        where = "" if mesh is None else f" mesh=(data={mesh.data}, model={mesh.model})"
        log(f"[cvm_tpu_torch] model={args.model} device={trainer.device}{where} "
            f"start_step={start_step}")
        steps = args.steps
        if start_step > 0 and steps > 0:
            steps = max(0, steps - start_step)
            log(f"[cvm_tpu_torch] resume: {steps} of the --steps total remain")
        metrics = {}
        if args.profile_steps > 0 and steps > 0:
            from cvm_tpu_torch.utils.prof import trace

            # Warm up past the kernel builds and the allocator's growth, so
            # that the trace holds steady-state steps only.
            warm = min(20, max(steps - args.profile_steps, 0))
            if warm:
                trainer.fit(it, warm)
            n = min(args.profile_steps, steps - warm)
            with trace(f"{args.workdir}/trace") if rank0 else contextlib.nullcontext():
                metrics = trainer.fit(it, n)
                if trainer.device.type == "cuda":
                    torch.cuda.synchronize(trainer.device)
            steps -= warm + n
            log(f"[cvm_tpu_torch] profiler trace of {n} steps written to "
                f"{args.workdir}/trace")
        if args.eval_every > 0:
            if steps == 0 and start_step > 0:
                # Resumed past the target (stopped between the last chunk
                # and its eval): the final eval, and the best checkpoint it
                # selects, still happen.
                run_eval(it)
            while steps > 0:
                chunk = min(args.eval_every - trainer.state.step % args.eval_every, steps)
                metrics = trainer.fit(it, chunk)
                if trainer.stop_requested:
                    break  # stopping: skip the eval, the grace window is short
                steps -= chunk
                m = run_eval(it)
                if stopper is not None and stopper.update(m):
                    log(f"[cvm_tpu_torch] early stop @step {trainer.state.step}: "
                        f"{args.keep_best} has not improved past {stopper.best:.4f} for "
                        f"{args.early_stop} evals (best checkpoint is in "
                        f"{args.workdir}/best)")
                    break
        elif steps > 0:
            metrics = trainer.fit(it, steps)
        if records is not None:
            # read / decode / assemble ms per batch on the host: decode
            # beside the step time shows a host-decode-bound run
            log(f"[cvm_tpu_torch] input pipeline: {loader.stats()}")
    finally:
        if records is not None and it is not None:
            it.close()  # releases the loader's worker thread
        if timer is not None:
            timer.cancel()
        signal.signal(signal.SIGTERM, old_handler)
        if trainer.metrics_writer is not None:
            trainer.metrics_writer.close()
    # the best checkpoint's write in flight is on disk before the run ends
    # (rank 0 holds the writer; the other ranks wait for it)
    if mesh is not None:
        mesh.from_rank0("best saved", best.close if best is not None else lambda: None)
    elif best is not None:
        best.close()
    if trainer.stop_requested:
        log(f"[cvm_tpu_torch] stopped at step {trainer.state.step}: checkpoint "
            "committed, exiting cleanly")
        return 0
    log(f"[cvm_tpu_torch] done at step {trainer.state.step}: {metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
