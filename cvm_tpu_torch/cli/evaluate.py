"""Standalone evaluation: ``python -m cvm_tpu_torch.cli.evaluate --model
centernet|semseg|depth|multitask|dmds --workdir D [--device cuda]``, or of
an exported artifact: ``--artifact DIR``.

Mirrors ``cvm_tpu/cli/evaluate.py`` (``_build_val``, ``_emit``,
``_evaluate_artifact``, ``main``). For a checkpoint it loads the newest of
``<workdir>/checkpoints`` (or ``--checkpoint_dir``, e.g. ``<workdir>/best``
from ``cli.train --keep_best``) and scores it on fixed-seed synthetic scenes
in the posture asked for: fp, ``--fold_bn``, ``--tta hflip``, weight-only
``--quantize int8``, W8A8 with dynamic scales (``--quantize w8a8``) or
calibrated static ones (``w8a8_static``), or calibrated W8A8 through the
fused int8 kernel (``--quantize w8a8_fused[_chain]``), optionally on the
mean of the last N checkpoints (``--average_last``). ``--artifact`` scores
a ``cli.export`` artifact as it is served (``infer/runtime.py``): the model
and its config come from ``artifact.json``. Detection models report mAP,
segmentation models mIoU and pixel accuracy (``--confusion`` adds the
row-normalised confusion matrix), depth models abs_rel, rmse and the delta
thresholds; multitask all three; a ``with_3d`` CenterNet adds the 3D
metrics (``center_err_3d_m``, ``depth3d_abs_rel``, ``matched_3d_frac``);
dmds its median-scaled depth metrics, and refuses the W8A8 postures as the
reference does. ``--data <glob>[,<glob>]`` scores ``.cvrec`` shards
instead of synthetic scenes, in every posture: the ``--split`` (``val`` by
default, ``train`` or ``all``) of ``RecordDataset.split_ids()``, read by a
``RecordLoader`` that does not loop and decodes with ``--device``'s
decoder (``data/jpeg.py``), as RGB or, for a yuv420 artifact, as planes.
Calibration for the static postures stays on synthetic scenes, as
``cli.export``'s.

Over every visible card by default, one process per card, as
``cli.train`` runs (``--num_processes N`` for N local ranks; ``--coordinator
HOST:PORT --num_processes N --process_id R`` for a group started by hand;
one card or ``--device cpu`` is one process): every rank loads
the checkpoint (or the artifact, each rank its own ``ServingModel``) and
reads the same eval batches, each predicts its rows of every batch
(``evaluate_model(mesh=)``, the reference's sharded evaluation), and rank 0
alone prints and writes what one process would.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_val(args, cfg, pad_hw, device, yuv420=False):
    """Held-out eval source: fixed-seed synthetic scenes (two frames for
    dmds, 3D labels for a ``with_3d`` model) or the ``--split`` of
    ``.cvrec`` shards, RGB or (for a yuv420 artifact) as planes."""
    import numpy as np

    if args.data != "synthetic":
        from cvm_tpu_torch.data.loader import RecordLoader
        from cvm_tpu_torch.data.records import RecordDataset

        ds = RecordDataset([p for p in args.data.split(",") if p])
        train_ids, val_ids = ds.split_ids()
        ids = {"val": val_ids, "train": train_ids, "all": None}[args.split]
        return RecordLoader(ds, cfg.batch_size, pad_hw, ids=ids, shuffle=False, loop=False,
                            max_objects=getattr(cfg, "max_objects", 128),
                            output_format="yuv420" if yuv420 else "rgb", device=device)

    from cvm_tpu_torch.data.synthetic import synthetic_batch

    rng = np.random.default_rng(999)
    return [synthetic_batch(rng, cfg.batch_size, pad_hw, num_classes=_num_classes(cfg),
                            two_frame=args.model == "dmds",
                            with_3d=bool(getattr(cfg, "with_3d", False)), yuv420=yuv420)
            for _ in range(args.batches)]


def _num_classes(cfg) -> int:
    """The synthetic scenes' class count: the model's (detection classes
    for multitask, 3 for depth), at most 10."""
    return min(getattr(cfg, "num_classes", getattr(cfg, "num_det_classes", 3)), 10)


def _emit(args, m, step, mesh):
    if mesh is not None and not mesh.is_rank0:
        return
    variant = ""
    if args.artifact:
        variant = f" artifact={args.artifact}"
    elif args.quantize != "none" or args.fold_bn:
        variant = f" quantize={args.quantize}{' fold_bn' if args.fold_bn else ''}"
    print(f"[cvm_tpu_torch] eval model={args.model} step={step} split={args.split}{variant}: "
          f"{json.dumps(m, sort_keys=True)}", flush=True)
    if args.json_out:
        payload = {"model": args.model, "step": step, "quantize": args.quantize,
                   "fold_bn": args.fold_bn, **m}
        if args.artifact:
            payload["artifact"] = args.artifact
        with open(args.json_out, "w") as f:
            json.dump(payload, f)


def _evaluate_artifact(parser, args, overrides, mesh):
    """Score a ``cli.export`` artifact through the metric pipeline: the
    program and the shipped weights run as a deployment runs them
    (``ServingModel``), so this is what the artifact scores. The model and
    its config come from ``artifact.json``; flags baked into the export are
    refused."""
    for flag, name in ((args.tta != "none", "--tta"), (args.quantize != "none", "--quantize"),
                       (args.fold_bn, "--fold_bn"), (bool(args.average_last), "--average_last"),
                       (bool(args.checkpoint_dir), "--checkpoint_dir")):
        if flag:
            parser.error(f"{name} does not apply to --artifact evaluation "
                         "(those choices are baked into the export)")
    if overrides:
        parser.error(f"config overrides {overrides} don't apply to --artifact evaluation "
                     "(the artifact is sealed)")

    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.models.registry import get_model
    from cvm_tpu_torch.train.evaluate import evaluate_model

    sm = ServingModel(args.artifact, device=args.device)
    meta = sm.meta
    name = meta.get("model")
    if args.model and args.model != name:
        parser.error(f"--model {args.model} but the artifact is a {name!r} export")
    if args.pr_out and name not in ("centernet", "multitask"):
        parser.error(f"--pr_out needs a detection-capable model (centernet/multitask); the "
                     f"artifact is {name!r}")
    args.model = name
    cfg = get_model(name).params_cls.from_dict(meta["params_cfg"])
    cfg = cfg.replace(batch_size=int(meta["batch_size"]))
    pad_hw = tuple(meta["pad_hw"])  # the eval batches live on the artifact's canvas
    if args.pad_hw:
        from cvm_tpu_torch.utils.config import parse_hw

        if tuple(parse_hw(args.pad_hw, "--pad_hw")) != pad_hw:
            parser.error(f"--pad_hw must match the artifact's static canvas "
                         f"{pad_hw[0]},{pad_hw[1]}")
    val = _build_val(args, cfg, pad_hw, sm.device, yuv420=sm.input_format == "yuv420")
    m = evaluate_model(name, cfg, None, val, max_batches=args.batches, device=sm.device,
                       per_class=args.per_class, size_buckets=args.size_ap,
                       confusion=args.confusion, pr_curves=args.pr_out is not None,
                       predict_fn=sm.predict_batch, mesh=mesh)
    _write_pr(args, m, mesh)
    _emit(args, m, -1, mesh)
    return 0


def _write_pr(args, m, mesh):
    curves = m.pop("pr_curves", {})
    if args.pr_out and (mesh is None or mesh.is_rank0):
        with open(args.pr_out, "w") as f:
            json.dump(curves, f)
        print(f"[cvm_tpu_torch] PR curves -> {args.pr_out}", file=sys.stderr)


def _calibrate(args, cfg, model, pad_hw, device, say):
    """The reference's calibration recipe, that of ``cli.export``
    (``calibration_scales``): ``--calib_batches`` batches of
    ``max(batch_size, 2)`` synthetic scenes."""
    from cvm_tpu_torch.cli.export import calibration_scales

    scales = calibration_scales(cfg, model, pad_hw, args.calib_batches, cfg.batch_size, device)
    say(f"[cvm_tpu_torch] {args.quantize}: calibrated {len(scales)} convs on "
        f"{max(args.calib_batches, 1)} synthetic batches")
    return scales


def main(argv=None):
    from cvm_tpu_torch.parallel.mesh import (add_process_args, launch_local, process_count,
                                             process_mesh)

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default=None,
                        help="model-zoo name: centernet, semseg, depth, multitask or dmds")
    parser.add_argument("--workdir", default="runs/default",
                        help="training workdir containing checkpoints/")
    parser.add_argument("--checkpoint_dir", default=None,
                        help="explicit checkpoint dir (overrides <workdir>/checkpoints — "
                             "e.g. <workdir>/best from --keep_best)")
    parser.add_argument("--data", default="synthetic",
                        help="'synthetic' or .cvrec glob(s), comma-separated")
    parser.add_argument("--split", default="val", choices=("val", "train", "all"),
                        help="which id split of a record dataset to evaluate")
    parser.add_argument("--batches", type=int, default=50)
    parser.add_argument("--pad_hw", default=None)
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    parser.add_argument("--json_out", default=None,
                        help="also write metrics as JSON to this path")
    parser.add_argument("--per_class", action="store_true",
                        help="report per-class AP alongside the means")
    parser.add_argument("--tta", default="none", choices=("none", "hflip"),
                        help="test-time augmentation: hflip merges the flipped pass at "
                             "the head level (2x forward cost)")
    parser.add_argument("--confusion", action="store_true",
                        help="semseg/multitask: also emit the row-normalized confusion "
                             "matrix (confusion[gt][pred])")
    parser.add_argument("--size_ap", action="store_true",
                        help="report COCO-style mAP_small/medium/large")
    parser.add_argument("--pr_out", default=None, metavar="FILE",
                        help="write per-class precision/recall operating curves "
                             "(IoU 0.5) as JSON")
    parser.add_argument("--average_last", type=int, default=0, metavar="N",
                        help="evaluate the MEAN of the last N retained checkpoints (SWA) "
                             "instead of the newest one")
    parser.add_argument("--quantize", default="none",
                        choices=("none", "int8", "w8a8", "w8a8_static",
                                 "w8a8_fused", "w8a8_fused_chain"),
                        help="score the DEPLOYED numerics: int8 = weight-only, w8a8 = "
                             "dynamic full-integer convs, w8a8_static = calibrated static "
                             "scales (cli.export's calibration, so this scores a "
                             "--quantize w8a8 artifact), w8a8_fused = the same lattice "
                             "through the fused int8 ConvBN kernel, w8a8_fused_chain = + "
                             "int8-resident ResBlock c1->c2 buffers")
    parser.add_argument("--fold_bn", action="store_true",
                        help="evaluate with conv+BN folded as at export time")
    parser.add_argument("--calib_batches", type=int, default=3,
                        help="synthetic calibration batches for w8a8_static and "
                             "w8a8_fused[_chain]")
    parser.add_argument("--artifact", default=None, metavar="DIR",
                        help="score a cli.export artifact (program + shipped weights, "
                             "run as served) instead of a checkpoint")
    add_process_args(parser)
    args, overrides = parser.parse_known_args(argv)
    rc = launch_local(args, process_count(parser, args), "cvm_tpu_torch.cli.evaluate", argv)
    if rc is not None:
        return rc
    with process_mesh(args, args.device) as (args.device, mesh):
        if args.artifact:
            return _evaluate_artifact(parser, args, overrides, mesh)
        return _evaluate_checkpoint(parser, args, overrides, mesh)


def _evaluate_checkpoint(parser, args, overrides, mesh):
    """``main`` for a checkpoint, its arguments parsed (and, with
    ``--coordinator``, the process group formed)."""

    def say(msg):
        if mesh is None or mesh.is_rank0:
            print(msg, file=sys.stderr)

    if not args.model:
        parser.error("--model is required (unless evaluating an --artifact)")
    if args.pr_out and args.model not in ("centernet", "multitask"):
        parser.error(f"--pr_out needs a detection-capable model "
                     f"(centernet/multitask), got {args.model!r}")
    w8a8_fused = args.quantize in ("w8a8_fused", "w8a8_fused_chain")
    if args.quantize.startswith("w8a8") and args.model == "dmds":
        parser.error("w8a8 evaluation is not supported for two-frame dmds "
                     "(matches cli.export)")
    if w8a8_fused and args.fold_bn:
        parser.error("--quantize w8a8_fused is incompatible with --fold_bn: "
                     "the fused kernel applies the BN affine in its epilogue "
                     "from live stats; folded kernels would get it twice")

    import torch

    from cvm_tpu_torch.models.registry import get_model
    from cvm_tpu_torch.train.checkpoints import load_params_cfg
    from cvm_tpu_torch.train.evaluate import evaluate_model
    from cvm_tpu_torch.train.loop import Trainer
    from cvm_tpu_torch.utils.config import parse_hw

    # The checkpoint is self-describing: use the SAVED config, with only the
    # flags the user TYPED overriding it (a value equal to the class default
    # must still override, e.g. --ema_decay 0.0 to score the raw weights).
    try:
        params_cls = get_model(args.model).params_cls
    except KeyError as e:
        parser.error(str(e))
    ckpt_dir = args.checkpoint_dir or f"{args.workdir}/checkpoints"
    try:
        cfg_saved = load_params_cfg(ckpt_dir, params_cls)
    except (FileNotFoundError, OSError):
        cfg_saved = params_cls()
    cfg = cfg_saved
    if overrides:
        passed = {t.lstrip("-").split("=", 1)[0] for t in overrides if t.startswith("--")}
        base = cfg.to_dict()
        cli_cfg = params_cls.from_cli(overrides).to_dict()
        base.update({k: v for k, v in cli_cfg.items() if k in passed})
        cfg = params_cls.from_dict(base)
    pad_hw = (parse_hw(args.pad_hw, "--pad_hw") if args.pad_hw
              else (int(cfg.input_hw[0] * 1.5), int(cfg.input_hw[1] * 1.5)))

    # The restore template's STRUCTURE must match the checkpoint, so the
    # state-shaping fields come from the SAVED config; an override (e.g.
    # --ema_decay 0.0) only selects which weights are evaluated below.
    state_fields = {f: getattr(cfg_saved, f)
                    for f in ("ema_decay", "grad_accum_steps", "tensor_parallel")}
    trainer = Trainer(cfg.replace(**state_fields), args.device, checkpoint_dir=ckpt_dir)
    trainer.init_state()
    step = trainer.state.step
    if step == 0:
        say(f"[cvm_tpu_torch] WARNING: no checkpoint restored from {ckpt_dir} — "
            "evaluating fresh init")
    if args.average_last:
        from cvm_tpu_torch.train.average import average_checkpoints

        try:
            steps = average_checkpoints(trainer, args.average_last)
        except ValueError as e:
            parser.error(f"--average_last: {e}")
        say(f"[cvm_tpu_torch] averaged checkpoints at steps {list(steps)}")

    val = _build_val(args, cfg, pad_hw, trainer.device)
    # EMA parameters when on, with the live BatchNorm statistics.
    model = trainer.eval_model(use_ema=cfg.ema_decay > 0.0)

    w8a8 = None
    if args.quantize == "int8":
        from cvm_tpu_torch.infer.quantize import (dequantize_params, quantization_error,
                                                  quantize_params)

        params = dict(model.named_parameters())
        qparams, _ = quantize_params(params)
        err = quantization_error(params, qparams)
        say(f"[cvm_tpu_torch] weight-only int8: relative weight error {err:.3e}")
        deq = dequantize_params(qparams)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(deq[name])
    elif args.quantize == "w8a8":
        w8a8 = True
    elif args.quantize != "none":  # w8a8_static, w8a8_fused[_chain]
        w8a8 = _calibrate(args, cfg, model, pad_hw, trainer.device, say)

    m = evaluate_model(args.model, cfg, model, val, max_batches=args.batches,
                       device=trainer.device, per_class=args.per_class,
                       size_buckets=args.size_ap, confusion=args.confusion,
                       pr_curves=args.pr_out is not None,
                       tta=args.tta, w8a8=w8a8, w8a8_fused=w8a8_fused,
                       w8a8_chain=args.quantize == "w8a8_fused_chain", fold_bn=args.fold_bn,
                       mesh=mesh)
    _write_pr(args, m, mesh)
    _emit(args, m, step, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
