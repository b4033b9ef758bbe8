"""Offline inference: ``python -m cvm_tpu_torch.cli.infer (--checkpoint_dir D
--model NAME | --artifact DIR) (--images GLOB | --records GLOB)
[--visualize OUT] [--device cuda]``.

Mirrors ``cvm_tpu/cli/infer.py`` (``main``, ``_drive``): one JSON line per
image on stdout (boxes, scores and classes above ``--score_threshold``; a
class histogram; the mean depth; 3D centres, dimensions and yaw), and with
``--visualize`` one PNG per image, the outputs drawn on the source frame
(``infer/visualize.py::render_sample``). Inputs: ``--images``, a glob of
image files (JPEGs as they are, other formats encoded once with PIL),
decoded by ``--device``'s decoder (``data/jpeg.py``: nvJPEG on the card),
the last chunk padded to a full batch by repeating its last file and only
its real rows reported; or ``--records``, ``.cvrec`` shards through a
``RecordLoader`` that does not loop (a ragged last batch is dropped, as the
reference's loader drops it). Sources:

* ``--checkpoint_dir``: the checkpoint's config (``params.json``) served by
  an fp ``InferencePipeline`` (EMA weights when the run kept them), with
  ``--tta hflip``, or ``--w8a8``: activation scales calibrated on the first
  batch (``infer/quantize.py::calibrate_activation_scales``) and every conv
  an ``Int8Conv`` on ``torch._int_mm`` (``swap_int8``, the static posture);
* ``--artifact``: a ``cli.export`` RGB artifact run as served
  (``infer/runtime.py::ServingModel.predict_batch``); a ``w8a8_fused`` or
  ``w8a8_fused_chain`` export runs the fused int8 kernel (K2,
  ``csrc/fused_qconv.cu``) inside its program.

``--tiled`` (semseg, depth, multitask from a checkpoint, with
``--images``): each image at its own resolution through overlapping
``input_hw`` tiles (``infer/tiled.py::tiled_predict``, ``--tile_overlap``),
one JSON line per image (its ``hw``, the class histogram, the mean depth)
and, with ``--visualize``, ``<name>.classes.png`` (the palette) and
``<name>.depth.png`` (uint16, depth * 256); the images are read with PIL,
as the reference reads them.

It keeps the reference's refusals: exactly one source; flags baked into an
artifact at export; yuv420 and two-frame artifacts; ``--w8a8`` for dmds;
``--tiled`` for detection, records, ``--w8a8`` and ``--tta``. A summary
(batches, images, ms per batch on the host clock) goes to stderr.

Over every visible card by default, one process per card, as
``cli.train`` runs (``--num_processes N`` for N local ranks; ``--coordinator
HOST:PORT --num_processes N --process_id R`` for a group started by hand;
one card or ``--device cpu`` is one process): every rank reads
and decodes the same batches and predicts its rows of each
(``InferencePipeline(mesh=)``, or ``shard_predict`` of its own artifact's
``ServingModel``), and rank 0 alone prints the JSONL, the summary and the
``--visualize`` PNGs, equal to one process's. ``--tiled`` runs image by
image on one card: one process by default, and refused over more.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def _run_tiled(args, cfg, trainer) -> int:
    """Per-image native-resolution dense prediction (``infer/tiled.py``)."""
    from PIL import Image

    from cvm_tpu_torch.infer.tiled import tiled_predict

    files = sorted(glob.glob(args.images))
    if not files:
        raise SystemExit(f"no files match {args.images!r}")
    trainer.init_state()
    model = trainer.eval_model(use_ema=getattr(cfg, "ema_decay", 0.0) > 0.0)
    if args.visualize:
        os.makedirs(args.visualize, exist_ok=True)
    t_total = 0.0
    for f in files:
        img = np.asarray(Image.open(f).convert("RGB"), np.uint8)
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in tiled_predict(cfg, model, img,
                                                             overlap=args.tile_overlap).items()}
        t_total += time.perf_counter() - t0
        rec = {"input": os.path.basename(f), "hw": list(img.shape[:2])}
        if "class_map" in out:
            rec["class_histogram"] = np.bincount(out["class_map"].reshape(-1),
                                                 minlength=1).tolist()
        if "depth" in out:
            rec["depth_mean"] = float(out["depth"].mean())
        print(json.dumps(rec), flush=True)
        if args.visualize:
            base = os.path.join(args.visualize, os.path.basename(f))
            if "class_map" in out:
                from cvm_tpu_torch.models.semseg.params import SEMSEG_PALETTE

                pal = np.asarray(SEMSEG_PALETTE, np.uint8)
                Image.fromarray(pal[np.clip(out["class_map"], 0, len(pal) - 1)]).save(
                    base + ".classes.png")
            if "depth" in out:
                # uint16 depth * 256, the KITTI PNG convention the adapters read
                d = out["depth"][..., 0]
                Image.fromarray((np.clip(d, 0, 255) * 256).astype(np.uint16)).save(
                    base + ".depth.png")
    print(json.dumps({"model": args.model, "tiled": True, "images": len(files),
                      "ms_per_image_avg": round(t_total / len(files) * 1e3, 3)}),
          file=sys.stderr, flush=True)
    return 0


def main(argv=None) -> int:
    from cvm_tpu_torch.parallel.mesh import (add_process_args, launch_local, process_count,
                                             process_mesh)

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default=None,
                        help="model-zoo name (optional with --artifact)")
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--artifact", default=None, metavar="DIR",
                        help="run an EXPORTED artifact (cli.export output) instead of a "
                             "checkpoint: the serialized program + shipped weights produce "
                             "the JSONL and --visualize renderings (rgb exports; "
                             "quantize/fold/tta are baked in at export)")
    parser.add_argument("--images", default=None, help="glob of image files")
    parser.add_argument("--records", default=None, help=".cvrec glob")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--score_threshold", type=float, default=0.3)
    parser.add_argument("--visualize", default=None, help="output dir for rendered PNGs")
    parser.add_argument("--w8a8", action="store_true",
                        help="run convs on the int8 path with calibrated static activation "
                             "scales (calibrates on the first batch)")
    parser.add_argument("--tta", default="none", choices=("none", "hflip"),
                        help="test-time augmentation: hflip merges the flipped pass at the "
                             "head level (2x forward cost; rejected for with_3d/dmds)")
    parser.add_argument("--tiled", action="store_true",
                        help="dense models (semseg/depth/multitask): stitch predictions at "
                             "each image's native resolution from overlapping input_hw tiles "
                             "instead of letterboxing to the training size")
    parser.add_argument("--tile_overlap", type=float, default=0.25)
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    add_process_args(parser)
    args = parser.parse_args(argv)

    if bool(args.artifact) == bool(args.checkpoint_dir):
        parser.error("exactly one source: --checkpoint_dir or --artifact")
    world = (1 if args.tiled and args.coordinator is None and args.num_processes is None
             else process_count(parser, args))
    if world > 1 and args.tiled:
        parser.error("--tiled predicts image by image on one card: run it in one process")
    rc = launch_local(args, world, "cvm_tpu_torch.cli.infer", argv)
    if rc is not None:
        return rc
    with process_mesh(args, args.device) as (args.device, mesh):
        return _infer(parser, args, mesh)


def _infer(parser, args, mesh) -> int:
    """``main`` once the arguments are parsed (and, with ``--coordinator``,
    the process group formed)."""
    from cvm_tpu_torch.infer.pipeline import shard_predict

    rank0 = mesh is None or mesh.is_rank0

    sm = None
    if args.artifact:
        from cvm_tpu_torch.infer.runtime import ServingModel

        for flag, name in ((args.w8a8, "--w8a8"), (args.tta != "none", "--tta"),
                           (args.tiled, "--tiled")):
            if flag:
                parser.error(f"{name} is baked at export time for artifacts")
        sm = ServingModel(args.artifact, device=args.device)
        if sm.input_format != "rgb":
            parser.error("cli.infer serves rgb artifacts (yuv420 accuracy runs via "
                         "cli.evaluate --artifact; streaming via cli.serve)")
        name = sm.meta.get("model")
        if name == "dmds":
            parser.error("two-frame dmds artifacts stream via cli.serve --records")
        if args.model and args.model != name:
            parser.error(f"--model {args.model} but the artifact is a {name!r} export")
        args.model = name
        args.batch_size = int(sm.meta.get("batch_size", args.batch_size))
        pad_hw = tuple(sm.meta.get("pad_hw"))
        device = sm.device
    elif not args.model:
        parser.error("--model is required with --checkpoint_dir")

    if sm is None:
        from cvm_tpu_torch.models.registry import get_model
        from cvm_tpu_torch.train.checkpoints import load_params_cfg
        from cvm_tpu_torch.train.loop import Trainer

        spec = get_model(args.model)
        cfg = load_params_cfg(args.checkpoint_dir, spec.params_cls)
        trainer = Trainer(cfg, args.device, checkpoint_dir=args.checkpoint_dir)
        device = trainer.device
        pad_hw = (int(cfg.input_hw[0] * 1.5), int(cfg.input_hw[1] * 1.5))

    if args.tiled:
        if spec.name not in ("semseg", "depth", "multitask"):
            parser.error("--tiled is for dense models (semseg/depth/multitask)")
        if not args.images:
            parser.error("--tiled requires --images (records serve fixed-size)")
        if args.w8a8 or args.tta != "none":
            parser.error("--tiled does not compose with --w8a8/--tta "
                         "(qat configs quantize inside tiled_predict already)")
        return _run_tiled(args, cfg, trainer)

    def batches():
        if args.images:
            from cvm_tpu_torch.data.images import read_image_as_jpeg
            from cvm_tpu_torch.data.jpeg import decode_jpeg_batch

            files = sorted(glob.glob(args.images))
            if not files:
                parser.error(f"no files match {args.images!r}")
            for s in range(0, len(files), args.batch_size):
                chunk = files[s:s + args.batch_size]
                jpegs = [read_image_as_jpeg(f)[0] for f in chunk]
                # The last chunk padded to a full batch: only len(chunk)
                # results are reported.
                jpegs += [jpegs[-1]] * (args.batch_size - len(jpegs))
                img, hw = decode_jpeg_batch(jpegs, *pad_hw, device=device)
                yield chunk, {"image": img, "image_hw": hw}
        elif args.records:
            from cvm_tpu_torch.data.loader import RecordLoader
            from cvm_tpu_torch.data.records import RecordDataset

            loader = RecordLoader(RecordDataset([args.records]), args.batch_size, pad_hw,
                                  shuffle=False, loop=False, device=device)
            for i, b in enumerate(loader):
                yield [f"rec{i * args.batch_size + j}" for j in range(args.batch_size)], b
        else:
            parser.error("need --images or --records")

    gen = batches()
    names, first = next(gen)
    if sm is not None:
        return _drive(args, gen, names, first, shard_predict(mesh, sm.predict_batch), rank0)

    import torch

    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    trainer.init_state()
    model = trainer.eval_model(use_ema=getattr(cfg, "ema_decay", 0.0) > 0.0)
    w8a8 = None
    if args.w8a8 and args.model == "dmds":
        parser.error("--w8a8 is not supported for two-frame dmds")
    if args.w8a8:
        from cvm_tpu_torch.infer.quantize import calibrate_activation_scales
        from cvm_tpu_torch.pipeline.preprocess import preprocess_image_batch

        proc, _ = preprocess_image_batch(torch.from_numpy(first["image"]).to(device),
                                         torch.from_numpy(first["image_hw"]).to(device),
                                         cfg.input_hw)
        with torch.no_grad():
            w8a8 = calibrate_activation_scales(model, [proc])
        if rank0:
            print(json.dumps({"w8a8_calibrated_convs": len(w8a8)}), flush=True)
    # The pipeline pads a short batch to its config's batch size: the CLI's.
    pipe = InferencePipeline(cfg.replace(batch_size=args.batch_size), model, device,
                             input_format="rgb", tta=args.tta, w8a8=w8a8, mesh=mesh)
    return _drive(args, gen, names, first,
                  lambda b: {k: v.cpu().numpy() for k, v in pipe(b).items()}, rank0)


def _drive(args, gen, names, first, predict, rank0: bool = True) -> int:
    """The JSONL + ``--visualize`` loop shared by both sources: ``predict``
    maps a batch dict to numpy outputs. Only ``rank0`` prints and draws
    (the other ranks of a group predict their rows alongside)."""
    if args.visualize and rank0:
        os.makedirs(args.visualize, exist_ok=True)

    def handle(names, batch, out):
        for i, name in enumerate(names):
            if i >= batch["image"].shape[0]:
                break
            rec = {"input": os.path.basename(str(name))}
            if "boxes" in out:
                keep = np.asarray(out["scores"][i]) >= args.score_threshold
                rec["boxes"] = np.asarray(out["boxes"][i])[keep].tolist()
                rec["scores"] = np.asarray(out["scores"][i])[keep].tolist()
                rec["classes"] = np.asarray(out["classes"][i])[keep].tolist()
            if "class_map" in out:
                cm = np.asarray(out["class_map"][i])
                rec["class_histogram"] = np.bincount(cm.reshape(-1), minlength=1).tolist()
            if "depth" in out:
                rec["depth_mean"] = float(np.asarray(out["depth"][i]).mean())
            if "centers3d" in out:
                keep = np.asarray(out["scores"][i]) >= args.score_threshold
                rec["centers3d"] = np.asarray(out["centers3d"][i])[keep].tolist()
                rec["dims3d"] = np.asarray(out["dims"][i])[keep].tolist()
                rec["yaw"] = np.asarray(out["yaw"][i])[keep].tolist()
            print(json.dumps(rec), flush=True)
            if args.visualize:
                from cvm_tpu_torch.infer.visualize import render_sample

                vis = {k: np.asarray(v[i]) for k, v in out.items()}
                if "centers3d" in out and "intrinsics" in batch:
                    # 3D wireframes project with the source image's
                    # intrinsics (the drawing is on the source frame).
                    vis["intrinsics"] = np.asarray(batch["intrinsics"][i])
                render_sample(os.path.join(args.visualize, f"{os.path.basename(str(name))}.png"),
                              batch["image"][i], batch["image_hw"][i], vis,
                              args.score_threshold)

    n, n_images, t_total = 0, 0, 0.0
    while True:
        t0 = time.perf_counter()
        out = predict(first)
        t_total += time.perf_counter() - t0
        if rank0:
            handle(names, first, out)
        n += 1
        n_images += min(len(names), first["image"].shape[0])
        if args.max_batches is not None and n >= args.max_batches:
            break
        try:
            names, first = next(gen)
        except StopIteration:
            break
    if rank0:
        print(json.dumps({"model": args.model, "batches": n, "images": n_images,
                          "ms_per_batch_avg": round(t_total / n * 1e3, 3)}),
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
