"""Video inference: ``python -m cvm_tpu_torch.cli.video (--model NAME
--checkpoint_dir D | --artifact DIR) --video IN [--out OUT.mp4] [--jsonl
OUT.jsonl] [--device cuda]``.

Mirrors ``cvm_tpu/cli/video.py`` (``read_frames``, ``_pad_batch``,
``run_video``, ``main``): the clip's frames (every ``--stride``-th, at
most ``--max_frames``, the long side cut to ``--resize_long`` on the
host) go in batches through the model (an fp ``InferencePipeline`` of the
checkpoint, or an exported RGB artifact's ``predict_batch``: a
``w8a8_fused`` one runs kernel K2 inside its program), and each frame's
predictions go to a JSONL line (``infer/server.py::result_record`` plus
the frame index, and DMDS's ego-motion) and, drawn on the frame
(``infer/visualize.py::render_sample``), to an annotated mp4. DMDS is fed
consecutive frame pairs (t, t + stride). Video decode and encode need
OpenCV (``cv2``), as the reference's do; ``cli.doctor`` says whether it
imports.

Over every visible card by default, one process per card, as
``cli.train`` runs (``--num_processes N`` for N local ranks; ``--coordinator
HOST:PORT --num_processes N --process_id R`` for a group started by hand;
one card or ``--device cpu`` is one process): every rank reads
the clip and predicts its rows of each batch (``InferencePipeline(mesh=)``,
or ``shard_predict`` of its own artifact's ``predict_batch``), as the
reference shards its pipeline over the mesh; rank 0 alone writes the mp4
and the JSONL.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


def _require_cv2():
    try:
        import cv2

        return cv2
    except ImportError:
        raise SystemExit("cli.video needs OpenCV for video decode/encode "
                         "(pip install opencv-python); single images run via cli.infer")


def read_frames(path: str, stride: int = 1, max_frames: Optional[int] = None,
                resize_long: Optional[int] = None, pairs: bool = False,
                ) -> Tuple[float, Iterator[Tuple]]:
    """(fps, iterator of (frame_index, rgb_frame[, rgb_frame_next])).

    ``pairs`` yields consecutive-frame tuples for two-frame models: (t,
    t + stride), so the motion baseline follows the sampling stride."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video {path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0

    def _prep(bgr: np.ndarray) -> np.ndarray:
        rgb = bgr[..., ::-1]
        if resize_long and max(rgb.shape[:2]) > resize_long:
            h, w = rgb.shape[:2]
            s = resize_long / max(h, w)
            rgb = cv2.resize(rgb, (max(int(round(w * s)), 1), max(int(round(h * s)), 1)),
                             interpolation=cv2.INTER_AREA)
        return np.ascontiguousarray(rgb, dtype=np.uint8)

    def gen():
        emitted = 0
        idx = -1
        prev: Optional[Tuple[int, np.ndarray]] = None
        try:
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                idx += 1
                if idx % stride:
                    continue
                if max_frames is not None and emitted >= max_frames:
                    break
                frame = _prep(bgr)
                if not pairs:
                    emitted += 1
                    yield idx, frame
                    continue
                if prev is not None:
                    emitted += 1
                    yield prev[0], prev[1], frame
                prev = (idx, frame)
        finally:
            cap.release()

    return float(fps), gen()


def _pad_batch(frames: List[np.ndarray], pad_hw: Tuple[int, int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack frames into one (B, Hm, Wm, 3) canvas and their valid sizes."""
    img = np.zeros((len(frames), *pad_hw, 3), np.uint8)
    hw = np.zeros((len(frames), 2), np.int32)
    for i, f in enumerate(frames):
        h, w = f.shape[:2]
        img[i, :h, :w] = f
        hw[i] = (h, w)
    return img, hw


def run_video(predict: Callable[[Dict[str, Any]], Dict[str, Any]], frames: Iterator[Tuple],
              batch_size: int, pad_hw: Tuple[int, int], fps: float, out_path: Optional[str],
              jsonl_path: Optional[str], score_threshold: float = 0.3,
              two_frame: bool = False, class_names=None) -> int:
    """Batch frames -> ``predict`` -> JSONL lines and annotated frames;
    returns the frames processed. ``predict`` maps a batch {"image",
    "image_hw"[, "image_t1"]} of numpy arrays (a short last batch padded
    by repeating rows) to numpy outputs."""
    from cvm_tpu_torch.infer.server import result_record
    from cvm_tpu_torch.infer.visualize import render_sample
    from cvm_tpu_torch.utils.batch import pad_rows

    writer = None
    jsonl = open(jsonl_path, "w") if jsonl_path else None
    n_out = 0
    try:
        pending: List[Tuple] = []

        def flush():
            nonlocal writer, n_out
            if not pending:
                return
            imgs, hw = _pad_batch([p[1] for p in pending], pad_hw)
            batch = dict(zip(("image", "image_hw"), pad_rows((imgs, hw), batch_size)))
            if two_frame:
                t1, _ = _pad_batch([p[2] for p in pending], pad_hw)
                (batch["image_t1"],) = pad_rows((t1,), batch_size)
            out = {k: np.asarray(v) for k, v in predict(batch).items()}
            for i, item in enumerate(pending):
                rec = result_record(out, i, score_threshold)
                rec["frame"] = int(item[0])
                if "rotation" in out:  # dmds ego-motion (t -> t + stride)
                    rec["rotation"] = np.round(out["rotation"][i], 5).tolist()
                    rec["translation"] = np.round(out["translation"][i], 5).tolist()
                if jsonl:
                    jsonl.write(json.dumps(rec) + "\n")
                if out_path:
                    vis = {k: v[i] for k, v in out.items()
                           if k not in ("rotation", "translation")}
                    rendered = render_sample(None, imgs[i], hw[i], vis, score_threshold,
                                             class_names=class_names)
                    if writer is None:
                        cv2 = _require_cv2()
                        h, w = rendered.shape[:2]
                        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                                 fps, (w, h))
                        if not writer.isOpened():
                            raise SystemExit(f"cannot open video writer for {out_path!r}")
                    writer.write(np.ascontiguousarray(rendered[..., ::-1]))
                n_out += 1
            pending.clear()

        for item in frames:
            pending.append(item)
            if len(pending) == batch_size:
                flush()
        flush()
    finally:
        if writer is not None:
            writer.release()
        if jsonl:
            jsonl.close()
    return n_out


def artifact_predict(model, art_hw: Tuple[int, int], two_frame: bool = False):
    """``run_video``'s ``predict`` for an exported artifact (a
    ``ServingModel``): each frame onto the artifact's fixed ``art_hw``
    canvas, then ``predict_batch`` (argument order, 3D intrinsics, partial
    batches, output trim)."""

    def predict(batch):
        h = np.minimum(batch["image_hw"], np.asarray(art_hw, np.int32))
        d = {"image_hw": h}
        for k in ("image", "image_t1") if two_frame else ("image",):
            canvas = np.zeros((batch[k].shape[0], *art_hw, 3), np.uint8)
            for i in range(canvas.shape[0]):
                canvas[i, :h[i, 0], :h[i, 1]] = batch[k][i, :h[i, 0], :h[i, 1]]
            d[k] = canvas
        return model.predict_batch(d)

    return predict


def main(argv=None) -> int:
    from cvm_tpu_torch.parallel.mesh import (add_process_args, launch_local, process_count,
                                             process_mesh)

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default=None, help="zoo model name (with --checkpoint_dir)")
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--artifact", default=None,
                        help="run an EXPORTED artifact dir instead of a checkpoint (rgb "
                             "artifacts; the deployment-side visual check)")
    parser.add_argument("--video", required=True, help="input video file")
    parser.add_argument("--out", default=None, help="annotated output video")
    parser.add_argument("--jsonl", default=None, help="per-frame prediction records")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--stride", type=int, default=1, help="process every Nth frame")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--resize_long", type=int, default=None,
                        help="host-downscale so the long side is <= N px before the device "
                             "letterbox (cuts transfer)")
    parser.add_argument("--score_threshold", type=float, default=0.3)
    parser.add_argument("--tta", default="none", choices=("none", "hflip"))
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    add_process_args(parser)
    args = parser.parse_args(argv)
    world = process_count(parser, args)
    if not (args.out or args.jsonl):
        parser.error("need --out and/or --jsonl")
    if args.stride < 1:
        parser.error("--stride must be >= 1")
    if bool(args.artifact) == bool(args.checkpoint_dir):
        parser.error("need exactly one of --checkpoint_dir (with --model) or --artifact")
    if args.checkpoint_dir and not args.model:
        parser.error("--checkpoint_dir requires --model")
    rc = launch_local(args, world, "cvm_tpu_torch.cli.video", argv)
    if rc is not None:
        return rc
    with process_mesh(args, args.device) as (args.device, mesh):
        return _video(parser, args, mesh)


def _video(parser, args, mesh) -> int:
    """``main`` once the arguments are checked (and, with ``--coordinator``,
    the process group formed)."""
    from cvm_tpu_torch.infer.pipeline import shard_predict

    rank0 = mesh is None or mesh.is_rank0
    batch_size = args.batch_size
    cfg = None
    if args.artifact:
        from cvm_tpu_torch.infer.runtime import ServingModel

        model = ServingModel(args.artifact, device=args.device)
        meta = model.meta
        if model.input_format != "rgb":
            parser.error("video serves rgb artifacts (export without --input_format yuv420 "
                         "for clips)")
        if args.tta != "none":
            parser.error("--tta is baked at export time for artifacts")
        two_frame = meta.get("model") == "dmds"
        batch_size = int(meta.get("batch_size", 1))
        art_hw = tuple(meta.get("pad_hw", (0, 0)))

        predict = shard_predict(mesh, artifact_predict(model, art_hw, two_frame))
    else:
        from cvm_tpu_torch.models.registry import get_model
        from cvm_tpu_torch.train.checkpoints import load_params_cfg
        from cvm_tpu_torch.train.loop import Trainer

        spec = get_model(args.model)
        cfg = load_params_cfg(args.checkpoint_dir, spec.params_cls)
        two_frame = spec.name == "dmds"

    fps, frames = read_frames(args.video, args.stride, args.max_frames, args.resize_long,
                              pairs=two_frame)
    # One peek fixes the host canvas: every frame shares the clip's size.
    first = next(frames, None)
    if first is None:
        raise SystemExit("video has no frames (two-frame models need >= 2)")
    pad_hw = tuple(first[1].shape[:2])

    if args.artifact:
        if pad_hw[0] > art_hw[0] or pad_hw[1] > art_hw[1]:
            parser.error(f"clip frames are {pad_hw} but the artifact's static canvas is "
                         f"{art_hw} — use --resize_long {min(art_hw)} (or re-export with a "
                         "bigger pad_hw)")
    else:
        from cvm_tpu_torch.infer.pipeline import InferencePipeline

        trainer = Trainer(cfg, args.device, checkpoint_dir=args.checkpoint_dir)
        trainer.init_state()
        model = trainer.eval_model(use_ema=getattr(cfg, "ema_decay", 0.0) > 0.0)
        pipe = InferencePipeline(cfg.replace(batch_size=batch_size), model, trainer.device,
                                 input_format="rgb", tta=args.tta, mesh=mesh)

        def predict(batch):
            return {k: v.cpu().numpy() for k, v in pipe(batch).items()}

    n = run_video(predict, itertools.chain([first], frames), batch_size, pad_hw,
                  fps / args.stride, args.out if rank0 else None,
                  args.jsonl if rank0 else None, args.score_threshold,
                  two_frame=two_frame, class_names=getattr(cfg, "class_names", None))
    if rank0:
        print(json.dumps({"frames": n, "fps_out": round(fps / args.stride, 3),
                          "out": args.out, "jsonl": args.jsonl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
