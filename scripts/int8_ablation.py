#!/usr/bin/env python3
"""Where a CenterNet checkpoint loses mAP under W8A8: postures with the
heads' convs left in fp, and the activation ranges of each conv.

    python3 scripts/int8_ablation.py --checkpoint_dir D [--batch_size 16]
        [--batches 12] [--pad_hw 512,512] [--device cuda]

Scores, on ``cli.evaluate``'s held-out scenes, the checkpoint in fp, in
dynamic ``w8a8`` and in calibrated ``w8a8_static`` (``cli.export``'s
calibration at ``--batch_size``), each also with the heads' convs (``hm``,
``off``, ``size``: their 3x3 ``c1`` and 1x1 ``out``) left in fp and with
only each head's ``out`` left in fp; prints one JSON line per posture
(mAP, mAP50, mAP75). mAP50 and mAP75 near fp with a lower mAP means the
boxes lost precision at IoU 0.8-0.95, where the size and offset heads set
it. Then, per conv, on the first eval batch: the calibrated range (127 *
sx), the batch's 99.9th percentile and max of |x|, the share of inputs the
static scale clips, and the dynamic step max / 127 over the calibrated one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

HEADS = ("hm", "off", "size")


def main(argv=None) -> int:
    import numpy as np
    import torch

    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.models.layers import Conv
    from cvm_tpu_torch.pipeline.preprocess import preprocess_image_batch
    from cvm_tpu_torch.train.checkpoints import load_params_cfg
    from cvm_tpu_torch.train.evaluate import evaluate_model
    from cvm_tpu_torch.train.loop import Trainer
    from cvm_tpu_torch.utils.config import parse_hw

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--batches", type=int, default=12)
    p.add_argument("--pad_hw", default="512,512")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    pad = parse_hw(args.pad_hw, "--pad_hw")
    cfg = load_params_cfg(args.checkpoint_dir, CenternetParams)
    cfg = cfg.replace(batch_size=args.batch_size)
    trainer = Trainer(cfg, args.device, checkpoint_dir=args.checkpoint_dir)
    trainer.init_state()
    dev = trainer.device
    model = trainer.eval_model(use_ema=cfg.ema_decay > 0.0)
    scales = calibration_scales(cfg, model, pad, 3, args.batch_size, dev)
    rng = np.random.default_rng(999)
    val = [synthetic_batch(rng, cfg.batch_size, pad, num_classes=min(cfg.num_classes, 10))
           for _ in range(args.batches)]

    def head_convs(outs_only):
        return [n for n, m in model.named_modules() if isinstance(m, Conv)
                and n.split(".")[0] in HEADS and (not outs_only or n.endswith(".out"))]

    def dynamic_except(names):
        pipe = InferencePipeline(cfg, model, dev, input_format="rgb", w8a8=True)
        fp = dict(model.named_modules())
        for n in names:  # put the fp conv back
            parent, _, child = n.rpartition(".")
            setattr(pipe.model.get_submodule(parent), child, fp[n])
        return pipe

    # A qat checkpoint's "fp" posture serves its fake-quant convs (InferencePipeline).
    postures = {"fp": lambda: InferencePipeline(cfg, model, dev, input_format="rgb")}
    for tag, names in (("", []), (" heads fp", head_convs(False)),
                       (" head outs fp", head_convs(True))):
        postures[f"w8a8{tag}"] = lambda names=names: dynamic_except(names)
        postures[f"w8a8_static{tag}"] = lambda names=names: InferencePipeline(
            cfg, model, dev, input_format="rgb",
            w8a8={k: v for k, v in scales.items() if k not in names})
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for name, make in postures.items():
        m = evaluate_model("centernet", cfg, None, val, device=dev, predict_fn=make())
        print(json.dumps({"checkpoint": args.checkpoint_dir, "batch_size": args.batch_size,
                          "posture": name, "card": card,
                          **{k: m[k] for k in ("mAP", "mAP50", "mAP75")}}), flush=True)

    # Per conv, on the first eval batch: the ranges the two scalings use.
    stats = {}

    def hook(n):
        def pre(mod, a):
            x = a[0].detach().float().abs()
            flat = x.flatten()
            k = max(1, int(flat.numel() * 0.001))
            stats[n] = dict(p999=float(flat.topk(k).values[-1]), max=float(flat.max()),
                            clipped=float((x > 127.0 * scales[n]).float().mean()))
        return pre

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, Conv)]
    with torch.no_grad():
        b = val[0]
        proc, _ = preprocess_image_batch(torch.from_numpy(b["image"]).to(dev),
                                         torch.from_numpy(b["image_hw"]).to(dev), cfg.input_hw,
                                         out_dtype=torch.bfloat16)
        model(proc)
    for h in handles:
        h.remove()
    for n, st in stats.items():
        rng_s = 127.0 * scales[n]
        print(json.dumps({"conv": n, "calibrated_range": rng_s, "p99.9": st["p999"],
                          "max": st["max"], "clipped_share": st["clipped"],
                          "dynamic_step_over_static": st["max"] / rng_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
