"""LR-range finder: ``python -m cvm_tpu_torch.cli.lr_find --model centernet
[--device cuda] [--num_steps 200] [--curve_out FILE] [--<config field> V]``.

Mirrors ``cvm_tpu/cli/lr_find.py``: sweeps the learning rate log-linearly
over a short run of a fresh model through the real train step
(``train/lr_find.py``), prints the suggested peak LR as one JSON line, and
with ``--curve_out`` writes the (lr, loss) sweep as JSONL. ``--data`` is
``synthetic`` or ``.cvrec`` glob(s), as in ``cli.train``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True)
    parser.add_argument("--data", default="synthetic",
                        help="'synthetic' or .cvrec glob(s), as cli.train")
    parser.add_argument("--num_steps", type=int, default=200)
    parser.add_argument("--lr_min", type=float, default=1e-6)
    parser.add_argument("--lr_max", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pad_hw", default=None)
    parser.add_argument("--curve_out", default=None,
                        help="write the (lr, loss) sweep as JSONL here")
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    args, overrides = parser.parse_known_args(argv)

    from cvm_tpu_torch.models.registry import get_model
    from cvm_tpu_torch.train.lr_find import run_lr_finder
    from cvm_tpu_torch.utils.config import parse_hw

    try:
        spec = get_model(args.model)
    except KeyError as e:
        parser.error(str(e))
    cfg = spec.params_cls.from_cli(overrides)
    pad_hw = (parse_hw(args.pad_hw, "--pad_hw") if args.pad_hw
              else (int(cfg.input_hw[0] * 1.5), int(cfg.input_hw[1] * 1.5)))
    nc = getattr(cfg, "num_classes", getattr(cfg, "num_det_classes", 3))
    if args.data == "synthetic":
        from cvm_tpu_torch.data.synthetic import SyntheticIterator

        it = SyntheticIterator(args.seed, cfg.batch_size, pad_hw, num_classes=min(nc, 10),
                               two_frame=args.model == "dmds",
                               with_3d=bool(getattr(cfg, "with_3d", False)))
    else:
        from cvm_tpu_torch.data.loader import RecordLoader
        from cvm_tpu_torch.data.records import RecordDataset

        ds = RecordDataset([p for p in args.data.split(",") if p])
        it = iter(RecordLoader(ds, cfg.batch_size, pad_hw, ids=ds.split_ids()[0],
                               max_objects=getattr(cfg, "max_objects", 128), seed=args.seed,
                               device=args.device))
    try:
        res = run_lr_finder(cfg, it, args.device, num_steps=args.num_steps,
                            lr_min=args.lr_min, lr_max=args.lr_max, seed=args.seed)
    finally:
        if hasattr(it, "close"):
            it.close()  # a record loader's worker thread
    curve = res.pop("curve")
    if args.curve_out:
        with open(args.curve_out, "w") as f:
            for lr, loss in zip(curve["lr"], curve["loss"]):
                f.write(json.dumps({"lr": lr, "loss": loss}) + "\n")
        print(f"[cvm_tpu_torch] wrote {len(curve['lr'])} sweep points to {args.curve_out}",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
