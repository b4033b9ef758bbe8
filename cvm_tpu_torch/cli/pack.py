"""Dataset packing: ``python -m cvm_tpu_torch.cli.pack --dataset coco --src
ROOT --out shard.cvrec [--split S] [--max_images N] [--depth_dir D]``.

Mirrors ``cvm_tpu/cli/pack.py::main``: one entry point over the adapter
registry (``data/adapters/__init__.py::ADAPTERS``), the reference's
per-dataset Mongo upload scripts (SURVEY.md §3.3). It runs on the host
only (JSON, PIL and the record writer) and takes no ``--device``. Each
adapter names its ``--split`` keyword its own way (``version`` for the
nuScenes tables), and refuses the flag where it has none; ``kitti_depth``
requires ``--depth_dir``. Prints the adapter's counts as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

# --split's keyword per adapter (None: the adapter takes no split).
_SPLIT_KEYWORD = {"nuimages": "version", "nuscenes": "version", "comma10k": None,
                  "kitti_raw": None}


def main(argv=None) -> int:
    from cvm_tpu_torch.data.adapters import ADAPTERS

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", required=True, choices=sorted(ADAPTERS))
    parser.add_argument("--src", required=True, help="dataset root directory")
    parser.add_argument("--out", required=True, help="output .cvrec path")
    parser.add_argument("--split", default=None)
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--depth_dir", default=None, help="kitti_depth: GT dir")
    args = parser.parse_args(argv)

    fn = ADAPTERS[args.dataset]
    kwargs = {"max_images": args.max_images}
    if args.dataset == "kitti_depth":
        if not args.depth_dir:
            parser.error("kitti_depth requires --depth_dir")
        stats = fn(args.src, args.depth_dir, args.out, **kwargs)
    else:
        if args.split:
            split_kw = _SPLIT_KEYWORD.get(args.dataset, "split")
            if split_kw is None:
                parser.error(f"--split is not supported for {args.dataset}")
            kwargs[split_kw] = args.split
        stats = fn(args.src, args.out, **kwargs)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
