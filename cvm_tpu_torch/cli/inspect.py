"""Dataset inspection CLI: render ground truth straight from ``.cvrec`` shards.

``python -m cvm_tpu_torch.cli.inspect --data kitti.cvrec --out viz/ --num 8``

Mirrors ``cvm_tpu/cli/inspect.py`` on ``infer/visualize.py::render_record``
(host only: PIL decodes the image blob, as the reference's does). The
reference's docstring follows.

The reference's upload-verification workflow (pull a sample from MongoDB and
visualize the labels to debug an upload script, SURVEY.md §4) becomes a
standalone tool over the packed store: no model, no device — just decode the
image blob and draw boxes / 3D wireframes / mask / depth GT as stored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_class_names(paths):
    for p in paths:
        mp = p + ".meta.json"
        if os.path.exists(mp):
            try:
                with open(mp) as f:
                    names = json.load(f).get("classes")
                if names:
                    return names
            except (OSError, ValueError):
                pass
    return None


def main(argv=None):
    from cvm_tpu_torch.data.records import RecordDataset
    from cvm_tpu_torch.infer.visualize import render_record

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", required=True, nargs="+", help=".cvrec shard(s)")
    parser.add_argument("--out", required=True, help="output dir for PNGs")
    parser.add_argument("--indices", default=None,
                        help="comma-separated record indices (default: first --num)")
    parser.add_argument("--num", type=int, default=8,
                        help="how many records when --indices is not given")
    parser.add_argument("--t1", action="store_true",
                        help="also render the second frame of two-frame records")
    args = parser.parse_args(argv)

    ds = RecordDataset(args.data)
    if args.indices:
        idxs = [int(s) for s in args.indices.split(",") if s.strip()]
    else:
        idxs = list(range(min(args.num, len(ds))))
    names = _load_class_names(args.data)
    os.makedirs(args.out, exist_ok=True)

    rendered = 0
    for i in idxs:
        if not 0 <= i < len(ds):
            print(f"index {i} out of range (dataset has {len(ds)} records)",
                  file=sys.stderr)
            continue
        meta, blobs = ds.get(i)
        sid = str(meta.get("id", i)).replace("/", "_")
        out_path = os.path.join(args.out, f"{i:06d}_{sid}.png")
        render_record(out_path, meta, blobs, class_names=names)
        if args.t1:
            t1_blobs = None
            if "jpeg_t1" in blobs:
                t1_blobs = {"jpeg": blobs["jpeg_t1"]}
            elif "y_t1" in blobs:
                t1_blobs = {"y": blobs["y_t1"], "u": blobs["u_t1"],
                            "v": blobs["v_t1"]}
            if t1_blobs is not None:
                render_record(os.path.join(args.out, f"{i:06d}_{sid}_t1.png"),
                              {"id": meta.get("id")}, t1_blobs)
        summary = {
            "index": i,
            "id": meta.get("id"),
            "hw": [meta.get("height"), meta.get("width")],
            "num_boxes": len(meta.get("boxes", [])),
            "blobs": sorted(blobs),
            "png": out_path,
        }
        print(json.dumps(summary))
        rendered += 1
    print(json.dumps({"rendered": rendered, "records": len(ds),
                      "classes": len(names) if names else None}))
    return 0 if rendered else 1


if __name__ == "__main__":
    sys.exit(main())
