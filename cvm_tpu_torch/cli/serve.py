"""Serve an exported artifact: ``python -m cvm_tpu_torch.cli.serve --artifact
ART (--records GLOB | --images GLOB | --http HOST:PORT | --selftest)
[--device cuda]``.

Mirrors ``cvm_tpu/cli/serve.py::main``. The artifact is loaded as a server
loads it (``infer/runtime.py::ServingModel``, none of the model-zoo code):

* ``--selftest`` runs it on the inputs of its export-time fingerprint and
  exits 3 when the outputs have drifted from it (a weights file from
  another run, a tampered or truncated copy); alone, it exits 0 when they
  match, else serving follows;
* ``--records`` streams ``.cvrec`` shards through it (``RecordLoader``, in
  the artifact's input format, the last batch padded), ``--images`` a glob
  of image files (JPEGs as they are, other formats re-encoded, which needs
  PIL; the last chunk padded by repeating its last file): one JSON line
  per image on stdout (``infer/server.py::result_record``), a summary on
  stderr; a 3D artifact gets the records' intrinsics, or placeholder ones
  for bare images;
* ``--http`` serves it as a daemon (``infer/server.py::ModelServer``:
  ``POST /predict``, ``/healthz``, ``/stats``, ``/metrics``) with dynamic
  batching onto the artifact's buckets (``--max_wait_ms``).

Images are decoded by the decoder of ``--device`` (``data/jpeg.py``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

_PLACEHOLDER_INTRINSICS = np.asarray([[1.0, 1.0, 0.0, 0.0]], np.float32)


def parse_http(parser, text: str):
    """``HOST:PORT`` (``[::1]:8000`` accepted; an empty host is 127.0.0.1)."""
    host, sep, port_s = text.rpartition(":")
    if not sep or not port_s.isdigit():
        parser.error(f"--http expects HOST:PORT, got {text!r}")
    return host.strip("[]") or "127.0.0.1", int(port_s)


def _batches(args, parser, model):
    """(names, batch-first arrays in the artifact's argument order), each
    batch padded to the artifact's batch size."""
    from cvm_tpu_torch.utils.batch import pad_rows

    B = int(model.meta.get("batch_size", 1))
    pad_hw = tuple(model.meta.get("pad_hw", (0, 0)))
    with_3d = "intrinsics" in model.keys
    if args.images:
        from cvm_tpu_torch.data.images import read_image_as_jpeg
        from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420

        files = sorted(glob.glob(args.images))
        for s in range(0, len(files), B):
            chunk = files[s:s + B]
            jpegs = [read_image_as_jpeg(f)[0] for f in chunk]
            jpegs += [jpegs[-1]] * (B - len(jpegs))
            if model.input_format == "yuv420":
                data = decode_jpeg_batch_yuv420(jpegs, *pad_hw, device=model.device)
            else:
                data = decode_jpeg_batch(jpegs, *pad_hw, device=model.device)
            if with_3d:
                # no camera metadata in bare image files: 3D geometry is
                # meaningless without K, the placeholder keeps it well formed
                data = data + (np.tile(_PLACEHOLDER_INTRINSICS, (B, 1)),)
            yield chunk, data
    elif args.records:
        from cvm_tpu_torch.data.loader import RecordLoader
        from cvm_tpu_torch.data.records import RecordDataset

        loader = RecordLoader(RecordDataset([args.records]), B, pad_hw, shuffle=False,
                              loop=False, output_format=model.input_format,
                              drop_remainder=False, device=model.device)
        seen = 0
        for b in loader:
            n = b["image_hw"].shape[0]
            names = [f"rec{seen + j}" for j in range(n)]
            seen += n
            if with_3d and "intrinsics" not in b:
                b = dict(b, intrinsics=np.tile(_PLACEHOLDER_INTRINSICS, (n, 1)))
            dtypes = {"image_hw": np.int32, "intrinsics": np.float32}
            data = [np.asarray(b[k], dtypes.get(k, np.uint8)) for k in model.keys]
            yield names, tuple(pad_rows(data, B))
    else:
        parser.error("need --images, --records, --http or --selftest")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--artifact", required=True, help="cli.export output directory")
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    parser.add_argument("--images", default=None, help="glob of image files")
    parser.add_argument("--records", default=None, help=".cvrec glob")
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--score_threshold", type=float, default=0.3)
    parser.add_argument("--http", default=None, metavar="HOST:PORT",
                        help="serve the artifact as an HTTP daemon (POST /predict with "
                             "image bytes; dynamic batching onto the artifact's buckets; "
                             "/healthz, /stats, Prometheus /metrics)")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="dynamic-batching window: a partial batch dispatches after "
                             "this long (HTTP mode)")
    parser.add_argument("--selftest", action="store_true",
                        help="verify the artifact against its export-time fingerprint "
                             "first (exit 3 on mismatch)")
    args = parser.parse_args(argv)
    address = parse_http(parser, args.http) if args.http else None

    from cvm_tpu_torch.infer.runtime import ServingModel

    model = ServingModel(args.artifact, device=args.device)
    if args.selftest:
        problems = model.selftest()
        if problems:
            for p in problems:
                print(f"[selftest] MISMATCH: {p}", file=sys.stderr)
            return 3
        print("[selftest] artifact verified against its export fingerprint", file=sys.stderr,
              flush=True)
        if not (args.http or args.images or args.records):
            return 0

    if address is not None:
        from cvm_tpu_torch.infer.server import server_for_artifact

        server = server_for_artifact(model, max_wait_ms=args.max_wait_ms,
                                     score_threshold=args.score_threshold)
        print(f"[cvm_tpu_torch] serving {args.artifact} on http://{args.http} (POST "
              "/predict, GET /healthz, GET /stats, GET /metrics)", file=sys.stderr, flush=True)
        server.serve_forever(*address)
        return 0

    from cvm_tpu_torch.infer.server import result_record

    n_batches = n_images = 0
    t_total = 0.0
    for names, data in _batches(args, parser, model):
        if args.max_batches is not None and n_batches >= args.max_batches:
            break
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in model(*data).items()}
        t_total += time.perf_counter() - t0
        n_batches += 1
        for i, name in enumerate(names):
            rec = {"input": os.path.basename(str(name)),
                   **result_record(out, i, args.score_threshold)}
            print(json.dumps(rec), flush=True)
            n_images += 1
    if n_batches:
        print(json.dumps({"model": model.meta.get("model", "?"),
                          "input_format": model.input_format, "batches": n_batches,
                          "images": n_images,
                          "ms_per_batch_avg": round(t_total / n_batches * 1e3, 2)}),
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
