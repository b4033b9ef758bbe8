"""Repack a JPEG `.cvrec` into a raw-YUV420 serving shard:
``python -m cvm_tpu_torch.cli.repack --src data.cvrec --out data_yuv.cvrec
[--threads 4] [--device cuda]``.

Mirrors ``cvm_tpu/cli/repack.py`` (``repack_yuv``, ``main``) on
``data/jpeg.py::decode_jpeg_batch_yuv420`` with the decoder of
``--device``: nvJPEG on the card, libjpeg on the CPU, where the planes
are the reference's byte for byte (``tests/test_torch_data_tools.py``).
The reference's docstring follows.

Serving decode is the host bottleneck on small hosts (one core decodes ~14.5
ms/batch vs ~6 ms device time, BENCH_r01); pre-decoding at pack time turns
batch assembly into a pure memcpy blit, so the loader feeds the chip at
device rate. Records keep their meta (labels rescale automatically from the
stored plane extent via the loader's _label_scales) and non-JPEG blobs pass
through. ``--target H,W`` additionally DCT-downscales at repack time so the
shard stores no pixels the model's letterbox would discard.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def repack_yuv(src: str, out: str, target_hw=(0, 0), max_hw=(4096, 4096),
               num_threads: int = 4, device="cuda") -> dict:
    import numpy as np

    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch_yuv420
    from cvm_tpu_torch.data.records import RecordDataset, RecordWriter

    ds = RecordDataset([src])
    n = n_failed = 0
    bytes_in = bytes_out = 0
    with RecordWriter(out) as w:
        for i in range(len(ds)):
            meta, blobs = ds.get(i)
            jpeg = blobs.pop("jpeg", None)
            if jpeg is None:
                w.write(meta, blobs)
                n += 1
                continue
            h = int(meta.get("height", max_hw[0]))
            wd = int(meta.get("width", max_hw[1]))
            mh, mw = min(h + (h % 2), max_hw[0]), min(wd + (wd % 2), max_hw[1])
            Y, U, V, hw = decode_jpeg_batch_yuv420(
                [jpeg], mh, mw, num_threads, target_hw=tuple(target_hw), device=device
            )
            dh, dw = int(hw[0, 0]), int(hw[0, 1])
            if (dh, dw) == (1, 1):
                n_failed += 1
                continue
            dh -= dh % 2
            dw -= dw % 2
            blobs["y"] = np.ascontiguousarray(Y[0, :dh, :dw])
            blobs["u"] = np.ascontiguousarray(U[0, : dh // 2, : dw // 2])
            blobs["v"] = np.ascontiguousarray(V[0, : dh // 2, : dw // 2])
            bytes_in += len(jpeg)
            bytes_out += blobs["y"].nbytes + blobs["u"].nbytes + blobs["v"].nbytes
            jpeg1 = blobs.pop("jpeg_t1", None)
            if jpeg1 is not None:
                # Two-frame records: pre-decode frame t+1 as well so DMDS
                # serving assembly stays a pure blit.
                Y1, U1, V1, hw1 = decode_jpeg_batch_yuv420(
                    [jpeg1], mh, mw, num_threads, target_hw=tuple(target_hw), device=device
                )
                eh, ew = int(hw1[0, 0]), int(hw1[0, 1])
                eh -= eh % 2
                ew -= ew % 2
                if (eh, ew) != (0, 0) and (int(hw1[0, 0]), int(hw1[0, 1])) != (1, 1):
                    blobs["y_t1"] = np.ascontiguousarray(Y1[0, :eh, :ew])
                    blobs["u_t1"] = np.ascontiguousarray(U1[0, : eh // 2, : ew // 2])
                    blobs["v_t1"] = np.ascontiguousarray(V1[0, : eh // 2, : ew // 2])
                    bytes_in += len(jpeg1)
                    bytes_out += (blobs["y_t1"].nbytes + blobs["u_t1"].nbytes
                                  + blobs["v_t1"].nbytes)
            w.write(meta, blobs)
            n += 1
    src_meta = src + ".meta.json"
    if os.path.exists(src_meta):
        with open(src_meta) as f:
            m = json.load(f)
        m["num_records"] = n
        with open(out + ".meta.json", "w") as f:
            json.dump(m, f)
    return {"written": n, "failed": n_failed,
            "jpeg_bytes": bytes_in, "plane_bytes": bytes_out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="input .cvrec (JPEG blobs)")
    ap.add_argument("--out", required=True, help="output .cvrec (y/u/v planes)")
    ap.add_argument("--target", default=None,
                    help="model input 'H,W' for scale-aware repack")
    ap.add_argument("--threads", type=int, default=4, help="decoder threads")
    ap.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu': the decoder")
    args = ap.parse_args(argv)
    target = (0, 0)
    if args.target:
        from cvm_tpu_torch.utils.config import parse_hw

        target = parse_hw(args.target, "--target")
    stats = repack_yuv(args.src, args.out, target_hw=target, num_threads=args.threads,
                       device=args.device)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
