#!/usr/bin/env python3
"""Device time of the fused W8A8 ConvBN kernel at config B's 24 calls.

    python3 scripts/time_fused_qconv.py [--root DIR] [--label NAME]

Times ``cvm_tpu_torch.ops.cuda.fused_qconv.fused_qconv`` of the checkout at
``DIR`` (default: this one) with ``chip_smoke.py``'s shapes, inputs and
timing (CUDA events around 20 back-to-back calls behind a card sleep, so
the host's launch overhead is not counted), and prints one line per call
and the 24-call sum, beside the card's name and power limit. Pointing
``--root`` at an unpacked older commit compares two kernels on one card.
Needs a CUDA card; builds the kernel from ``DIR``'s sources.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose kernel is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    # This checkout's shapes and timing, whatever the checkout timed.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    if not torch.cuda.is_available():
        print("time_fused_qconv: no CUDA device", file=sys.stderr)
        return 1
    if not fq.__file__.startswith(root):
        raise RuntimeError(f"imported {fq.__file__}, not the kernel under {root}")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    label = args.label or root
    total = 0.0
    for name, h, w, cin, cout, xk, ok, act, n in cs.MAIN_CALLS:
        call_args, kw = cs.kernel_case(dev, gen, 3, cs.B, h, w, cin, cout, act, xk, ok)
        if hasattr(fq, "pack_qconv_weights"):  # packed once, as the modules do
            kw["w_packed"] = fq.pack_qconv_weights(call_args[1])
        t = cs.cuda_ms(lambda: fq.fused_qconv(*call_args, **kw))
        total += n * t
        print(f"[{label}] {name:8s} {h}x{w} {cin}->{cout} {xk}->{ok} x{n}: {t:.4f} ms", flush=True)
    print(f"[{label}] one config-B int8 forward's 24 calls: {total:.4f} ms on {cs.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
