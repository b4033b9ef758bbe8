#!/usr/bin/env python3
"""Where one block of the fused W8A8 ConvBN kernel spends its time.

    python3 scripts/trace_fused_qconv.py [--without quantize|copies]

Builds an instrumented copy of ``cvm_tpu_torch/csrc/fused_qconv.cu`` (under
``build/trace_fused_qconv/``; the checkout's source is not touched) that
writes ``clock64()`` stamps of block 0 to a device buffer: when the
consumers' wait for each ring item ends, when its wgmma products are done,
when each tile's epilogue starts and ends, and when the producers start and
finish each item. Runs it at three config-B calls and prints, in SM
cycles: the mean producer period per item, the mean wgmma time per item,
and the mean epilogue time per tile. Needs a CUDA card. The stamps are
placed by matching lines of the kernel source: if the source changes
shape, the script stops with the line it could not find. ``--without``
removes one piece of the producers' work for bf16/f32 inputs (the quantize
pass, or the 16-B input copies), to see whether that piece sets the pace;
the results are then wrong, and only the times mean anything.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "trace_fused_qconv")
STAMP = ("if (g_dbg && blockIdx.x == 0 && blockIdx.z == 0 && (threadIdx.x == 0 || "
         "threadIdx.x == NCONS) && (INDEX) < 64) g_dbg[BASE + (INDEX)] = clock64();")
# (line of the source, series base, index): the stamp goes after that line.
# Each series keeps the first 64 items or tiles of block 0.
PROBES = [
    ("  __syncthreads();\n", 0, "0"),                                      # block start
    ("      mbar_wait(bar0 + 8 * s, (it / S) & 1);\n", 64, "it"),            # item ready
    ("      mbar_arrive(bar0 + 8 * (S + s));\n", 128, "it"),                 # products done
    ("    // Epilogue: in registers, then through the staging tile to 16-B stores.\n",
     192, "k"),                                                              # epilogue start
    ("        for (int e = 0; e < nb; ++e) gp[e] = sp[e];\n      }\n    }\n",
     256, "k"),                                                              # epilogue end
    ("      const int j = i - 1, s = j % S;\n", 320, "j"),                   # producer: finish j
    ("      fence_proxy_async();\n      mbar_arrive(bar0 + 8 * s);\n", 384, "j"),  # item j ready
]
# (name, H = W, Cin, Cout, input dtype, output dtype, act): config-B calls
# --without: (source line, replacement) that skips that piece of work.
WITHOUT = {
    "quantize": ("        for (int u = pt; u < G::NU; u += NPROD) {\n          uint32_t w4[4];\n",
                 "        for (int u = pt; u < 0; u += NPROD) {\n          uint32_t w4[4];\n"),
    "copies": ("              cp_async16(smem_u32(rb + u * 16 * esz + p * 16),",
               "              if (a.act < 0) cp_async16(smem_u32(rb + u * 16 * esz + p * 16),"),
}
CALLS = [("up2 c2", 128, 128, 128, "bf16", "bf16", 1), ("stem", 256, 12, 32, "bf16", "bf16", 1),
         ("s4 c2", 32, 256, 256, "int8", "bf16", 0)]


def instrumented_source(without: str = "") -> str:
    src = open(os.path.join(ROOT, "cvm_tpu_torch", "csrc", "fused_qconv.cu")).read()
    if without:
        line, repl = WITHOUT[without]
        if src.count(line) != 1:
            raise SystemExit(f"trace_fused_qconv: line to remove not found once: {line!r}")
        src = src.replace(line, repl)
    src = src.replace("namespace {\n", "namespace {\n__device__ long long* g_dbg = nullptr;\n", 1)
    for line, base, index in PROBES:
        if src.count(line) != 1:
            raise SystemExit(f"trace_fused_qconv: probe line not found once: {line!r}")
        src = src.replace(line, line + STAMP.replace("BASE", str(base)).replace("INDEX", index) + "\n")
    return src + ('\nextern "C" int set_dbg(void* p) { return (int)cudaMemcpyToSymbol('
                  'g_dbg, &p, sizeof(p)); }\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--without", choices=sorted(WITHOUT), default="")
    args = ap.parse_args()
    import torch

    from cvm_tpu_torch.ops.cuda import _build, fused_qconv as fq

    if not torch.cuda.is_available():
        print("trace_fused_qconv: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    tag = args.without or "all"
    cu, so = os.path.join(OUT, f"trace_{tag}.cu"), os.path.join(OUT, f"libtrace_{tag}.so")
    with open(cu, "w") as f:
        f.write(instrumented_source(args.without))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.fused_qconv_launch
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, Fl, I, I, Fl, I, I, I, I, P]
    lib.set_dbg.argtypes = [P]
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dt = {"bf16": torch.bfloat16, "int8": torch.int8}
    kind = {"bf16": 1, "int8": 2}
    buf = torch.zeros(512, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, hw, cin, cout, xin, xout, act in CALLS:
        x = (torch.randn(8, hw, hw, cin, generator=gen, device=dev) * 40).clamp(-127, 127).to(dt[xin])
        wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, device=dev, dtype=torch.int8)
        plan = fq.qconv_plan(3, cin, cout)
        wp = fq.pack_qconv_weights(wq)
        scale = torch.full((cout,), 1e-4, device=dev)
        bias = torch.zeros(cout, device=dev)
        out = torch.empty(8, hw, hw, cout, device=dev, dtype=dt[xout])
        split = fq.cin_split(plan, 8, hw, hw, sms)

        def call():
            err = fn(x.data_ptr(), wp.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), 8, hw, hw, cin, cin, cout, 3, kind[xin],
                     1.0 if xin != "int8" else 0.0, act, kind[xout],
                     1.0 if xout == "int8" else 0.0, plan.bn, int(plan.fold), plan.kf, split,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        for _ in range(3):
            call()
        buf.zero_()
        lib.set_dbg(ctypes.c_void_p(buf.data_ptr()))
        call()
        torch.cuda.synchronize()
        lib.set_dbg(ctypes.c_void_p(0))
        b = buf.cpu().tolist()

        def series(base):
            return [v for v in b[base:base + 64] if v]

        ready, done = series(64), series(128)
        epi0, epi1 = series(192), series(256)
        pstart, pready = series(320), series(384)
        mma = [d - r for r, d in zip(ready, done)]
        epi = [e - s for s, e in zip(epi0, epi1)]
        period = (pready[-1] - pready[0]) / (len(pready) - 1) if len(pready) > 1 else 0.0
        print(f"[trace{' without ' + args.without if args.without else ''}] {name:7s} {plan} split {split}: block 0 ran {len(ready)} items, "
              f"{len(epi)} tiles; producer period {period:.0f} cycles/item; wgmma "
              f"{sum(mma) / len(mma):.0f} cycles/item; epilogue {sum(epi) / len(epi):.0f} "
              f"cycles/tile; block total {max(epi1) - b[0] if epi1 else 0} cycles "
              f"(first producer finish at {pstart[0] - b[0] if pstart else 0})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
