"""Build and load the port's hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled for
Hopper (``sm_90a``) into ``build/cvm_tpu_torch/lib<name>-<hash>.so`` at the
repository root the first time a wrapper launches it, and again whenever the
source or the flags change (the hash is taken over both). Nothing here runs
at import: the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]           # cvm_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cvm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Seconds each library took to build in this process (0.0 = found built).
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "cvm_tpu_torch are built from source at first use")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing or stale; load it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name} "
                               f"(rc={proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(so))
