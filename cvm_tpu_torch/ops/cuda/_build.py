"""Build and load the port's native code (ctypes): the hand-written CUDA
kernels (nvcc) and the host JPEG decoder (the host C++ compiler).

Each ``csrc/<name>.cu`` or ``csrc/<name>.cc`` exposes a plain C interface.
It is compiled into ``build/cvm_tpu_torch/lib<name>-<hash>.so`` at the
repository root the first time a caller loads it, and again whenever the
source or the flags change (the hash is taken over both); CUDA sources for
Hopper (``sm_90a``). Nothing here runs at import: the CPU tests import
every module on a machine without ``nvcc``. A build that fails raises with
what is missing (compiler, header or library); nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]           # cvm_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cvm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-shared")


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "cvm_tpu_torch are built from source at first use")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"no C++ compiler: {cxx!r} not found (set CXX): the host JPEG "
                           "decoder of cvm_tpu_torch is built from source at first use")
    return path


def _missing(stderr: str, headers, libs) -> str:
    """What a failed build lacks, by name, from the compiler's message."""
    found = [f"header {h} not found" for h in headers if h in stderr and (
        "No such file" in stderr or "cannot open source file" in stderr)]
    found += [f"library lib{lib} not found" for lib in libs if f"-l{lib}" in stderr]
    return "; ".join(found)


def _build(name: str, src: Path, compiler, flags: tuple, libs: tuple,
           headers: tuple) -> ctypes.CDLL:
    links = tuple(f"-l{lib}" for lib in libs)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags + links).encode())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(tmp), str(src), *links]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            what = _missing(proc.stderr, headers, libs)
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed for {src.name} "
                               f"(rc={proc.returncode}){': ' + what if what else ''}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return ctypes.CDLL(str(so))


@functools.lru_cache(maxsize=None)
def load_library(name: str, libs: tuple = (), headers: tuple = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with nvcc, linked against ``libs`` (e.g.
    ``("nvjpeg",)``), if its build is missing or stale; load it.
    ``headers`` are the third-party headers a failed build is checked
    for, to name what is missing."""
    return _build(name, CSRC / f"{name}.cu", _nvcc, NVCC_FLAGS, libs, headers)


@functools.lru_cache(maxsize=None)
def load_host_library(name: str, libs: tuple = (), headers: tuple = ()) -> ctypes.CDLL:
    """Compile host C++ ``csrc/<name>.cc`` with the host compiler (``$CXX``,
    else ``g++``), linked against ``libs``, if its build is missing or
    stale; load it."""
    return _build(name, CSRC / f"{name}.cc", _cxx, CXX_FLAGS, libs, headers)
