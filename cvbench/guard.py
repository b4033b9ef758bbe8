"""The guard against JAX in the benchmark's process: the top-level names of
loaded modules, compared whole (``cvm_tpu_torch`` is not ``cvm_tpu``)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "cvm_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def assert_clean(where: str) -> None:
    """Raise SystemExit(3), naming what was found, when a forbidden module
    is loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"cvbench: {bad} loaded by the end of {where}; neither the benchmark nor "
              "the program may load JAX or the JAX package", file=sys.stderr, flush=True)
        raise SystemExit(3)
