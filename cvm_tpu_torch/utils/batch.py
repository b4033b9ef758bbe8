"""Batch-axis padding for fixed-size serving batches.

The port's copy of ``cvm_tpu/utils/batch.py::pad_rows`` (the port imports
nothing of the JAX package): every serving surface pads a short batch the
same way, by repeating its last row.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def pad_rows(arrays: Sequence, total: int) -> Tuple[np.ndarray, ...]:
    """Pad each batch-first array to ``total`` rows by repeating its last
    row; no-op (beyond np.asarray) when already at ``total``."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        pad = total - a.shape[0]
        if pad < 0:
            raise ValueError(
                f"batch has {a.shape[0]} rows, more than the static "
                f"batch size {total}")
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        out.append(a)
    return tuple(out)
