"""Structured JSONL metrics; mirrors ``cvm_tpu/train/metrics.py``
(``JsonlMetricsWriter``; the TensorBoard and MLflow writers are not ported)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class JsonlMetricsWriter:
    """Appends one ``{"step", "ts", <metric>: float, ...}`` line per write."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
