"""Metrics writers; mirrors ``cvm_tpu/train/metrics.py``
(``JsonlMetricsWriter``, ``MultiWriter``, ``MlflowAdapter``). The
TensorBoard writer is ``train/tensorboard.py``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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


class MultiWriter:
    """Fans one metrics stream out to several writers (JSONL, TensorBoard,
    MLflow); images go to those that take them."""

    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        for w in self.writers:
            w.write(step, metrics)

    def write_image(self, step: int, tag: str, rgb) -> None:
        for w in self.writers:
            if hasattr(w, "write_image"):  # TensorBoard only
                w.write_image(step, tag, rgb)

    def close(self) -> None:
        for w in self.writers:
            w.close()


class MlflowAdapter:
    """MLflow bridge, imported when constructed: without the ``mlflow``
    package it writes nothing, as the reference's does."""

    def __init__(self, experiment: str, run_name: Optional[str] = None,
                 params: Optional[dict] = None):
        try:
            import mlflow  # type: ignore
        except ImportError:
            self._mlflow = None
            return
        self._mlflow = mlflow
        mlflow.set_experiment(experiment)
        mlflow.start_run(run_name=run_name)
        if params:
            mlflow.log_params(params)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if self._mlflow is not None:
            self._mlflow.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def close(self) -> None:
        if self._mlflow is not None:
            self._mlflow.end_run()
