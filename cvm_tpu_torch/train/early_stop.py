"""Early stopping on an eval metric.

The port's copy of ``cvm_tpu/train/early_stop.py::EarlyStopper`` (pure
Python; ``tests/test_torch_vendored.py`` holds it identical to the
original). ``cli.train`` feeds it each ``--eval_every`` evaluation's metric
dict and stops training after ``patience`` consecutive evals without
improvement.
"""

from __future__ import annotations

from typing import Dict, Optional


class EarlyStopper:
    """Signal stop after ``patience`` consecutive non-improving evals.

    ``mode`` is "max" (higher better: mAP, mIoU, delta1) or "min" (loss).
    ``min_delta`` is the smallest change that counts as an improvement —
    guards against stopping decisions made on float noise.
    """

    def __init__(self, metric: str, patience: int, mode: str = "max",
                 min_delta: float = 0.0):
        if patience <= 0:
            raise ValueError(f"patience must be positive, got {patience}")
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.metric = metric
        self.patience = patience
        self.mode = mode
        self.min_delta = float(min_delta)
        self.best: Optional[float] = None
        self.stale = 0

    def update(self, metrics: Dict[str, float]) -> bool:
        """Record one eval; return True when training should stop."""
        if self.metric not in metrics:
            # Metric absent (e.g. eval produced no detections yet): neither
            # improvement nor stagnation evidence — don't burn patience.
            return False
        v = float(metrics[self.metric])
        if self.best is None:
            self.best = v
            return False
        improved = (v > self.best + self.min_delta if self.mode == "max"
                    else v < self.best - self.min_delta)
        if improved:
            self.best = v
            self.stale = 0
            return False
        self.stale += 1
        return self.stale >= self.patience
