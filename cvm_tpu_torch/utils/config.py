"""Typed per-model config with CLI overrides.

The port's copy of ``cvm_tpu/utils/config.py`` (``parse_hw``,
``BaseParams``): the same field names, defaults, CLI parsing and JSON, so
that a reference ``params.json`` and the port's checkpoints load through
either. ``tensor_parallel`` acts under a model axis of two or more ranks
(``parallel/sharding.py``); on one process it shards nothing, as the
reference's rules shard nothing over a size-1 axis.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple, get_origin


def parse_hw(text: str, flag: str = "size") -> Tuple[int, int]:
    """Parse an 'H,W' CLI value with a clear error at parse time."""
    parts = text.split(",")
    if len(parts) != 2:
        raise SystemExit(f"{flag} expects 'H,W' (two comma-separated ints), "
                         f"got {text!r}")
    try:
        h, w = int(parts[0]), int(parts[1])
    except ValueError:
        raise SystemExit(f"{flag} expects integers 'H,W', got {text!r}")
    if h <= 0 or w <= 0:
        raise SystemExit(f"{flag} must be positive, got {text!r}")
    return (h, w)


@dataclasses.dataclass
class BaseParams:
    name: str = "base"
    # Shard the widest backbone convs over a model axis.
    tensor_parallel: bool = False
    # Exponential moving average of params (0 = off): ema = d*ema + (1-d)*p;
    # eval, checkpoints and export use the EMA weights.
    ema_decay: float = 0.0
    # Accumulate gradients over k micro-batches before an optimizer step.
    grad_accum_steps: int = 1
    # LR schedule: warmup_cosine (default) | constant | step (x0.1 at
    # 60%/85% of total_steps). All keep the linear warmup.
    lr_schedule: str = "warmup_cosine"
    # Optimizer: adamw (default; decoupled weight decay) | sgd (Nesterov
    # momentum 0.9, with decoupled weight decay too).
    optimizer: str = "adamw"
    # Extra photometric augmentation: max gaussian noise sigma as a fraction
    # of 255, and 3x3-blur probability (both 0 = off).
    aug_noise_std: float = 0.0
    aug_blur_prob: float = 0.0
    # Rotation augmentation: max |angle| in degrees (0 = off).
    aug_rotate_deg: float = 0.0
    # Quantization-aware training (fake-quant convs with a straight-through
    # estimator).
    qat: bool = False
    # Space-to-depth stem: a stride-1 conv on (H/2, W/2, 12) instead of a
    # stride-2 conv on RGB (parameter shapes differ; set before init).
    space_to_depth_stem: bool = True
    # Gradient checkpointing of each residual block.
    remat: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BaseParams":
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            t = fields[k].type
            if isinstance(v, list) and (get_origin(t) is tuple or "Tuple" in str(t)):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    def replace(self, **kw) -> "BaseParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_cli(cls, argv: Optional[Sequence[str]] = None) -> "BaseParams":
        """Build from CLI flags: every dataclass field becomes ``--field``."""
        parser = argparse.ArgumentParser(description=cls.__doc__)
        for f in dataclasses.fields(cls):
            t = f.type
            default = getattr(cls, f.name, f.default)
            origin = get_origin(t)
            if t in (int, float, str, "int", "float", "str"):
                typ = {"int": int, "float": float, "str": str}.get(t, t)
                parser.add_argument(f"--{f.name}", type=typ, default=default)
            elif t in (bool, "bool"):
                parser.add_argument(f"--{f.name}",
                                    type=lambda s: s.lower() in ("1", "true", "yes"),
                                    default=default)
            elif origin is tuple or "Tuple" in str(t):
                # Tuple[int, int] flags (input_hw, pad_hw, ...) parse to ints.
                elem = int if "int" in str(t) else float
                parser.add_argument(
                    f"--{f.name}",
                    type=lambda s, elem=elem: tuple(
                        elem(v) for v in (json.loads(s) if s.startswith("[")
                                          else s.split(","))),
                    default=default,
                )
            else:
                parser.add_argument(f"--{f.name}", type=str, default=default)
        ns = parser.parse_args(argv)
        return cls(**vars(ns))
