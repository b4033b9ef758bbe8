"""Explicit device resolution (the port's counterpart of
``cvm_tpu/utils/platform.py``: the platform is chosen by the caller, never
picked silently)."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """Turn ``"cpu"``, ``"cuda"``, ``"cuda:1"`` or a ``torch.device`` into a
    ``torch.device``. Raises when a CUDA device is asked for and absent,
    so work meant for the card never runs on the CPU by accident."""
    if device is None:
        raise ValueError("device is required: pass 'cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch sees no CUDA device")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the port runs on cpu or cuda")
    return dev
