"""Host -> device batch feeding; mirrors ``cvm_tpu/data/loader.py::
prefetch_to_device`` (the record loader is not ported)."""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]], device: torch.device,
                       depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the host batches (dicts of numpy arrays) as tensors on
    ``device``, with ``depth`` copies issued ahead of consumption.

    On a CUDA device each array goes through pinned host memory and a
    ``non_blocking`` copy on the current stream, so the copies of the next
    batches overlap the current step; the caching host allocator keeps a
    pinned buffer until its copy has finished. On the CPU the arrays are
    wrapped without a copy.
    """
    buf: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(_to_device(batch, device))
        if len(buf) >= depth:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(_to_device(nxt, device))
        yield out
