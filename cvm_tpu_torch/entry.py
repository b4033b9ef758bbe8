"""The serving program of CenterNet config B, ready to call or time.

Counterpart of ``__graft_entry__.entry()``: planar YUV420 input padded to
768x768, batch 8, 512x512 CenterNet with the ``small`` backbone and the
space-to-depth stem, BN folded, NMS-free decode, boxes mapped back to the
source images. Weights are random, drawn from a seeded ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from cvm_tpu_torch.infer.pipeline import InferencePipeline
from cvm_tpu_torch.models.centernet.model import create_model
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device

PAD_HW = (768, 768)


def entry(device: DeviceLike, seed: int = 0) -> Tuple[Callable, tuple]:
    """``(fn, args)``: ``fn(*args)`` returns (boxes (8, 100, 4), scores
    (8, 100), classes (8, 100)) as device tensors."""
    dev = resolve_device(device)
    cfg = CenternetParams()  # config B: 512x512, small, stride 4, 80 classes, b8
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    pipe = InferencePipeline(cfg, model, dev, fold_bn=True)

    rng = np.random.default_rng(seed)
    B, (ph, pw) = cfg.batch_size, PAD_HW
    y = rng.integers(0, 255, (B, ph, pw), dtype=np.uint8)
    u = rng.integers(0, 255, (B, ph // 2, pw // 2), dtype=np.uint8)
    v = rng.integers(0, 255, (B, ph // 2, pw // 2), dtype=np.uint8)
    image_hw = rng.integers(360, 768, (B, 2)).astype(np.int32)
    args = tuple(torch.from_numpy(a).to(dev) for a in (y, u, v, image_hw))

    def fn(y, u, v, image_hw):
        out = pipe.predict(y, u, v, image_hw)
        return out["boxes"], out["scores"], out["classes"]

    return fn, args
