"""The serving program of CenterNet config B, ready to call or time, and
the multi-process dry run.

``entry`` is the counterpart of ``__graft_entry__.entry()``: planar YUV420
input padded to 768x768, batch 8, 512x512 CenterNet with the ``small``
backbone and the space-to-depth stem, BN folded, NMS-free decode, boxes
mapped back to the source images. Weights are random, drawn from a seeded
``torch.Generator``.

``dryrun_multichip(n, device)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: one training step of the tiny
flagship over n processes (gloo ranks, on the CPU or sharing the card),
with the reference's choices (a model axis of 2 and tensor parallelism
when n >= 4 is even, the EMA and two-step gradient accumulation), then the
serving leg sharded over the same mesh, as the reference's: each data rank
decodes its rows, the stage-5 convs stay split over the model axis
(``InferencePipeline(mesh=)``).
"""

from __future__ import annotations

import os
import sys
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


def dryrun_multichip(n_devices: int, device: DeviceLike, timeout: float = 600.0) -> None:
    """Run one multi-process training step on ``n_devices`` gloo ranks on
    ``device`` ("cpu", or "cuda" for ranks sharing the card) and the
    serving leg, printing rank 0's lines; raises when a rank fails."""
    device = str(resolve_device(device))
    from cvm_tpu_torch.parallel.mesh import launch_ranks

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = launch_ranks(n_devices, lambda r, port: [
        sys.executable, "-c", "from cvm_tpu_torch.entry import _dryrun_rank; "
        f"_dryrun_rank({r}, {n_devices}, {port}, {device!r})"], timeout, cwd=repo)
    sys.stdout.write(outs[0])


def _dryrun_rank(rank: int, n: int, port: int, device: str) -> None:
    """One rank of ``dryrun_multichip``."""
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown_distributed
    from cvm_tpu_torch.train.loop import Trainer

    if device == "cpu":
        torch.set_num_threads(1)
    model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    cfg = CenternetParams(input_hw=(64, 64), num_classes=3, max_objects=8, backbone="tiny",
                          neck_features=32, head_features=16, batch_size=n, warmup_steps=2,
                          total_steps=100, ema_decay=0.99, grad_accum_steps=2,
                          tensor_parallel=model_axis > 1)
    dev = init_distributed(f"127.0.0.1:{port}", n, rank, device, backend="gloo")
    try:
        mesh = make_mesh(model_axis, dev)
        trainer = Trainer(cfg, dev, mesh=mesh, log_every=1)
        trainer.init_state()
        rows = mesh.batch_rows(cfg.batch_size)
        batch = synthetic_batch(np.random.default_rng(0), cfg.batch_size, (96, 96),
                                num_classes=3, max_objects=8)
        m = trainer.fit(iter([{k: v[rows.start:rows.stop] for k, v in batch.items()}]), 1)
        loss = m["loss"]
        if not np.isfinite(loss) or trainer.state.ema is None:
            raise AssertionError(f"non-finite loss {loss} or no EMA shadow")
        tp = ""
        if trainer.split:
            k = trainer.state.model.backbone.s5b0.c1.conv.weight
            if k.shape[0] * model_axis != 256:
                raise AssertionError(f"TP rule did not shard s5b0.c1: {tuple(k.shape)}")
            tp = f", tp s5b0.c1 kernel {tuple(k.shape)} of (256, 256, 3, 3) on each rank"
        if mesh.is_rank0:
            print(f"[dryrun_multichip] mesh=(data={mesh.data}, model={mesh.model}) over "
                  f"{n} gloo processes step ok, loss={loss:.4f}{tp}, ema+accum on",
                  flush=True)
        # every rank serves its rows; the training model's slices stay split
        pipe = InferencePipeline(cfg, trainer.eval_model(), dev, input_format="yuv420",
                                 mesh=mesh)
        rng = np.random.default_rng(0)
        B, (ph, pw) = cfg.batch_size, (96, 96)
        res = pipe({"y": rng.integers(0, 255, (B, ph, pw), dtype=np.uint8),
                    "u": rng.integers(0, 255, (B, ph // 2, pw // 2), dtype=np.uint8),
                    "v": rng.integers(0, 255, (B, ph // 2, pw // 2), dtype=np.uint8),
                    "image_hw": np.asarray([[ph, pw]] * B, np.int32)})
        if res["boxes"].shape[0] != B or not torch.isfinite(res["scores"]).all():
            raise AssertionError("serving leg: bad boxes or non-finite scores")
        if mesh.is_rank0:
            print(f"[dryrun_multichip] sharded serving ok: decode batch B={B} on "
                  f"mesh=(data={mesh.data}, model={mesh.model}), {B // mesh.data} rows per "
                  f"data rank, boxes={tuple(res['boxes'].shape)}, "
                  f"tp_serving={'on' if pipe.tensor_parallel else 'off'}", flush=True)
    finally:
        shutdown_distributed()
