"""Training from records as ``cli.train --data`` trains: ``RecordLoader``
(the train split of a ``.cvrec`` shard, shuffled, JPEG decode on the card's
decoder with the mix's threads, labels assembled on the host) into
``Trainer.fit`` (the processor's jitter, K1's heatmaps, forward and backward
in bf16, AdamW).

Set-up writes the shard from the seed, builds the trainer with weights from
the seed, and drives its first steps through ``Trainer.fit`` on the loader,
one step per call: the losses of steps 1-3, the first gradient as the
optimizer got it (Adam's first moment after step 1, over 1 - b1) and the
parameters before step 1 and after step 3 are kept for the check. More
warm-up steps follow; then the same trainer and loader run the window in
one ``fit``, stopped by ``request_stop`` at the first step that starts after
``--seconds``. ``train_images_per_s`` is the images of every step of the
window over its length, closed by a synchronize.
"""

from __future__ import annotations

import os
import time

import torch

from cvbench import program
from cvbench.guard import assert_clean
from cvbench.reference.flops import train_flops
from cvbench.trace import Tracer, print_per_second
from cvbench.traffic.generator import stream
from cvbench.traffic.records import write_shard


def _snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, tmp: str,
        t_process: float, mesh=None) -> dict:
    """One run; under ``mesh`` (a rank of a data-parallel group, ``rank.py``)
    this rank's part of it: the configuration's batch is each card's, the
    global batch that times the data ranks, and each rank reads its share of
    the train split."""
    from cvm_tpu_torch.data.loader import RecordLoader
    from cvm_tpu_torch.data.records import RecordDataset
    from cvm_tpu_torch.train.loop import Trainer

    params, model, weights = program.build(cfg, seed, device)
    ranks, index = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    params = params.replace(batch_size=params.batch_size * ranks)
    path = os.path.join(tmp, f"train{index}.cvrec")
    shard_bytes = write_shard(path, stream(seed, 1), mix, cfg["params"]["num_classes"])
    ds = RecordDataset([path])
    trainer = Trainer(params, device, seed=seed, log_every=1, mesh=mesh)
    trainer.init_state()
    trainer.state.model.load_state_dict(model.state_dict())
    del model
    B = params.batch_size
    loader = RecordLoader(ds, B // ranks, tuple(mix["buffer_hw"]),
                          ids=ds.split_ids(shard_index=index, num_shards=ranks)[0],
                          max_objects=params.max_objects, seed=seed,
                          num_decode_threads=int(mix["decode_threads"]),
                          target_hw=tuple(mix["decode_target_hw"]), device=device)
    it = iter(loader)
    p0 = _snapshot(trainer.state.model)
    losses, g1 = [], None
    names = list(p0)
    b1 = trainer.state.optimizer.B1
    for k in range(3):                       # the steps the reference follows
        losses.append(trainer.fit(it, 1)["loss"])
        if k == 0:
            g1 = {n: m.detach() / (1.0 - b1) for n, m in zip(names, trainer.state.optimizer.mu)}
            g1 = {n: v.clone() for n, v in g1.items()}
    p3 = _snapshot(trainer.state.model)
    for _ in range(int(mix["warm_steps"])):
        trainer.fit(it, 1)
    trainer.log_every = int(mix["log_every"])

    tracer = Tracer(trace, float(mix["trace_start_s"]), float(mix["trace_s"]), tmp, device)
    tracer.warm()
    assert_clean("set-up")
    program.settle(device)
    step_fn, t0, starts = trainer.train_step, [0.0], []

    def timed_step(*args):                   # the window's clock, on fit's thread
        t = time.perf_counter() - t0[0]
        starts.append(t)
        tracer.poll(t)
        if t >= seconds:
            trainer.request_stop()
        return step_fn(*args)

    trainer.train_step = timed_step
    s0 = dict(loader.stage_seconds), loader.batches_assembled
    first = trainer.state.step
    if mesh is not None:
        torch.distributed.barrier()          # every rank's window starts together
    setup_s = time.perf_counter() - t_process
    t0[0] = time.perf_counter()
    trainer.fit(it, 10 ** 9)
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    window_s = time.perf_counter() - t0[0]
    tracer.close()
    print_per_second("steps started", starts, 0.0, window_s)
    steps = trainer.state.step - first
    s1 = dict(loader.stage_seconds), loader.batches_assembled
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if mesh is not None:                     # the fullest card's
        t = torch.tensor([peak], dtype=torch.int64, device=device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        peak = int(t.item())
    it.close()
    del trainer, loader, it
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nb = max(s1[1] - s0[1], 1)
    hs, ws = (v // params.stride for v in params.input_hw)
    return {
        "setup_s": setup_s, "t_window": t0[0],
        "e2e": {"train_images_per_s": steps * B / window_s},
        "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
        "samples": {"shard": path, "seed": seed, "batch": B, "ranks": ranks, "losses": losses,
                    "g1": g1, "p0": p0, "p3": p3},
        "weights": weights, "trace_events": tracer.events,
        "counters": {"frames": steps * B, "window_s": window_s,
                     "flops_per_frame": train_flops(weights, program.ref_cfg(cfg)),
                     "loader_ms_per_batch": 1e3 * sum(s1[0][k] - s0[0][k] for k in s1[0]) / nb,
                     "cards": ranks,
                     "k1_shape": (B // ranks, hs, ws, params.num_classes, params.max_objects),
                     "shard_bytes": shard_bytes},
    }
