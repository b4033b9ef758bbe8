"""Training loop: train state, train/eval steps, ``Trainer``.

Mirrors ``cvm_tpu/train/loop.py`` (``TrainState``, ``create_train_state``,
``make_train_step``, ``make_eval_step``, ``Trainer``), for
any model of the registry (``models/registry.py``; the params' ``name``
picks its model, loss and processor). The reference compiles one program
per step; here the same steps run eagerly: processor (with kernel K1 for
the GT heatmap of CenterNet and multitask on the card), forward in
training mode, loss, backward, optimizer update, EMA. Nothing in
a step reads a device value on the host; ``fit`` does so only at its log
points.

Random numbers: the reference folds the step into one base key per ``fit``
call. JAX's streams cannot be reproduced in torch, so each step seeds its
own ``torch.Generator`` on the device from (seed, step) alone: how a run is
cut into ``fit`` calls (``cli.train --eval_every`` calls it once per eval
chunk) does not change its numbers. The checkpoint carries the data
stream's state, so a run resumed from any checkpoint continues the same
data and augmentation stream, evaluations in between or not.

With ``qat=True`` the train and eval steps run their forward under
``train/qat.py::maybe_fake_quant``, as the reference's do.

The stall watchdog of ``fit`` is the reference's (``_watch``): a thread
that reports which side stalled when no step has completed for
``CVM_STALL_THRESHOLD_S`` seconds (120 by default; 1800 before the first
step): the input pipeline (``await_batch``), or the device (``transfer``,
``stepping``), and, given ``restart_argv`` and a checkpoint directory,
re-execs that command (``_maybe_auto_restart``, at most ``max_restarts``
times, counted in ``CVM_RESTART_COUNT``, which a checkpoint past the
resume point clears), so that the new process resumes from the newest
checkpoint. With ``restart_by_exit`` (a rank of the local launcher,
``parallel/mesh.py::run_local_ranks``) it exits instead, with the code
that asks the launcher to start every rank again. Neither waits for a checkpoint write in flight: a
stalled device never completes its snapshot copy, and the newest whole
checkpoint is the one before. A process that was stopped (SIGSTOP) and resumed sees its
watcher oversleep and does not count the pause. The time spent waiting
for a batch is not counted against the device either: the quiet clock
restarts when a batch arrives (the reference's keeps running, so a watcher
that wakes between a starved batch's arrival and its step's end takes the
input's stall for the device's and restarts). A step "completes" when
the device has run it: on a card ``fit`` records a CUDA event after each
step and waits for the event ``MAX_INFLIGHT`` steps back (the reference's
``inflight`` deque), so the host runs at most that far ahead and the
heartbeat is the device's, not the host's enqueueing.

``debug_nans`` (``cli.train --debug_nans``, the reference's
``jax_debug_nans``) checks every step on the host and raises
``FloatingPointError`` at the first step whose model outputs, loss,
gradients or updated parameters are not finite, naming the step and the
tensors.

Multi-process training (``mesh``, ``parallel/mesh.py``): one process per
card, the global batch ``cfg.batch_size`` split over the data axis, each
rank fed its rows (``Mesh.batch_rows``). The reference's Trainer gets the
rest from GSPMD; here every rank:

* draws the augmentation of the whole global batch from the same
  ``step_generator`` and keeps its rows, so N ranks use one process's
  draws;
* computes BatchNorm's training statistics and every batch-wide sum, mean
  and max of the loss over the global batch (``parallel/reduce.py``), so
  all ranks hold the same loss and metrics;
* sums its gradients over the data group, in flat buckets, before the
  optimizer (DDP is not used: its reducer does not serve
  ``torch.autograd.grad``), then divides by the group's size; gradient
  accumulation and the EMA work on the result unchanged;
* with ``tensor_parallel`` and a model axis of two or more ranks, holds
  slices of the stage-5 convs (``parallel/sharding.py``), of their
  optimizer state and of their EMA.

Every rank builds the same seeded init (a checksum all-reduce checks it);
rank 0 reads a checkpoint and broadcasts it, and rank 0 alone writes
checkpoints (whole tensors, the layout of a one-process run, with every
data rank's stream state) and metrics while the others wait. A stop
request on any rank stops all of them after the same step: each step
all-reduces a flag, which the host reads only once it has waited for that
step's event anyway (up to ``MAX_INFLIGHT`` steps later on a card) or when
``fit`` ends, so the in-flight window stays open. The watchdog's re-exec would restart one rank,
which cannot rejoin the group, so ``restart_argv`` is refused under a
group of two or more, unless ``restart_by_exit`` says a launcher restarts
them all.

Checkpoints are written in the background (``train/checkpoints.py``): a
save takes a snapshot and returns, so the steps go on while rank 0 writes;
``fit`` waits for the write in flight when it ends, as the reference's
does, and so does a stop, which ends ``fit``.
"""

from __future__ import annotations

import copy
import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from cvm_tpu_torch.data.loader import prefetch_to_device
from cvm_tpu_torch.models.layers import BatchNorm
from cvm_tpu_torch.models.registry import build_model, get_model
from cvm_tpu_torch.parallel.mesh import RESTART_EXIT, Mesh, single_mesh
from cvm_tpu_torch.parallel.reduce import LOCAL
from cvm_tpu_torch.parallel.sharding import (gather_state_dict, shard_module,
                                             shard_state_dict, split_norm, tp_rules_for)
from cvm_tpu_torch.train.checkpoints import CheckpointManager
from cvm_tpu_torch.train.metrics import JsonlMetricsWriter, MultiWriter
from cvm_tpu_torch.train.optim import Optimizer, make_optimizer
from cvm_tpu_torch.train.qat import maybe_fake_quant
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


class TrainState:
    """The model (parameters and BatchNorm buffers), the optimizer with its
    state, the EMA shadow of the parameters (None when ``ema_decay`` is 0)
    and the step count."""

    def __init__(self, step: int, model: nn.Module, optimizer: Optimizer,
                 ema: Optional[List[torch.Tensor]] = None):
        self.step, self.model, self.optimizer, self.ema = step, model, optimizer, ema

    @property
    def params(self) -> List[torch.Tensor]:
        return self.optimizer.params


def create_train_state(model: nn.Module, params_cfg, optimizer: Optimizer) -> TrainState:
    use_ema = getattr(params_cfg, "ema_decay", 0.0) > 0.0
    ema = [p.detach().clone() for p in optimizer.params] if use_ema else None
    return TrainState(0, model.train(), optimizer, ema)


def _param_grads(loss: torch.Tensor, state: TrainState):
    """d loss / d every parameter. A parameter the loss does not reach is
    an error (a disconnected head would otherwise train on a zero gradient
    while weight decay shrinks it), except those the model names in
    ``params_unread_by_loss()`` (a depth net's coarse disp heads that no
    loss reads): they get a zero gradient, as in JAX."""
    unread = getattr(state.model, "params_unread_by_loss", list)
    allowed = {id(p) for p in unread()}
    grads = torch.autograd.grad(loss, state.params, allow_unused=True)
    names = {id(p): n for n, p in state.model.named_parameters()}
    stray = [names.get(id(p), "?") for p, g in zip(state.params, grads)
             if g is None and id(p) not in allowed]
    if stray:
        raise RuntimeError(f"the loss does not reach parameters {stray}")
    return tuple(torch.zeros_like(p) if g is None else g for p, g in zip(state.params, grads))


def _raise_non_finite(step: int, what: str, named: Dict[str, torch.Tensor]) -> None:
    """FloatingPointError naming the tensors of ``named`` that hold a NaN or
    an infinity (one host sync for all of them)."""
    names = list(named)
    if not names:
        return
    ok = torch.stack([torch.isfinite(t).all() for t in named.values()]).cpu()
    bad = [n for n, good in zip(names, ok.tolist()) if not good]
    if bad:
        raise FloatingPointError(f"--debug_nans: step {step}: non-finite {what}: {bad}")


def make_train_step(loss_fn: Callable, params_cfg, processor: Callable,
                    debug_nans: bool = False, mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``train_step(state, raw_batch, generator) -> (state,
    metrics)``; the state is updated in place. ``grad_norm`` is the global
    norm of the raw gradients; the EMA moves only on steps where the
    optimizer applied an update (with gradient accumulation, every k-th).
    With ``debug_nans`` the step raises ``FloatingPointError`` at the first
    of its model outputs, loss, gradients and updated parameters that is
    not finite (the reference's ``jax_debug_nans``). The step calls
    ``processor(generator, raw_batch, rows=rows)`` and ``loss_fn(out,
    targets, params_cfg, reducer)``. Under a ``mesh`` with a data axis of
    two or more, ``raw_batch`` is this rank's ``rows`` of the global batch;
    the processor draws for the global batch, the loss reduces over it and
    the gradients are averaged over the data group. Otherwise ``rows`` is
    None (the whole batch) and the reducer ``LOCAL``."""
    ema_decay = getattr(params_cfg, "ema_decay", 0.0)
    data_parallel = mesh is not None and mesh.data > 1
    rows = mesh.batch_rows(params_cfg.batch_size) if data_parallel else None
    red = mesh.reducer if data_parallel else LOCAL

    def train_step(state: TrainState, raw_batch, generator: torch.Generator):
        inputs, targets = processor(generator, raw_batch, rows=rows)
        state.model.train()
        with maybe_fake_quant(params_cfg, red):
            # qat=True: the loss surface includes the int8 rounding noise.
            out = state.model(inputs)
        loss, metrics = loss_fn(out, targets, params_cfg, red)
        step = state.step + 1
        if debug_nans:
            _raise_non_finite(step, "model outputs", {k: v for k, v in out.items()
                                                      if torch.is_tensor(v)})
            _raise_non_finite(step, "loss", {"loss": loss})
        grads = _param_grads(loss, state)
        if data_parallel:
            grads = mesh.all_reduce_grads(grads)
        if debug_nans:
            names = [n for n, _ in state.model.named_parameters()]
            _raise_non_finite(step, "gradients", dict(zip(names, grads)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = state.optimizer.norm(grads)
        applied = state.optimizer.step(grads)
        if debug_nans:
            _raise_non_finite(step, "updated parameters", dict(zip(names, state.params)))
        if ema_decay > 0.0 and applied:
            with torch.no_grad():
                torch._foreach_mul_(state.ema, ema_decay)
                torch._foreach_add_(state.ema, state.params, alpha=1.0 - ema_decay)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(loss_fn: Callable, params_cfg, processor: Callable) -> Callable:
    """Returns ``eval_step(state, raw_batch) -> metrics``: the loss of the
    eval-mode model (running BN statistics), with the EMA parameters when
    ``ema_decay > 0``. The live parameters are not touched."""
    use_ema = getattr(params_cfg, "ema_decay", 0.0) > 0.0

    @torch.no_grad()
    def eval_step(state: TrainState, raw_batch) -> Dict[str, torch.Tensor]:
        inputs, targets = processor(None, raw_batch)
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with maybe_fake_quant(params_cfg):
                if use_ema:
                    names = [n for n, _ in model.named_parameters()]
                    out = torch.func.functional_call(model, dict(zip(names, state.ema)),
                                                     (inputs,), strict=False)
                else:
                    out = model(inputs)
        finally:
            model.train(was_training)
        _, metrics = loss_fn(out, targets, params_cfg)
        return metrics

    return eval_step


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The generator of one training step, on ``device``."""
    s = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


class Trainer:
    """Steps, checkpoints and metrics for one model; the counterpart of
    the reference's ``Trainer``. The model is the registry's entry named
    ``params_cfg.name``. ``mesh`` (``parallel/mesh.py::make_mesh``) makes
    this process one rank of a multi-process run on ``mesh.device``, which
    ``device`` must name; metrics and checkpoints are written by rank 0.

    ``tensorboard_dir`` adds a TensorBoard event writer beside the JSONL
    one (``metrics_writer`` is then a ``MultiWriter``). ``restart_argv``
    (a command line, ``cli.train --auto_restart``) arms the watchdog's
    re-exec, at most ``max_restarts`` times; ``restart_by_exit`` makes it
    an exit (``RESTART_EXIT`` + the restart's number) for a launcher that
    restarts every rank (``cli.train --restart_by_exit``, which the local
    launcher passes its ranks). ``tx`` builds the optimizer from the
    parameter list in place of the config's (the LR finder's sweep)."""

    # Steps the host may enqueue ahead of the device before it waits: the
    # bound on the run-ahead that makes the watchdog's heartbeat the device's.
    MAX_INFLIGHT = 8

    def __init__(self, params_cfg, device: DeviceLike,
                 checkpoint_dir: Optional[str] = None, metrics_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 keep_checkpoints: int = 3, checkpoint_every: int = 1000, log_every: int = 50,
                 seed: int = 0, restart_argv: Optional[Sequence[str]] = None,
                 max_restarts: int = 3, debug_nans: bool = False,
                 tx: Optional[Callable[[List[torch.Tensor]], Optimizer]] = None,
                 mesh: Optional[Mesh] = None, restart_by_exit: bool = False):
        self.cfg = params_cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else single_mesh(self.device)
        if self.mesh.device != self.device:
            raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
        if restart_argv is not None and self.mesh.world > 1 and not restart_by_exit:
            raise ValueError("auto-restart re-execs one process, which cannot rejoin a "
                             f"process group of {self.mesh.world}: restart the whole job "
                             "(every rank resumes from the newest checkpoint)")
        self.spec = get_model(params_cfg.name)
        self.processor = self.spec.make_processor(params_cfg, train=True)
        self.train_step = make_train_step(self.spec.loss_fn, params_cfg, self.processor,
                                          debug_nans=debug_nans, mesh=self.mesh)
        self.split: Dict[str, int] = {}   # tensor-parallel slices: {name: dim}
        self.log_every, self.checkpoint_every, self.seed = log_every, checkpoint_every, seed
        self.restart_argv = None if restart_argv is None else list(restart_argv)
        self.max_restarts, self.restart_by_exit = max_restarts, restart_by_exit
        self.tx = tx
        self.data_state = None      # data stream state restored from a checkpoint
        self._stop_requested = False  # asked on this rank
        self._stopped = False         # fit stopped on a request (of any rank)
        writers = []
        rank0 = self.mesh.is_rank0
        if metrics_path is not None and rank0:
            writers.append(JsonlMetricsWriter(metrics_path))
        if tensorboard_dir is not None and rank0:
            from cvm_tpu_torch.train.tensorboard import TensorBoardWriter

            writers.append(TensorBoardWriter(tensorboard_dir))
        self.metrics_writer = (None if not writers else writers[0] if len(writers) == 1
                               else MultiWriter(*writers))
        self.ckpt = (None if checkpoint_dir is None
                     else CheckpointManager(checkpoint_dir, keep=keep_checkpoints,
                                            params_cfg=params_cfg, writer=rank0))
        self.state: Optional[TrainState] = None

    @property
    def model(self) -> nn.Module:
        return self.state.model

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` to evaluate or export with: the EMA shadow when
        ``ema_decay > 0``, else the live parameters (whole tensors: under
        tensor parallelism every rank of the model group calls this)."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        names = [n for n, _ in self.state.model.named_parameters()]
        values = self.state.ema if self.state.ema is not None else self.state.params
        return self._whole({n: v.detach() for n, v in zip(names, values)})

    def _whole(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return gather_state_dict(named, self.split, self.mesh) if self.split else named

    def eval_model(self, use_ema: bool = True) -> nn.Module:
        """A copy of the model in eval mode to evaluate or export: the EMA
        parameters when ``use_ema`` and ``ema_decay > 0``, else the live
        ones, with the live BatchNorm statistics (the reference scores
        ``eval_params`` with the live ``batch_stats``). The training model's
        mode, parameters and buffers are not touched. Under tensor
        parallelism the copy holds this rank's slices, as the training
        model does: ``InferencePipeline(mesh=)`` serves it split, or
        gathers it whole for the int8 postures."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        model = copy.deepcopy(self.state.model)
        if use_ema and self.state.ema is not None:
            with torch.no_grad():
                for p, e in zip(model.parameters(), self.state.ema):
                    p.copy_(e)
        return model.eval()

    def init_state(self) -> TrainState:
        """Build the model (weights drawn from ``seed``) and optimizer, and
        restore the newest checkpoint when there is one. Under a mesh every
        rank checks that it built the same weights, cuts its tensor-parallel
        slices, and loads the checkpoint rank 0 read."""
        cfg, mesh = self.cfg, self.mesh
        model = build_model(self.spec, cfg, self.device, torch.Generator().manual_seed(self.seed),
                            mesh=mesh)
        mesh.check_replicas(list(model.state_dict().values()), "initial weights")
        if getattr(cfg, "tensor_parallel", False):
            # on a model axis of one rank the rules shard nothing, as the
            # reference's do over a size-1 axis
            self.split = shard_module(model, mesh, tp_rules_for(self.spec.name))
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.reducer = mesh.reducer
        if self.tx is not None:
            opt = self.tx(list(model.parameters()))
        else:
            opt = make_optimizer(list(model.parameters()), cfg.learning_rate, cfg.total_steps,
                                 cfg.warmup_steps, cfg.weight_decay,
                                 grad_accum_steps=getattr(cfg, "grad_accum_steps", 1),
                                 lr_schedule=getattr(cfg, "lr_schedule", "warmup_cosine"),
                                 optimizer=getattr(cfg, "optimizer", "adamw"))
        if self.split:
            opt.norm = split_norm([n in self.split for n, _ in model.named_parameters()], mesh)
        self.state = create_train_state(model, cfg, opt)
        if self.ckpt is not None:
            ck = None
            if mesh.is_rank0:
                ck = self.ckpt.restore_latest(
                    map_location=self.device if mesh.world == 1 else "cpu")
            ck = mesh.broadcast_object(ck)
            if ck is not None:
                self.load_checkpoint(ck)
        return self.state

    def _by_name(self, tensors: List[torch.Tensor], gather: bool) -> List[torch.Tensor]:
        """Per-parameter optimizer state gathered whole (``gather``) or cut
        to this rank's slices."""
        if not self.split or not tensors:
            return tensors
        names = [n for n, _ in self.state.model.named_parameters()]
        named = dict(zip(names, tensors))
        named = (gather_state_dict(named, self.split, self.mesh) if gather
                 else shard_state_dict(named, self.split, self.mesh))
        return [named[n] for n in names]

    def load_checkpoint(self, ck: dict) -> None:
        """Load a checkpoint (``checkpoint_state``'s dict) into the state;
        tolerant of an ``ema_decay`` / checkpoint mismatch (a missing shadow
        is seeded from the restored parameters, a stale one dropped). Any
        other mismatch raises. The checkpoint holds whole tensors; under
        tensor parallelism each rank loads its slices."""
        state, mesh = self.state, self.mesh
        model_sd, opt_sd, ema = ck["model"], dict(ck["optimizer"]), ck["ema"]
        if self.split:
            model_sd = shard_state_dict(model_sd, self.split, mesh)
            for k in ("mu", "nu", "acc"):
                opt_sd[k] = self._by_name(opt_sd[k], gather=False)
            if ema is not None:
                ema = shard_state_dict(ema, self.split, mesh)
        state.model.load_state_dict(model_sd, strict=True)
        state.optimizer.load_state_dict(opt_sd)
        if state.ema is not None:
            if ema is None:
                if mesh.is_rank0:
                    print("[cvm_tpu_torch] checkpoint predates ema_decay: seeding the EMA "
                          "shadow from the restored params", file=sys.stderr, flush=True)
                src = state.params
            else:
                src = [ema[n] for n, _ in state.model.named_parameters()]
            with torch.no_grad():
                for e, s in zip(state.ema, src):
                    e.copy_(s)
        elif ema is not None and mesh.is_rank0:
            print("[cvm_tpu_torch] checkpoint carries an EMA shadow but ema_decay=0: "
                  "dropping it", file=sys.stderr, flush=True)
        state.step = int(ck["step"])
        host = ck["host"]
        ranks = host.get("data_ranks")
        if ranks is not None and len(ranks) == mesh.data:
            self.data_state = ranks[mesh.data_index]
        else:  # another layout of streams: rank 0 continues the first one
            self.data_state = host["data"] if mesh.data_index == 0 else None

    def checkpoint_state(self, data_state) -> dict:
        """What a checkpoint holds: step, model ``state_dict``, optimizer
        state, EMA shadow (``{name: tensor}`` or None) and the data stream's
        state ``data_state``. Under a mesh every rank calls this: the
        tensors are gathered whole, and ``host["data_ranks"]`` holds each
        data rank's stream state (complete on rank 0)."""
        st, mesh = self.state, self.mesh
        ema = None
        if st.ema is not None:
            ema = self._whole({n: e for (n, _), e in zip(st.model.named_parameters(), st.ema)})
        opt = st.optimizer.state_dict()
        if self.split:
            opt = {**opt, **{k: self._by_name(opt[k], gather=True) for k in ("mu", "nu", "acc")}}
        host = {"data": data_state}
        if mesh.world > 1:
            states = mesh.gather_to_rank0("data_state", data_state)
            if states is not None:
                host["data_ranks"] = [states[d * mesh.model] for d in range(mesh.data)]
        return {"step": st.step, "model": self._whole(st.model.state_dict()),
                "optimizer": opt, "ema": ema, "host": host}

    def _save(self, data_state) -> None:
        """Every rank gathers the state; rank 0 issues its write (which
        waits for the write before it) while the others wait."""
        state = self.checkpoint_state(data_state)
        self.mesh.from_rank0("save", lambda: self.ckpt.save(self.state.step, state))

    def _wait_saved(self) -> None:
        """Wait (on every rank) until rank 0's write in flight is on disk."""
        self.mesh.from_rank0("saved", self.ckpt.wait)

    def _maybe_auto_restart(self, quiet_s: float) -> None:
        """Device-stall recovery: re-exec ``restart_argv`` (bounded retries).

        A stalled device cannot be interrupted from Python; exec replaces
        the whole process image, and the new one resumes from the newest
        checkpoint in ``init_state``. Progress since that checkpoint is
        lost. Does nothing without ``restart_argv`` or a checkpoint
        directory. The count of restarts crosses the exec in
        ``CVM_RESTART_COUNT``. With ``restart_by_exit`` the process exits
        with ``RESTART_EXIT`` + the restart's number instead: its launcher
        ends the other ranks and starts them all again, the count in their
        environment. A write in
        flight is not waited for (the stalled device would never complete
        its snapshot)."""
        if self.restart_argv is None or self.ckpt is None:
            return
        count = int(os.environ.get("CVM_RESTART_COUNT", "0"))
        if count >= self.max_restarts:
            print(f"[cvm_tpu_torch] device stalled again after {count} restarts — giving up "
                  "on auto-recovery (persistent device failure)", file=sys.stderr, flush=True)
            return
        step = self.ckpt.latest_step()
        if self.restart_by_exit:
            print(f"[cvm_tpu_torch] AUTO-RESTART {count + 1}/{self.max_restarts}: device "
                  f"stalled {quiet_s:.0f}s on rank {self.mesh.rank}; exiting so that the "
                  f"launcher restarts every rank from checkpoint step {step}",
                  file=sys.stderr, flush=True)
            os._exit(RESTART_EXIT + count + 1)
        os.environ["CVM_RESTART_COUNT"] = str(count + 1)
        print(f"[cvm_tpu_torch] AUTO-RESTART {count + 1}/{self.max_restarts}: device stalled "
              f"{quiet_s:.0f}s; re-exec'ing to resume from checkpoint step {step}: "
              f"{' '.join(self.restart_argv)}", file=sys.stderr, flush=True)
        try:
            os.execv(self.restart_argv[0], self.restart_argv)
        except OSError as e:  # the exec failed: warn only, as without restart_argv
            print(f"[cvm_tpu_torch] auto-restart exec failed: {e}", file=sys.stderr, flush=True)

    def _watch(self, heartbeat: list, loop_stage: list, done: threading.Event,
               stall_s: float) -> None:
        """The watchdog thread of ``fit`` (the reference's ``_watch``).
        ``heartbeat`` is [monotonic time of the last completed step, whether
        a step has completed]; ``loop_stage`` [the loop's stage]."""
        interval = min(30.0, stall_s / 2)
        last_wake = time.monotonic()
        while not done.wait(interval):
            now = time.monotonic()
            # This thread overslept its own wait by far: the process was
            # stopped (SIGSTOP) or the host froze. The quiet time that
            # passed says nothing of the device.
            if now - last_wake > interval + stall_s / 2:
                heartbeat[0] = now
                last_wake = now
                continue
            last_wake = now
            quiet = now - heartbeat[0]
            if quiet <= (stall_s if heartbeat[1] else 1800.0):
                continue
            if not heartbeat[1]:
                print(f"[cvm_tpu_torch] WARNING: first step still not finished in "
                      f"{quiet:.0f}s (kernel builds can take minutes; stalled if it "
                      "persists)", file=sys.stderr, flush=True)
            elif loop_stage[0] == "await_batch":
                print(f"[cvm_tpu_torch] WARNING: no input batch received in {quiet:.0f}s — "
                      "the HOST input pipeline is starved or blocked (the device is idle; "
                      "check the loader and storage, restarting will not help)",
                      file=sys.stderr, flush=True)
            elif loop_stage[0] == "transfer":
                print(f"[cvm_tpu_torch] WARNING: host->device batch transfer not completed "
                      f"in {quiet:.0f}s — the device looks stalled mid-transfer",
                      file=sys.stderr, flush=True)
                self._maybe_auto_restart(quiet)
            else:
                print(f"[cvm_tpu_torch] WARNING: no training step completed on the device in "
                      f"{quiet:.0f}s with input available — the device looks stalled",
                      file=sys.stderr, flush=True)
                self._maybe_auto_restart(quiet)

    def request_stop(self) -> None:
        """Ask ``fit`` to stop at the next step boundary (signal-handler
        safe: only sets a flag). ``fit`` checkpoints the current step and
        returns; ``stop_requested`` stays True."""
        self._stop_requested = True

    @property
    def stop_requested(self) -> bool:
        """Whether a stop was asked; under a group, whether ``fit`` stopped
        on one (so every rank answers alike)."""
        return self._stop_requested if self.mesh.world == 1 else self._stopped

    def _stop(self, step: int, data_state) -> None:
        self._stopped = True
        if self.ckpt is not None and step % self.checkpoint_every:
            self._save(data_state)

    def fit(self, data_iter: Iterator, num_steps: int) -> Dict[str, float]:
        """Run ``num_steps`` training steps on host batches from
        ``data_iter``; returns the last metrics (floats, with
        ``steps_per_sec``). Logs at step 1 and every ``log_every`` steps,
        checkpoints every ``checkpoint_every`` steps and on a stop request,
        under the stall watchdog; returns once the last checkpoint is on
        disk."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        step = self.state.step
        resumable = hasattr(data_iter, "state_dict")
        data_states: deque = deque()

        heartbeat = [time.monotonic(), False]

        def pull():
            # Pairs each batch with the stream's state right after it, so a
            # checkpoint records the state of the batches consumed, not of
            # those prefetched ahead.
            for _ in range(num_steps):
                try:
                    batch = next(data_iter)
                except StopIteration:
                    return
                # The time spent waiting for this batch was the input's, not
                # the device's: the device's quiet time starts again here.
                heartbeat[0] = max(heartbeat[0], time.monotonic())
                data_states.append(data_iter.state_dict() if resumable else None)
                yield batch

        on_card = self.device.type == "cuda"
        loop_stage = ["await_batch"]
        done = threading.Event()
        stall_s = float(os.environ.get("CVM_STALL_THRESHOLD_S", "120"))
        watcher = threading.Thread(target=self._watch,
                                   args=(heartbeat, loop_stage, done, stall_s), daemon=True)
        watcher.start()
        inflight: deque = deque()   # one CUDA event per step not yet waited for
        # Under a group, each step's stop flag over every rank, read once the
        # step has ended on the device: every rank stops at the same step,
        # and the host does not wait for the card to read it.
        stops: deque = deque()
        resume_step = step          # restart-budget reset point
        last: Dict[str, float] = {}
        metrics = None
        steps_in_window = 0
        t0 = time.perf_counter()
        try:
            for raw in prefetch_to_device(pull(), self.device, stage=loop_stage):
                loop_stage[0] = "stepping"
                data_state = data_states.popleft()
                gen = step_generator(self.device, self.seed, step)
                self.state, metrics = self.train_step(self.state, raw, gen)
                step += 1
                steps_in_window += 1
                if self.mesh.world > 1:
                    stops.append(self.mesh.any_rank(self._stop_requested))
                stop = self.mesh.world == 1 and self._stop_requested
                if on_card:
                    ev = torch.cuda.Event()
                    ev.record()
                    inflight.append(ev)
                    if len(inflight) > self.MAX_INFLIGHT:
                        inflight.popleft().synchronize()
                        heartbeat[:] = [time.monotonic(), True]
                        stop = stop or bool(stops and stops.popleft().item())
                else:
                    heartbeat[:] = [time.monotonic(), True]
                    stop = stop or bool(stops and stops.popleft().item())
                if step % self.log_every == 0 or step == 1:
                    last = {k: float(v) for k, v in metrics.items()}
                    heartbeat[:] = [time.monotonic(), True]
                    dt = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    last["steps_per_sec"] = steps_in_window / max(dt, 1e-9)
                    steps_in_window = 0
                    if self.metrics_writer is not None:
                        self.metrics_writer.write(step, last)
                if self.ckpt is not None and step % self.checkpoint_every == 0:
                    self._save(data_state)
                    if step > resume_step:
                        # Checkpointed progress past the resume point: the
                        # restart budget is per stall, not per job.
                        os.environ.pop("CVM_RESTART_COUNT", None)
                if stop:
                    self._stop(step, data_state)
                    break
                loop_stage[0] = "await_batch"
            else:
                if stops:  # the flags of the steps still in flight
                    if inflight:
                        inflight[-1].synchronize()
                    if any(t.item() for t in stops):
                        self._stop(step, data_state)
        finally:
            # joined, so that no watcher outlives fit (a daemon thread still
            # waiting when the interpreter exits can abort the process)
            done.set()
            watcher.join()
        if steps_in_window and metrics is not None:
            last = {k: float(v) for k, v in metrics.items()}
            last["steps_per_sec"] = steps_in_window / max(time.perf_counter() - t0, 1e-9)
        if self.ckpt is not None:
            self._wait_saved()
        return last
