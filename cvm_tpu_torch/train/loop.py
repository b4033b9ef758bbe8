"""Training loop: train state, train/eval steps, ``Trainer``.

Mirrors ``cvm_tpu/train/loop.py`` (``TrainState``, ``create_train_state``,
``make_train_step``, ``make_eval_step``, ``Trainer``) on one device, for
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

Not ported yet: the mesh and tensor-parallel sharding (ROADMAP Queue 1 item
17), the stall watchdog and re-exec auto-restart (item 11), TensorBoard
(item 16).
"""

from __future__ import annotations

import copy
import sys
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn as nn

from cvm_tpu_torch.data.loader import prefetch_to_device
from cvm_tpu_torch.models.registry import build_model, get_model
from cvm_tpu_torch.train.checkpoints import CheckpointManager
from cvm_tpu_torch.train.metrics import JsonlMetricsWriter
from cvm_tpu_torch.train.optim import Optimizer, global_norm, make_optimizer
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


def make_train_step(loss_fn: Callable, params_cfg, processor: Callable) -> Callable:
    """Returns ``train_step(state, raw_batch, generator) -> (state,
    metrics)``; the state is updated in place. ``grad_norm`` is the global
    norm of the raw gradients; the EMA moves only on steps where the
    optimizer applied an update (with gradient accumulation, every k-th)."""
    ema_decay = getattr(params_cfg, "ema_decay", 0.0)

    def train_step(state: TrainState, raw_batch, generator: torch.Generator):
        inputs, targets = processor(generator, raw_batch)
        state.model.train()
        with maybe_fake_quant(params_cfg):
            # qat=True: the loss surface includes the int8 rounding noise.
            out = state.model(inputs)
        loss, metrics = loss_fn(out, targets, params_cfg)
        grads = _param_grads(loss, state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        applied = state.optimizer.step(grads)
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
    """Steps, checkpoints and metrics for one model on one device; the
    counterpart of the reference's ``Trainer`` (without the mesh). The
    model is the registry's entry named ``params_cfg.name``."""

    def __init__(self, params_cfg, device: DeviceLike,
                 checkpoint_dir: Optional[str] = None, metrics_path: Optional[str] = None,
                 keep_checkpoints: int = 3, checkpoint_every: int = 1000, log_every: int = 50,
                 seed: int = 0):
        self.cfg = params_cfg
        self.device = resolve_device(device)
        self.spec = get_model(params_cfg.name)
        self.processor = self.spec.make_processor(params_cfg, train=True)
        self.train_step = make_train_step(self.spec.loss_fn, params_cfg, self.processor)
        self.log_every, self.checkpoint_every, self.seed = log_every, checkpoint_every, seed
        self.data_state = None      # data stream state restored from a checkpoint
        self._stop_requested = False
        self.metrics_writer = (None if metrics_path is None
                               else JsonlMetricsWriter(metrics_path))
        self.ckpt = (None if checkpoint_dir is None
                     else CheckpointManager(checkpoint_dir, keep=keep_checkpoints,
                                            params_cfg=params_cfg))
        self.state: Optional[TrainState] = None

    @property
    def model(self) -> nn.Module:
        return self.state.model

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` to evaluate or export with: the EMA shadow when
        ``ema_decay > 0``, else the live parameters."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        names = [n for n, _ in self.state.model.named_parameters()]
        values = self.state.ema if self.state.ema is not None else self.state.params
        return {n: v.detach() for n, v in zip(names, values)}

    def eval_model(self, use_ema: bool = True) -> nn.Module:
        """A copy of the model in eval mode to evaluate or export: the EMA
        parameters when ``use_ema`` and ``ema_decay > 0``, else the live
        ones, with the live BatchNorm statistics (the reference scores
        ``eval_params`` with the live ``batch_stats``). The training model's
        mode, parameters and buffers are not touched."""
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
        restore the newest checkpoint when there is one."""
        cfg = self.cfg
        model = build_model(self.spec, cfg, self.device, torch.Generator().manual_seed(self.seed))
        opt = make_optimizer(list(model.parameters()), cfg.learning_rate, cfg.total_steps,
                             cfg.warmup_steps, cfg.weight_decay,
                             grad_accum_steps=getattr(cfg, "grad_accum_steps", 1),
                             lr_schedule=getattr(cfg, "lr_schedule", "warmup_cosine"),
                             optimizer=getattr(cfg, "optimizer", "adamw"))
        self.state = create_train_state(model, cfg, opt)
        if self.ckpt is not None:
            ck = self.ckpt.restore_latest(map_location=self.device)
            if ck is not None:
                self.load_checkpoint(ck)
        return self.state

    def load_checkpoint(self, ck: dict) -> None:
        """Load a checkpoint (``checkpoint_state``'s dict) into the state;
        tolerant of an ``ema_decay`` / checkpoint mismatch (a missing shadow
        is seeded from the restored parameters, a stale one dropped). Any
        other mismatch raises."""
        state = self.state
        state.model.load_state_dict(ck["model"], strict=True)
        state.optimizer.load_state_dict(ck["optimizer"])
        if state.ema is not None:
            if ck["ema"] is None:
                print("[cvm_tpu_torch] checkpoint predates ema_decay: seeding the EMA "
                      "shadow from the restored params", file=sys.stderr, flush=True)
                src = state.params
            else:
                src = [ck["ema"][n] for n, _ in state.model.named_parameters()]
            with torch.no_grad():
                for e, s in zip(state.ema, src):
                    e.copy_(s)
        elif ck["ema"] is not None:
            print("[cvm_tpu_torch] checkpoint carries an EMA shadow but ema_decay=0: "
                  "dropping it", file=sys.stderr, flush=True)
        state.step = int(ck["step"])
        self.data_state = ck["host"]["data"]

    def checkpoint_state(self, data_state) -> dict:
        """What a checkpoint holds: step, model ``state_dict``, optimizer
        state, EMA shadow (``{name: tensor}`` or None) and the data stream's
        state ``data_state``."""
        st = self.state
        ema = None
        if st.ema is not None:
            ema = {n: e for (n, _), e in zip(st.model.named_parameters(), st.ema)}
        return {"step": st.step, "model": st.model.state_dict(),
                "optimizer": st.optimizer.state_dict(), "ema": ema,
                "host": {"data": data_state}}

    def _save(self, data_state) -> None:
        self.ckpt.save(self.state.step, self.checkpoint_state(data_state))

    def request_stop(self) -> None:
        """Ask ``fit`` to stop at the next step boundary (signal-handler
        safe: only sets a flag). ``fit`` checkpoints the current step and
        returns; ``stop_requested`` stays True."""
        self._stop_requested = True

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested

    def fit(self, data_iter: Iterator, num_steps: int) -> Dict[str, float]:
        """Run ``num_steps`` training steps on host batches from
        ``data_iter``; returns the last metrics (floats, with
        ``steps_per_sec``). Logs at step 1 and every ``log_every`` steps,
        checkpoints every ``checkpoint_every`` steps and on a stop request."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        step = self.state.step
        resumable = hasattr(data_iter, "state_dict")
        data_states: deque = deque()

        def pull():
            # Pairs each batch with the stream's state right after it, so a
            # checkpoint records the state of the batches consumed, not of
            # those prefetched ahead.
            for _ in range(num_steps):
                try:
                    batch = next(data_iter)
                except StopIteration:
                    return
                data_states.append(data_iter.state_dict() if resumable else None)
                yield batch

        last: Dict[str, float] = {}
        metrics = None
        steps_in_window = 0
        t0 = time.perf_counter()
        for raw in prefetch_to_device(pull(), self.device):
            data_state = data_states.popleft()
            gen = step_generator(self.device, self.seed, step)
            self.state, metrics = self.train_step(self.state, raw, gen)
            step += 1
            steps_in_window += 1
            if step % self.log_every == 0 or step == 1:
                last = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                last["steps_per_sec"] = steps_in_window / max(dt, 1e-9)
                steps_in_window = 0
                if self.metrics_writer is not None:
                    self.metrics_writer.write(step, last)
            if self.ckpt is not None and step % self.checkpoint_every == 0:
                self._save(data_state)
            if self._stop_requested:
                if self.ckpt is not None and step % self.checkpoint_every:
                    self._save(data_state)
                break
        if steps_in_window and metrics is not None:
            last = {k: float(v) for k, v in metrics.items()}
            last["steps_per_sec"] = steps_in_window / max(time.perf_counter() - t0, 1e-9)
        return last
