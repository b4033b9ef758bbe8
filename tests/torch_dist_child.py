"""A rank of a multi-process run of the port (``cvm_tpu_torch/parallel``),
and its one-process twin. Imports no JAX: the card's machine runs it.

``python tests/torch_dist_child.py --rank R --world N --port P --device
cpu|cuda [--backend gloo|nccl] --out FILE MODE ...`` joins a group of N
ranks (gloo unless named, rank 0 serving the rendezvous at 127.0.0.1:P;
two gloo ranks may share a card) and
writes a JSON result to FILE (and FILE.npz with tensors). The functions
``run_train``, ``run_grads`` and ``run_bn`` take ``mesh=None`` for the
one-process run, which the tests and ``chip_smoke.py`` call in-process.

Modes:

* ``train --model NAME --config tiny|B --steps S [--model_parallel M]
  [--tensor_parallel] [--ckdir D] [--qat] [--float32]``: S steps of the
  registry's model on global batches of synthetic scenes seeded per step
  (every rank makes the whole batch and keeps its rows), through
  ``Trainer.fit``; the losses and metrics of every step, K1's launches, a
  float64 checksum of the whole parameters, each stage-5 parameter's shape
  on this rank, ms per step, the all-reduces of each step and their bytes,
  with ``--ckdir`` a checkpoint of the last step, and with ``--qat`` the
  fake quant's scales of every ``s5b*.c2`` conv in every forward;
  ``--float32`` runs every conv in float32.
* ``grads --npz IN --steps S``: from IN's model weights (``sd/<name>``),
  processed inputs (``inputs``), targets (``t/<field>``) and config
  (``cfg``, JSON), the first step's averaged gradients, then S SGD steps'
  metrics, each rank on its rows of the inputs; every conv in float32
  when IN's ``float32`` is set; with the config's ``tensor_parallel``
  the stage-5 blocks split over ``--model_parallel``, and with its
  ``qat`` the fake quant's ``s5b*.c2`` scales, as ``train``'s.
* ``stop --steps S``: one ``Trainer.fit`` over S steps of the tiny
  CenterNet in which the last rank alone asks to stop as it takes its
  third batch; the step each rank stopped at and its ``stop_requested``.
* ``join``: forms the group (``--backend``, gloo by default) and leaves it.
* ``bn --npz IN``: a float32 BatchNorm in training mode on this rank's rows
  of IN's ``x`` under the loss sum(y * IN's ``w``): its output, the input's
  gradient and the running statistics.
* ``spatial --npz IN``: ``parallel/spatial.py::spatial_conv3x3`` of this
  rank's H-slab of IN's ``x`` (NHWC) with ``w`` (OIHW) over a model axis of
  every rank, under the loss sum(y * ``g``'s slab): the output slab, its
  input's gradient and the weight's.
* ``forward --npz IN``: the model of IN (as ``grads``; a ``spatial_shard``
  semseg's head over the mesh's model axis) in eval mode on this rank's
  rows of ``inputs``, the outputs gathered in row order.
* ``serve --npz IN [--reps R]``: ``InferencePipeline(mesh=)`` of IN's
  model (``sd/<name>``, ``cfg``, ``name``) in the posture of ``opts``
  (JSON of its keyword arguments; ``"w8a8": "scales"`` takes IN's
  ``scales``, JSON) on the batch ``b/<key>``: the outputs, K2's launches
  in the call, whether the stage-5 convs served split, and, with R, the ms
  of R more calls.
* ``evaluate --npz IN``: ``evaluate_model(mesh=)`` of IN's model on IN's
  ``batches`` synthetic batches (``default_rng(999)``, ``pad``): the
  metrics.
* ``cli --module M --argv JSON``: ``M.main`` (a CLI of the port) on the
  argument list JSON plus this rank's ``--coordinator / --num_processes /
  --process_id``, which forms the group itself (on ``--backend``): its exit code,
  its standard output and the K1 and K2 launches it made. ``--timeout T``
  sets the group's collective timeout to T seconds once it has formed;
  ``--slow_best S`` makes the first ``BestCheckpoint.update`` (rank 0's
  ``--keep_best`` write) sleep S seconds first; ``--late_best L`` makes
  every other rank reach each ``from_rank0("best")`` L seconds late;
  ``--hang_rank R --hang_step S`` stalls training step S on rank R in the
  first image of a run (``CVM_RESTART_COUNT`` unset; ``torch_hang_child.py``'s
  stall: the device sleeps ``CVM_HANG_S`` seconds on a card, the host an
  hour on the CPU); ``--fail_rank R --hang_step S`` raises in step S on
  rank R instead. Events go to FILE.events, a line each: ``hang``,
  ``restart`` (the watchdog's), ``start`` and ``first_step`` (this image's
  first step ended on the device), with the rank, ``time.time()`` and
  ``CVM_RESTART_COUNT``. ``--tiny_benchmark`` gives ``cli.benchmark`` two tiny
  configs: A (semseg, batch 1, serving) and E (CenterNet, batch 2,
  training).
* ``local --module M --argv JSON``: this process is the launcher: ``M.main``
  on JSON (no ``--coordinator``; ``--num_processes`` or the visible cards
  say how many ranks), whose ranks ``parallel/mesh.py::launch_local`` starts
  as this script's ``cli`` mode (with this command line's hooks), each
  writing FILE.rank<r>; FILE holds the launcher's exit code.

``grads``, ``spatial``, ``forward``, ``serve`` and ``evaluate`` take
several IN, comma-separated: one result each, in order (the arrays of the
i-th under ``i/``). An IN's own ``mode`` and ``model_parallel``, when it
holds them, override the command line's, so that one launch runs several
kinds of work.
"""

import argparse
import contextlib
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cvm_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from cvm_tpu_torch.models.registry import build_model, get_model  # noqa: E402
from cvm_tpu_torch.ops.cuda import fused_qconv, gaussian_splat, yuv_letterbox  # noqa: E402
from cvm_tpu_torch.ops.heatmap import CenternetTargets  # noqa: E402
from cvm_tpu_torch.parallel.mesh import (init_distributed, launch_ranks,  # noqa: E402
                                         make_mesh, shutdown_distributed)
from cvm_tpu_torch.train.loop import Trainer, create_train_state, make_train_step  # noqa: E402
from cvm_tpu_torch.train.optim import make_optimizer  # noqa: E402

HW, WIDE = (64, 64), (64, 128)
# model -> (params, scene padding, scene options)
CONFIGS = {
    "tiny": {
        "centernet": (dict(input_hw=HW, num_classes=3, backbone="tiny", neck_features=32,
                           head_features=16, max_objects=8), (80, 96), {}),
        "semseg": (dict(input_hw=WIDE, backbone="tiny", decoder_features=16), (80, 160), {}),
        "depth": (dict(input_hw=WIDE, backbone="tiny", decoder_features=16), (80, 160), {}),
        "multitask": (dict(input_hw=WIDE, backbone="tiny", neck_features=32, head_features=16,
                           num_det_classes=3, max_objects=8), (80, 160), {}),
        "dmds": (dict(input_hw=WIDE, backbone="tiny", decoder_features=16, motion_features=32),
                 (80, 160), dict(two_frame=True)),
    },
    # config B (512x512, small, stride 4, 80 classes) on the flagship recipe's scenes
    "B": {"centernet": (dict(max_objects=16), (512, 512), {})},
}
GLOBAL_BATCH = {"tiny": 4, "B": 16}


def global_batch(step: int, model: str, config: str, batch: int):
    """The global batch of ``step``: the same on every rank."""
    _, pad, scene = CONFIGS[config][model]
    return synthetic_batch(np.random.default_rng(10_000 + step), batch, pad,
                           num_classes=3 if config == "tiny" else 10, **scene)


def stage5(model: torch.nn.Module):
    return {n: list(p.shape) for n, p in model.named_parameters() if ".s5b" in n}


@contextlib.contextmanager
def _counting_all_reduces():
    """``[calls, bytes]`` of ``torch.distributed.all_reduce`` while open: the
    port's only collective in a training step."""
    count, real = [0, 0], dist.all_reduce

    def counted(t, *args, **kwargs):
        count[0] += 1
        count[1] += t.numel() * t.element_size()
        return real(t, *args, **kwargs)

    dist.all_reduce = counted
    try:
        yield count
    finally:
        dist.all_reduce = real


@contextlib.contextmanager
def _recording_scales(model: torch.nn.Module):
    """``{conv name: [[activation scale, *weight scales], ...]}`` of the
    fake quant of the row-split convs' places (``s5b*.c2``) while open, one
    entry per forward: the scales ``train/qat.py`` computed."""
    import re

    from cvm_tpu_torch.train import qat

    names = {id(m): n for n, m in model.named_modules() if re.search(r"s5b\d+\.c2\.conv$", n)}
    real_fq, real_act, real_w = qat.fq_conv, qat.act_scale, qat.weight_scale
    current, got = [None], {}

    def fq(conv, *args, **kwargs):
        current[0] = names.get(id(conv))
        try:
            return real_fq(conv, *args, **kwargs)
        finally:
            current[0] = None

    def act(*args, **kwargs):
        s = real_act(*args, **kwargs)
        if current[0]:
            got.setdefault(current[0], []).append([float(s)])
        return s

    def weight(*args, **kwargs):
        s = real_w(*args, **kwargs)
        if current[0]:
            got[current[0]][-1].extend(s.reshape(-1).tolist())
        return s

    qat.fq_conv, qat.act_scale, qat.weight_scale = fq, act, weight
    try:
        yield got
    finally:
        qat.fq_conv, qat.act_scale, qat.weight_scale = real_fq, real_act, real_w


def run_train(mesh, device, model: str, config: str, steps: int, tensor_parallel=False,
              ckdir=None, batch=None, qat=False, float32=False):
    batch = batch or GLOBAL_BATCH[config]
    fields, _, _ = CONFIGS[config][model]
    cfg = get_model(model).params_cls(**fields, batch_size=batch, warmup_steps=2,
                                      total_steps=100, tensor_parallel=tensor_parallel,
                                      qat=qat)
    trainer = Trainer(cfg, device if mesh is None else mesh.device, mesh=mesh,
                      checkpoint_dir=ckdir, checkpoint_every=steps, log_every=1)
    trainer.init_state()
    if float32:
        from cvm_tpu_torch.models.layers import Conv

        for m in trainer.state.model.modules():
            if isinstance(m, Conv):
                m.dtype = torch.float32  # every conv computes in float32
    rows = slice(None) if mesh is None else slice(*mesh.batch_rows(batch)[:2])
    losses, metrics, ms, reduces = [], [], [], []
    gaussian_splat.reset_counts()
    with (_recording_scales(trainer.state.model) if qat else contextlib.nullcontext({})) \
            as scales, _counting_all_reduces() as count:
        for step in range(steps):
            raw = {k: v[rows] for k, v in global_batch(step, model, config, batch).items()}
            t0 = time.perf_counter()
            m = trainer.fit(iter([raw]), 1)  # reads the metrics: the step has ended
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(m["loss"])
            metrics.append({k: v for k, v in m.items() if k != "steps_per_sec"})
            reduces.append(list(count))
            count[:] = [0, 0]
    whole = trainer.eval_params
    checksum = float(sum(v.to(torch.float64).sum() for v in whole.values()))
    return {"losses": losses, "metrics": metrics, "ms": ms, "checksum": checksum,
            "all_reduces": [n for n, _ in reduces], "all_reduce_bytes": [b for _, b in reduces],
            "k1": gaussian_splat.render_heatmap.launches,
            "shapes": stage5(trainer.state.model), "split": sorted(trainer.split),
            "scales": scales}


def run_stop(mesh, steps: int):
    fields, _, _ = CONFIGS["tiny"]["centernet"]
    cfg = get_model("centernet").params_cls(**fields, batch_size=GLOBAL_BATCH["tiny"],
                                            warmup_steps=2, total_steps=100)
    trainer = Trainer(cfg, mesh.device, mesh=mesh, log_every=100)
    trainer.init_state()
    rows = slice(*mesh.batch_rows(cfg.batch_size)[:2])

    def batches():
        for step in range(steps):
            if step == 2 and mesh.rank == mesh.world - 1:
                trainer.request_stop()
            yield {k: v[rows] for k, v in
                   global_batch(step, "centernet", "tiny", cfg.batch_size).items()}

    trainer.fit(batches(), steps)
    return {"step": trainer.state.step, "stop_requested": trainer.stop_requested}


def _targets(npz, device):
    t = {k[2:]: torch.from_numpy(npz[k]).to(device) for k in npz.files if k.startswith("t/")}
    return CenternetTargets(**t) if "heatmap" in t else t


def _rows(tree, rows: slice):
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_rows(v, rows) for v in tree))
    return tree[rows] if torch.is_tensor(tree) and tree.dim() > 0 else tree


def load_model(mesh, device, npz):
    """IN's model (``name``, ``cfg``, ``sd/<name>``) on ``device``, a
    ``spatial_shard`` head over ``mesh``; every conv in float32 when IN's
    ``float32`` is set."""
    from cvm_tpu_torch.models.layers import Conv, SpatialConv3x3

    spec = get_model(json.loads(str(npz["name"])))
    cfg = spec.params_cls.from_dict(json.loads(str(npz["cfg"])))
    model = build_model(spec, cfg, device, mesh=mesh)
    model.load_state_dict({k[3:]: torch.from_numpy(npz[k]) for k in npz.files
                           if k.startswith("sd/")}, strict=True)
    if "float32" in npz.files and bool(npz["float32"]):
        for m in model.modules():
            if isinstance(m, (Conv, SpatialConv3x3)):
                m.dtype = torch.float32  # every conv computes in float32
    return spec, cfg, model


def run_grads(mesh, device, path: str, steps: int):
    """The first step's averaged gradients and ``steps`` SGD steps' metrics
    on IN's processed inputs (identity processor), with SGD; the stage-5
    blocks split over the model axis when IN's config has
    ``tensor_parallel`` (the gradients of split tensors this rank's
    slices), and with its ``qat`` the ``s5b*.c2`` scales of every forward
    (``scales``, as ``run_train``'s)."""
    from cvm_tpu_torch.parallel.sharding import shard_module, split_norm, tp_rules_for

    npz = np.load(path)
    spec, cfg, model = load_model(mesh, device, npz)
    rows = slice(None) if mesh is None else slice(*mesh.batch_rows(cfg.batch_size)[:2])
    inputs = torch.from_numpy(npz["inputs"]).to(device)[rows]
    targets = _rows(_targets(npz, device), rows)
    split = {}
    if mesh is not None:
        from cvm_tpu_torch.models.layers import BatchNorm

        if getattr(cfg, "tensor_parallel", False):
            split = shard_module(model, mesh, tp_rules_for(spec.name))
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.reducer = mesh.reducer
    opt = make_optimizer(list(model.parameters()), cfg.learning_rate, cfg.total_steps,
                         cfg.warmup_steps, cfg.weight_decay, lr_schedule=cfg.lr_schedule,
                         optimizer=cfg.optimizer)
    if split:
        opt.norm = split_norm([n in split for n, _ in model.named_parameters()], mesh)
    state = create_train_state(model, cfg, opt)
    names = [n for n, _ in model.named_parameters()]
    grads = {}

    def capture(gen, raw, rows):
        return inputs, targets

    step = make_train_step(spec.loss_fn, cfg, capture, mesh=mesh)
    # the first step's gradients: those the optimizer receives
    real = opt.step

    def record(g):
        if not grads:
            grads.update({n: t.detach().cpu().numpy() for n, t in zip(names, g)})
        return real(g)

    opt.step = record
    metrics = []
    with (_recording_scales(model) if getattr(cfg, "qat", False)
          else contextlib.nullcontext({})) as scales:
        for _ in range(steps):
            state, m = step(state, None, None)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "split": sorted(split), "scales": scales}, grads


def run_bn(mesh, device, path: str):
    from cvm_tpu_torch.models.layers import BatchNorm

    npz = np.load(path)
    x, w = (torch.from_numpy(npz[k]).to(device) for k in ("x", "w"))
    rows = slice(None) if mesh is None else slice(*mesh.batch_rows(x.shape[0])[:2])
    x, w = x[rows].clone().requires_grad_(True), w[rows]
    bn = BatchNorm(x.shape[-1]).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(npz["scale"]))
        bn.bias.copy_(torch.from_numpy(npz["bias"]))
    if mesh is not None:
        bn.reducer = mesh.reducer
    y = bn(x)
    (y * w).sum().backward()
    return {}, {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy(),
                "running_mean": bn.running_mean.cpu().numpy(),
                "running_var": bn.running_var.cpu().numpy()}


def run_spatial(mesh, device, path: str):
    from cvm_tpu_torch.parallel.spatial import spatial_conv3x3

    npz = np.load(path)
    x, w, g = (torch.from_numpy(npz[k]).to(device) for k in ("x", "w", "g"))
    h = x.shape[1] // mesh.model
    rows = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
    x = x[:, rows].clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    y = spatial_conv3x3(x, w, mesh)
    (y * g[:, rows]).sum().backward()
    return {}, {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy(),
                "dw": w.grad.cpu().numpy()}


@torch.no_grad()
def run_forward(mesh, device, path: str):
    npz = np.load(path)
    _, _, model = load_model(mesh, device, npz)
    inputs = torch.from_numpy(npz["inputs"]).to(device)
    if mesh is not None:
        r = mesh.batch_rows(inputs.shape[0])
        out = mesh.replicated(model.eval()(inputs[r.start:r.stop]))
    else:
        out = model.eval()(inputs)
    return {}, {k: v.float().cpu().numpy() for k, v in out.items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serving_model(mesh, device, npz):
    """(config, model, pipeline options) of a ``serve`` or ``evaluate`` IN."""
    _, cfg, model = load_model(mesh, device, npz)
    opts = json.loads(str(npz["opts"]))
    if opts.get("w8a8") == "scales":
        opts["w8a8"] = json.loads(str(npz["scales"]))
    return cfg, model, opts


def run_serve(mesh, device, path: str, reps: int = 0):
    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    npz = np.load(path)
    cfg, model, opts = serving_model(mesh, device, npz)
    pipe = InferencePipeline(cfg, model, device, mesh=mesh, **opts)
    batch = {k[2:]: npz[k] for k in npz.files if k.startswith("b/")}
    fused_qconv.reset_counts()
    n0 = yuv_letterbox.yuv_letterbox.launches
    out = pipe(batch)
    _sync(device)
    k2 = fused_qconv.fused_qconv.launches
    letterbox = yuv_letterbox.yuv_letterbox.launches - n0
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipe(batch)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ({"k2": k2, "letterbox": letterbox, "ms": ms,
             "tensor_parallel": pipe.tensor_parallel},
            {k: v.cpu().numpy() for k, v in out.items()})


def run_evaluate(mesh, device, path: str):
    from cvm_tpu_torch.train.evaluate import evaluate_model

    npz = np.load(path)
    cfg, model, opts = serving_model(mesh, device, npz)
    rng = np.random.default_rng(999)
    pad = tuple(int(v) for v in npz["pad"])
    nc = min(getattr(cfg, "num_classes", getattr(cfg, "num_det_classes", 3)), 10)
    val = [synthetic_batch(rng, cfg.batch_size, pad, num_classes=nc)
           for _ in range(int(npz["batches"]))]
    return {"metrics": evaluate_model(cfg.name, cfg, model, val, device=device, mesh=mesh,
                                      **opts)}, {}


def _event(a, name: str) -> None:
    with open(a.out + ".events", "a") as f:
        f.write(f"{name} {a.rank} {time.time()!r} {os.environ.get('CVM_RESTART_COUNT', '-')}\n")


def _step_hooks(a) -> None:
    """``--hang_rank / --fail_rank`` at ``--hang_step``, and the ``first_step``
    and ``restart`` events, in every ``Trainer`` this process builds."""
    from cvm_tpu_torch.train import loop

    make, restart = loop.make_train_step, loop.Trainer._maybe_auto_restart
    first_image = "CVM_RESTART_COUNT" not in os.environ

    def make_step(*args, **kwargs):
        real, calls = make(*args, **kwargs), [0]

        def step(state, raw, gen):
            calls[0] += 1
            if first_image and calls[0] == a.hang_step and a.rank == a.hang_rank:
                sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
                from torch_hang_child import stall

                _event(a, "hang")
                stall(torch.device(a.device).type == "cuda")
            if first_image and calls[0] == a.hang_step and a.rank == a.fail_rank:
                raise RuntimeError(f"rank {a.rank} fails in step {calls[0]} (--fail_rank)")
            out = real(state, raw, gen)
            if calls[0] == 1:
                float(out[1]["loss"])  # waits for the device
                _event(a, "first_step")
            return out

        return step

    def stamped_restart(self, quiet_s):
        _event(a, "restart")
        restart(self, quiet_s)

    loop.make_train_step = make_step
    loop.Trainer._maybe_auto_restart = stamped_restart


def run_cli(a):
    import contextlib
    import importlib
    import io

    from cvm_tpu_torch.parallel import mesh

    _event(a, "start")
    argv = json.loads(a.argv) + ["--coordinator", f"127.0.0.1:{a.port}", "--num_processes",
                                 str(a.world), "--process_id", str(a.rank)]
    if a.hang_rank >= 0 or a.fail_rank >= 0:
        _step_hooks(a)
    if a.tiny_benchmark:
        from cvm_tpu_torch.cli import benchmark

        benchmark._configs = lambda: {
            "A": ("semseg", get_model("semseg").params_cls(**CONFIGS["tiny"]["semseg"][0],
                                                           batch_size=1), "infer"),
            "E": ("centernet", get_model("centernet").params_cls(
                **CONFIGS["tiny"]["centernet"][0], batch_size=2), "train")}
    form = mesh.init_distributed

    def init(*args, **kw):
        # the CLI forms its group on this run's backend (gloo lets ranks
        # share a card), its collectives timing out after --timeout
        dev = form(*args, **dict(kw, backend=a.backend))
        if a.timeout:
            from torch.distributed.distributed_c10d import _set_pg_timeout

            _set_pg_timeout(datetime.timedelta(seconds=a.timeout), dist.group.WORLD)
        return dev

    mesh.init_distributed = init
    if a.slow_best:
        from cvm_tpu_torch.train.checkpoints import BestCheckpoint

        update, slept = BestCheckpoint.update, []

        def slow_update(self, *args, **kw):
            if not slept:
                time.sleep(a.slow_best)
                slept.append(a.slow_best)
            return update(self, *args, **kw)

        BestCheckpoint.update = slow_update
    if a.late_best and a.rank:
        real = mesh.Mesh.from_rank0

        def late(self, name, fn):
            if name == "best":
                time.sleep(a.late_best)
            return real(self, name, fn)

        mesh.Mesh.from_rank0 = late
    gaussian_splat.reset_counts()
    fused_qconv.reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(a.module).main(argv)
    return {"rc": rc, "stdout": out.getvalue(), "k1": gaussian_splat.render_heatmap.launches,
            "k2": fused_qconv.fused_qconv.launches}


def run_local(a) -> int:
    """``local`` mode: ``M.main`` as the launcher of ``cli``-mode ranks."""
    import importlib

    from cvm_tpu_torch.parallel import mesh

    hooks = ["--timeout", a.timeout, "--hang_rank", a.hang_rank, "--fail_rank", a.fail_rank,
             "--hang_step", a.hang_step] + (["--tiny_benchmark"] if a.tiny_benchmark else [])

    def rank_command(module, argv, rank, world, port):
        return [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world",
                str(world), "--port", str(port), "--device", a.device, "--backend", a.backend,
                "--out", f"{a.out}.rank{rank}", *map(str, hooks), "cli", "--module", module,
                "--argv", json.dumps(list(argv))]

    mesh.rank_command = rank_command
    return importlib.import_module(a.module).main(json.loads(a.argv))


# The modes that take several IN: mode -> run(mesh, device, IN, flags).
RUNS = {"grads": lambda mesh, device, path, a: run_grads(mesh, device, path, a.steps),
        "spatial": lambda mesh, device, path, a: run_spatial(mesh, device, path),
        "forward": lambda mesh, device, path, a: run_forward(mesh, device, path),
        "serve": lambda mesh, device, path, a: run_serve(mesh, device, path, a.reps),
        "evaluate": lambda mesh, device, path, a: run_evaluate(mesh, device, path)}


def launch(world: int, args, out_dir: str, device: str = "cpu", timeout: float = 300.0,
           backend: str = "gloo"):
    """Run ``world`` ranks of this script with ``args`` (a mode and its
    flags) and return each rank's (JSON result, arrays or None), by rank.
    Raises with a rank's errors when one fails or the run outlasts
    ``timeout`` seconds; no rank outlives the call."""
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"rank{r}.json") for r in range(world)]
    launch_ranks(world, lambda r, port: [
        sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(world),
        "--port", str(port), "--device", device, "--backend", backend, "--out", outs[r],
        *map(str, args)], timeout)
    results = []
    for out in outs:
        with open(out) as f:
            res = json.load(f)
        arrays = dict(np.load(out + ".npz")) if os.path.exists(out + ".npz") else None
        results.append((res, arrays))
    return results


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default="gloo")
    p.add_argument("--out", required=True)
    p.add_argument("mode", choices=["train", "grads", "bn", "stop", "join", "spatial",
                                    "forward", "serve", "evaluate", "cli", "local"])
    p.add_argument("--model", default="centernet")
    p.add_argument("--config", default="tiny")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--tensor_parallel", action="store_true")
    p.add_argument("--qat", action="store_true")
    p.add_argument("--float32", action="store_true")
    p.add_argument("--ckdir", default=None)
    p.add_argument("--npz", default=None)
    p.add_argument("--reps", type=int, default=0)
    p.add_argument("--module", default=None)
    p.add_argument("--argv", default="[]")
    p.add_argument("--timeout", type=float, default=0.0)
    p.add_argument("--slow_best", type=float, default=0.0)
    p.add_argument("--late_best", type=float, default=0.0)
    p.add_argument("--hang_rank", type=int, default=-1)
    p.add_argument("--fail_rank", type=int, default=-1)
    p.add_argument("--hang_step", type=int, default=4)
    p.add_argument("--tiny_benchmark", action="store_true")
    a = p.parse_args()
    if a.device == "cpu":
        torch.set_num_threads(1)
    # as chip_smoke.py sets them for the one-process run it compares against
    # (deterministic cuDNN: two runs of one command otherwise drift apart)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    if a.mode == "local":  # the CLI launches the ranks
        rc = run_local(a)
        with open(a.out, "w") as f:
            json.dump({"rc": rc}, f)
        return 0
    if a.mode == "cli":  # the CLI forms the group
        out = run_cli(a)
        with open(a.out, "w") as f:
            json.dump(dict(out, rank=a.rank), f)
        return 0
    device = init_distributed(f"127.0.0.1:{a.port}", a.world, a.rank, a.device,
                              backend=a.backend)
    try:
        mesh = make_mesh(a.model_parallel, device)
        out, arrays = {}, {}
        if a.mode == "train":
            out = run_train(mesh, device, a.model, a.config, a.steps, a.tensor_parallel,
                            a.ckdir, a.batch, a.qat, a.float32)
        elif a.mode == "bn":
            out, arrays = run_bn(mesh, device, a.npz)
        elif a.mode == "stop":
            out = run_stop(mesh, a.steps)
        elif a.mode in RUNS:
            outs, meshes = [], {a.model_parallel: mesh}
            for i, path in enumerate(a.npz.split(",")):
                with np.load(path) as npz:  # an IN may name its own mode and model axis
                    mode = str(npz["mode"]) if "mode" in npz.files else a.mode
                    axis = (int(npz["model_parallel"]) if "model_parallel" in npz.files
                            else a.model_parallel)
                if axis not in meshes:
                    meshes[axis] = make_mesh(axis, device)
                o, arr = RUNS[mode](meshes[axis], device, path, a)
                outs.append(o)
                arrays.update({f"{i}/{k}" if "," in a.npz else k: v for k, v in arr.items()})
            out = {"results": outs} if "," in a.npz else outs[0]

    finally:
        shutdown_distributed()
    if arrays:
        np.savez(a.out + ".npz", **arrays)
    with open(a.out, "w") as f:
        json.dump(dict(out, rank=a.rank), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
