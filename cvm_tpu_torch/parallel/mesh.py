"""Process groups for multi-process training: the counterpart of
``cvm_tpu/parallel/mesh.py``.

The reference builds a ("data", "model") ``jax.sharding.Mesh`` over every
device of every host and lets GSPMD insert the collectives; one controller
per host feeds its slice of the global batch (``global_put``). The port
uses PyTorch's idiom: one process per card, joined by
``torch.distributed``. ``init_distributed`` forms the group (NCCL between
cards, gloo on the CPU), ``make_mesh`` lays the ranks out as a (data,
model) grid, model index fastest, as the reference's device array is, and
holds a process group along each axis.

The batch is split over the data axis only: the ranks of one model group
hold the same rows (the Megatron idiom; the reference splits its batch
over both axes and lets GSPMD move activations). ``cfg.batch_size`` stays
the global batch, and every batch-wide reduction is over it
(``parallel/reduce.py``); the gradients are summed over the data group
(``all_reduce_grads``). The reference's ``dcn_slices`` (the device order of
a multi-slice TPU deployment) is not ported: NCCL picks its own ring or
tree over the nodes.

Serving (the reference's ``batch_sharding``, ``replicated``, ``global_put``
and ``shard_batch``, ``cvm_tpu/parallel/mesh.py:88-127``): a serving batch
is padded to a multiple of the data ranks by repeating its last row, each
data rank takes its rows (``Mesh.shard_batch``: the reference's
``global_put`` of a process's local rows, on the batch sharding), and every
result is all-gathered back to every rank in row order
(``Mesh.replicated``: the reference's ``out_shardings=replicated``). The
reference splits a serving batch over both axes; here the ranks of one
model group take the same rows, as in training.

Launching (``run_local_ranks``, the one launcher; ``launch_local`` for the
CLIs, ``launch_ranks`` for the tests): the reference's one controller per
host drives every chip of it, so a CLI run without ``--coordinator`` uses
every visible card. Here that is one rank per card, each a ``python -m
<cli>`` child with this rank's process flags, started on 127.0.0.1 by the
command the user ran, which waits for them: rank 0 writes to its output,
SIGTERM and SIGINT are forwarded, the other ranks are killed as soon as
one fails, and all are started again when a rank's watchdog asks for a
restart (``RESTART_EXIT``). ``--coordinator`` keeps its contract over
hosts: one process per card, each started by hand.

Nothing falls back: a group that cannot form within ``timeout_s``, or two
NCCL ranks that would share a card, raise, naming the cause; a rank that
fails to start or join fails the whole command.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer, GroupReducer
from cvm_tpu_torch.pipeline.preprocess import BatchRows
from cvm_tpu_torch.utils.batch import pad_rows
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 60.0
# How long the other ranks wait while rank 0 alone writes a checkpoint.
RANK0_TIMEOUT_S = 3600.0
# The most gradient bytes one all-reduce carries.
GRAD_BUCKET_BYTES = 32 << 20

_STORE: List[Any] = [None]  # the store of the group init_distributed formed


def _card(dev: torch.device) -> str:
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: DeviceLike, backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group of ``num_processes`` processes, whose
    rank 0 serves the rendezvous at ``coordinator`` ("host:port"), as
    ``process_id``; returns this rank's device.

    ``device`` "cuda" gives rank r the card ``cuda:{r % device_count}``;
    "cuda:N" or "cpu" are taken as they are. ``backend`` is NCCL for a
    card and gloo for the CPU unless named: gloo on a card lets two ranks
    share it. Collectives time out after ``timeout_s`` seconds (a dead
    peer would otherwise hang the others for 30 minutes)."""
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of {num_processes} processes")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be 'host:port', got {coordinator!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    dev = resolve_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device; use gloo on the CPU")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already in this process")
    timeout = datetime.timedelta(seconds=timeout_s)
    where = f"rank {process_id} of {num_processes} at {coordinator}"
    try:
        store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                              timeout=timeout, wait_for_workers=True)
        if backend == "nccl":
            # NCCL refuses two ranks on one card only inside its own init,
            # as "Duplicate GPU detected"; this names the card and ranks.
            store.set(f"card/{process_id}", _card(dev))
            cards = [store.get(f"card/{r}").decode() for r in range(num_processes)]
    except RuntimeError as e:  # DistStoreError (a timeout) is one
        raise RuntimeError(f"the process group did not form ({where}) within "
                           f"{timeout_s:g} s: {e}") from e
    if backend == "nccl":
        for r, card in enumerate(cards):
            other = cards.index(card)
            if other != r:
                raise RuntimeError(
                    f"NCCL ranks {other} and {r} would share the card {card}: NCCL needs "
                    "a card per rank; start at most torch.cuda.device_count() processes "
                    "per host, or pass backend='gloo' to share a card")
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, store=store, rank=process_id,
                                world_size=num_processes, timeout=timeout)
        # One all-reduce now: NCCL forms its communicator at the first
        # collective, and a backend that cannot run one fails here, named.
        t = torch.ones(1, device=dev)
        dist.all_reduce(t)
        if int(t.item()) != num_processes:
            raise RuntimeError(f"a test all-reduce gave {t.item()}, not {num_processes}")
    except RuntimeError as e:
        raise RuntimeError(f"the {backend} process group failed ({where}): {e}") from e
    _STORE[0] = store
    return dev


def shutdown_distributed() -> None:
    """Leave the default process group (when there is one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE[0] = None


class Mesh:
    """This rank's place in the (data, model) grid of the default process
    group: ``data`` x ``model`` ranks, rank = data_index * model +
    model_index; ``data_group`` joins the ranks of this model index (the
    batch is split over it), ``model_group`` those of this data index (the
    tensor-parallel shards). A group of one rank is None."""

    def __init__(self, data: int, model: int, rank: int, device: torch.device,
                 data_group=None, model_group=None, store=None):
        self.data, self.model, self.rank, self.device = data, model, rank, device
        self.data_group, self.model_group, self._store = data_group, model_group, store
        self._seq = 0

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_rank0(self) -> bool:
        return self.rank == 0

    def batch_rows(self, global_batch: int) -> BatchRows:
        """This rank's rows of a global batch (the same for every rank of a
        model group)."""
        if global_batch % self.data:
            raise ValueError(f"batch_size {global_batch} not divisible by {self.data} "
                             "data-parallel processes")
        n = global_batch // self.data
        return BatchRows(self.data_index * n, (self.data_index + 1) * n, global_batch)

    def shard_batch(self, arrays: Sequence, total: int) -> Tuple[np.ndarray, ...]:
        """This data rank's rows of a serving batch: each batch-first array
        padded to ``total`` rows rounded up to a multiple of the data ranks,
        by repeating its last row, then cut to this rank's share."""
        total = -(-total // self.data) * self.data
        rows = self.batch_rows(total)
        return tuple(a[rows.start:rows.stop] for a in pad_rows(arrays, total))

    def replicated(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Every data rank's rows of each result (tensors or numpy arrays,
        as given) on every rank, in row order: one all-gather of its bytes
        over the data group, so any dtype goes through gloo and NCCL
        alike."""
        if self.data == 1:
            return dict(out)
        return {k: (all_gather_rows(v, self.data_group, self.data) if torch.is_tensor(v)
                    else all_gather_rows(torch.from_numpy(np.ascontiguousarray(v))
                                         .to(self.device), self.data_group,
                                         self.data).cpu().numpy())
                for k, v in out.items()}

    def __deepcopy__(self, memo):
        return self  # process groups are not copied (a model copy shares its mesh)

    @property
    def reducer(self) -> BatchReducer:
        """The batch-wide reductions of a loss or a BatchNorm on this rank."""
        return LOCAL if self.data == 1 else GroupReducer(self.data_group, self.data)

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the data group of each rank's gradients (the true
        gradient; ``parallel/reduce.py``), flattened into buckets of at most
        ``GRAD_BUCKET_BYTES`` so that each is one all-reduce."""
        grads = list(grads)
        if self.data == 1:
            return grads
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        bucket: List[int] = []

        def flush():
            flat = torch.cat([grads[i].reshape(-1) for i in bucket])
            dist.all_reduce(flat, group=self.data_group)
            flat /= self.data
            for i, part in zip(bucket, flat.split([grads[i].numel() for i in bucket])):
                out[i] = part.view_as(grads[i])
            bucket.clear()

        size = 0
        for i, g in enumerate(grads):
            if bucket and (g.dtype != grads[bucket[0]].dtype
                           or size + g.numel() * g.element_size() > GRAD_BUCKET_BYTES):
                flush()
                size = 0
            bucket.append(i)
            size += g.numel() * g.element_size()
        flush()
        return out

    def any_rank(self, flag: bool) -> torch.Tensor:
        """Whether ``flag`` is set on any rank, as a one-element CPU tensor
        (pinned when the ranks are on cards) that holds the answer once the
        device has run the work enqueued before this call: the host does not
        wait for the all-reduce here, so read the tensor after an event
        recorded after this call has completed."""
        t = torch.full((1,), int(flag), dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        if self.device.type != "cuda":
            return t
        host = torch.empty(1, dtype=torch.int32, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def check_replicas(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless every rank holds the same ``tensors`` (a float64
        checksum, its max and min over the ranks in one all-reduce)."""
        if self.world == 1:
            return
        with torch.no_grad():
            c = torch.stack([t.detach().to(torch.float64).sum() for t in tensors]).sum()
            both = torch.stack([c, -c])
            dist.all_reduce(both, op=dist.ReduceOp.MAX)
        hi, lo = float(both[0]), -float(both[1])
        if hi != lo:
            raise RuntimeError(f"the ranks hold different {what} (checksums from {lo!r} to "
                               f"{hi!r}): every rank must build the same seeded init")

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank (tensors in it go through the CPU)."""
        if self.world == 1:
            return obj
        box = [obj if self.is_rank0 else None]
        dist.broadcast_object_list(box, src=0,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def _key(self, name: str) -> str:
        self._seq += 1
        return f"mesh/{name}/{self._seq}"

    def from_rank0(self, name: str, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on rank 0 alone while the other ranks wait (through the
        rendezvous store, so that a long write does not trip the
        collectives' timeout); its (picklable) result on every rank. Every
        rank calls this at the same point."""
        if self.world == 1:
            return fn()
        key = self._key(name)
        if self.is_rank0:
            value = fn()
            self._store.set(key, pickle.dumps(value))
            return value
        self._store.wait([key], datetime.timedelta(seconds=RANK0_TIMEOUT_S))
        return pickle.loads(self._store.get(key))

    def gather_to_rank0(self, name: str, obj: Any) -> Optional[List[Any]]:
        """Every rank's (picklable) ``obj`` as a list on rank 0, by rank; None
        elsewhere."""
        if self.world == 1:
            return [obj]
        key = self._key(name)
        self._store.set(f"{key}/{self.rank}", pickle.dumps(obj))
        if not self.is_rank0:
            return None
        return [pickle.loads(self._store.get(f"{key}/{r}")) for r in range(self.world)]


def all_gather_rows(t: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """The ``size`` ranks' ``t`` (one shape on every rank) concatenated
    along ``dim`` in rank order: an ``all_gather`` of its bytes over
    ``group``, which gloo runs on CPU and CUDA tensors and NCCL on CUDA
    ones."""
    t = t.contiguous()
    flat = t.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    return torch.cat([p.view(t.dtype).view(t.shape) for p in parts], dim=dim)


def add_process_args(parser) -> None:
    """The multi-process flags of ``cli.train`` and the serving CLIs: one
    process per card. Without ``--coordinator`` the command runs one rank
    per visible card (or ``--num_processes`` ranks) on this host
    (``launch_local``); with it, this process is one rank of a group
    started by hand, with the same arguments but its ``--process_id``."""
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="multi-process run over hosts: rank 0's rendezvous address; "
                             "launch one process per card with the same arguments plus "
                             "--process_id; requires --num_processes")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="the number of ranks; without --coordinator, ranks started on "
                             "this host (default: one per visible card with --device cuda)")
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--restart_by_exit", action="store_true",
                        help="set by the launcher on the ranks it starts: the watchdog's "
                             "--auto_restart exits for the launcher to start every rank "
                             "again, instead of re-exec'ing one")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="the process group's backend (default: nccl on cards, gloo on "
                             "the CPU; gloo lets ranks share a card)")


def process_count(parser, args) -> int:
    """The number of ranks ``add_process_args``' flags ask for: with
    ``--coordinator``, ``--num_processes`` (a parser error when a flag is
    missing); without, ``--num_processes`` or, for ``--device cuda``, every
    visible card (``CUDA_VISIBLE_DEVICES`` narrows them), else 1."""
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            parser.error("--coordinator requires --num_processes and --process_id")
        return args.num_processes
    if args.num_processes is not None:
        if args.num_processes < 1:
            parser.error(f"--num_processes must be >= 1, got {args.num_processes}")
        return args.num_processes
    if args.device == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


@contextlib.contextmanager
def process_mesh(args, device: DeviceLike, model_axis: int = 1
                 ) -> Iterator[Tuple[DeviceLike, Optional["Mesh"]]]:
    """``(device, mesh)`` of this process under ``add_process_args``' flags:
    the group formed at ``--coordinator`` (on ``--backend``) with this
    rank's device and its (data, model) mesh, left when the block ends
    (after a barrier, unless it raised); ``(device, None)`` without
    ``--coordinator``."""
    if args.coordinator is None:
        yield device, None
        return
    dev = init_distributed(args.coordinator, args.num_processes, args.process_id, device,
                           backend=args.backend)
    try:
        yield dev, make_mesh(model_axis, dev)
        # Rank 0 serves the store: it leaves once every rank is done with
        # it (another rank may not yet have read rank 0's last from_rank0).
        dist.barrier()
    finally:
        shutdown_distributed()


def free_port() -> int:
    """A port of 127.0.0.1 free at the time of asking (the OS picks it)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# A rank's exit code RESTART_EXIT + k asks ``run_local_ranks`` to start every
# rank again, for the k-th time (the stall watchdog's ``--auto_restart`` under
# ``--restart_by_exit``, ``train/loop.py``). The rank says k, as it alone
# knows whether it checkpointed past its resume point, which resets the count.
RESTART_EXIT = 100
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tail(f, limit: Optional[int] = 4000) -> str:
    f.seek(0)
    text = f.read().decode(errors="replace")
    return text if limit is None else text[-limit:]


def run_local_ranks(n: int, command: Callable[[int, int], List[str]], capture: bool = False,
                    timeout_s: Optional[float] = None, cwd: Optional[str] = None,
                    threads: Optional[int] = None) -> Tuple[int, List[str], List[str]]:
    """Run ``n`` ranks of one job on this host: rank r runs ``command(r,
    port)``, ``port`` a free port of 127.0.0.1 for their rendezvous, each
    with ``threads`` CPU threads (default: ``OMP_NUM_THREADS``, else this
    host's cores shared out).
    Returns the job's exit code, each rank's standard output and each failed
    rank's errors.

    Rank 0 writes to this process's standard output and errors, unless
    ``capture``; every other rank's output is kept and the end of it shown
    when it fails. SIGTERM and SIGINT are forwarded to every rank. When a
    rank fails, the others are killed at once (an NCCL peer would otherwise
    wait out its timeout), as they are when the job outlasts ``timeout_s``
    (exit code 124). A rank that exits with ``RESTART_EXIT`` + k has every
    rank killed and started again on a fresh port, with
    ``CVM_RESTART_COUNT`` k in their environment. No rank outlives the call, nor this
    process (Linux kills it with SIGKILL when this process dies)."""
    import ctypes

    env = dict(os.environ)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    env["PYTHONPATH"] = os.pathsep.join([_PACKAGE_ROOT]
                                        + [p for p in [env.get("PYTHONPATH")] if p])
    libc = ctypes.CDLL(None)  # PR_SET_PDEATHSIG (1) in each rank between fork and exec
    die_with_parent = functools.partial(libc.prctl, 1, int(signal.SIGKILL))
    procs: List[subprocess.Popen] = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    handlers = {}
    if threading.current_thread() is threading.main_thread():
        handlers = {sig: signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            with contextlib.ExitStack() as files:
                outs, errs = ([files.enter_context(tempfile.TemporaryFile()) for _ in range(n)]
                              for _ in range(2))
                port = free_port()
                procs[:] = [subprocess.Popen(command(r, port), cwd=cwd, env=env,
                                             stdout=outs[r] if capture or r else None,
                                             stderr=errs[r] if capture or r else None,
                                             start_new_session=True,
                                             preexec_fn=die_with_parent)
                            for r in range(n)]
                print(f"[cvm_tpu_torch] launched {n} local ranks, pids "
                      f"{[p.pid for p in procs]}, rendezvous 127.0.0.1:{port}",
                      file=sys.stderr, flush=True)
                failed, rc = None, 0
                try:
                    while failed is None:
                        codes = [p.poll() for p in procs]
                        bad = [r for r, c in enumerate(codes) if c]
                        if bad:  # a restart asked for, else the first failure seen
                            failed = next((r for r in bad if RESTART_EXIT < codes[r] < 256),
                                          bad[0])
                            rc = codes[failed]
                        elif None not in codes:
                            break
                        elif deadline is not None and time.monotonic() > deadline:
                            failed, rc = -1, 124
                        time.sleep(0.05)
                finally:
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                        p.wait()
                if RESTART_EXIT < rc < 256:
                    print(f"[cvm_tpu_torch] rank {failed} asked for restart "
                          f"{rc - RESTART_EXIT}: every rank starts again from the newest "
                          "checkpoint", file=sys.stderr, flush=True)
                    env["CVM_RESTART_COUNT"] = str(rc - RESTART_EXIT)
                    continue
                said = [_tail(outs[r], None) for r in range(n)] if capture else []
                problems = [f"rank {r} exited {p.returncode}:\n{_tail(errs[r])}{_tail(outs[r])}"
                            for r, p in enumerate(procs) if (capture or r) and (
                                r == failed or p.returncode not in (0, -signal.SIGKILL))]
                if rc == 124:
                    problems.insert(0, f"the ranks outlasted {timeout_s} s")
                elif failed == 0 and not capture:
                    problems.insert(0, f"rank 0 exited {rc}")
                if problems and not capture:
                    print("[cvm_tpu_torch] " + "\n".join(problems), file=sys.stderr, flush=True)
                return (rc if rc >= 0 else 128 - rc), said, problems
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)


def launch_ranks(n: int, argv: Callable[[int, int], List[str]], timeout_s: float,
                 cwd: Optional[str] = None) -> List[str]:
    """``run_local_ranks`` with every rank's output captured and one CPU
    thread each: their standard outputs, by rank. Raises with every failed
    rank's errors when one fails or the run outlasts ``timeout_s``."""
    rc, outs, problems = run_local_ranks(n, argv, capture=True, timeout_s=timeout_s, cwd=cwd,
                                         threads=1)
    if rc:
        raise RuntimeError("\n".join(problems) or f"the ranks exited {rc}")
    return outs


def launch_local(args, world: int, module: str, argv: Optional[Sequence[str]]) -> Optional[int]:
    """Without ``--coordinator`` and with more than one rank: run
    ``world`` ranks of ``python -m module`` on this host, each with
    ``argv`` (this process's arguments when None) plus
    ``--restart_by_exit`` and its process flags, and return the job's exit
    code (``run_local_ranks``). None when this process is the whole run
    (one rank) or a rank of a group."""
    if args.coordinator is not None or world == 1:
        return None
    argv = [*(sys.argv[1:] if argv is None else argv), "--restart_by_exit"]
    return run_local_ranks(world, lambda r, port: rank_command(module, argv, r, world, port))[0]


def rank_command(module: str, argv: Sequence[str], rank: int, world: int,
                 port: int) -> List[str]:
    """Rank ``rank``'s command line under ``launch_local``."""
    return [sys.executable, "-m", module, *argv, "--coordinator", f"127.0.0.1:{port}",
            "--num_processes", str(world), "--process_id", str(rank)]


def single_mesh(device: DeviceLike) -> Mesh:
    """The mesh of one process without a group."""
    return Mesh(1, 1, 0, resolve_device(device))


def make_mesh(model_axis: int, device: DeviceLike) -> Mesh:
    """The (data, model) mesh over the default process group, ``model_axis``
    ranks on the model axis, on ``device`` (the one ``init_distributed``
    returned); a one-rank mesh on ``device`` without a group. Every rank of
    the group calls this (it creates the subgroups)."""
    if not dist.is_initialized():
        if model_axis != 1:
            raise ValueError(f"1 process not divisible by model_axis={model_axis}")
        return single_mesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"{world} processes not divisible by model_axis={model_axis}")
    data = world // model_axis
    data_group = model_group = None
    # new_group is collective: every rank creates every group, in one order.
    for m in range(model_axis):
        ranks = [d * model_axis + m for d in range(data)]
        g = (None if data == 1 else dist.group.WORLD if data == world
             else dist.new_group(ranks))
        if rank in ranks:
            data_group = g
    for d in range(data):
        ranks = [d * model_axis + m for m in range(model_axis)]
        g = (None if model_axis == 1 else dist.group.WORLD if model_axis == world
             else dist.new_group(ranks))
        if rank in ranks:
            model_group = g
    return Mesh(data, model_axis, rank, resolve_device(device), data_group, model_group,
                _STORE[0])
