"""One CUDA graph per input signature: ``InferencePipeline.predict``'s whole
device step (preprocess, forward, postprocess) replayed with one launch in
place of the hundreds of eager launches a batch-1 frame costs the host.

``StepGraphs`` keeps the graphs of one pipeline. A signature is the (shape,
dtype) of every input in order; values (``image_hw``, the planes) are data,
so frames of any valid size in one buffer shape share a graph. The first
call with a signature runs the step eagerly (it settles cuDNN's choices,
the allocator and lazy set-up); the second records the step as a graph
(``capture``: a side stream, the graph's own memory pool) on static copies
of its inputs and replays it; later calls copy their inputs into those
buffers and replay. At most ``MAX_GRAPHS`` signatures get a graph; the
rest run eagerly. Outputs are returned as clones, so no later replay
overwrites a result a caller holds. Weights are read where they live:
loading new ones in place (``load_state_dict``) needs no new capture.

A replay runs no Python: a function swapped in after the capture (a plain
version in place of a kernel) is never reached by it, so compare such a
swap on a pipeline that has not captured. The kernel wrappers count their
launches in Python, so each replay adds to every counter registered with
``utils/prof.py::launch_counter`` what its capture saw it move: a counter
reads the same whether a call replayed or ran eagerly.

A pipeline that cannot be captured (``blocked``: its device is not CUDA,
or a mesh's collectives run inside its step) always runs eagerly.
``counts`` says how often each path ran: ``captures``, ``replays`` (calls
served by a graph, the capturing call included) and the eager calls by
reason (``first_sighting``, ``cap``, and the ``blocked`` reasons ``cpu`` and
``mesh``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from cvm_tpu_torch.utils import prof
from cvm_tpu_torch.utils.prof import span

MAX_GRAPHS = 4

Step = Callable[..., Dict[str, torch.Tensor]]


def capture(step: Step, inputs: Sequence[torch.Tensor]
            ) -> Tuple[Callable[[], None], Dict[str, torch.Tensor]]:
    """Record ``step(*inputs)`` as a CUDA graph on a side stream, in a
    memory pool of its own; ``(replay, outputs)``: ``replay()`` runs the
    recorded kernels again on the current stream, rewriting ``outputs``.
    A failed capture raises. Only this thread's calls are held to the
    capture's rules: another thread's (a checkpoint writer's copies) go
    on."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outputs = step(*inputs)
    return graph.replay, outputs


def blocked_by(device: torch.device, mesh) -> Optional[str]:
    """Why a pipeline on ``device`` with ``mesh`` may capture no graph:
    ``"cpu"`` off CUDA, ``"mesh"`` where collectives run inside the step;
    None where it may."""
    if device.type != "cuda":
        return "cpu"
    return "mesh" if mesh is not None else None


def _read(counters) -> List[int]:
    return [getattr(owner, name) for owner, name in counters]


class _Graph(NamedTuple):
    replay: Callable[[], None]
    inputs: List[torch.Tensor]
    outputs: Dict[str, torch.Tensor]
    launches: List[Tuple[object, str, int]]   # (owner, counter, what the capture added)


def signature(data: Sequence[torch.Tensor]) -> tuple:
    """The (shape, dtype) of each input, in order."""
    return tuple((tuple(t.shape), t.dtype) for t in data)


class StepGraphs:
    """The graphs of one pipeline's ``step`` on ``device`` (module
    docstring); ``blocked`` names why none may be captured, or is None."""

    def __init__(self, step: Step, device: torch.device, blocked: Optional[str]):
        self.step, self.device, self.blocked = step, device, blocked
        self.counts = dict.fromkeys(
            ("captures", "replays", "first_sighting", "cap", "cpu", "mesh"), 0)
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: set = set()

    @torch.no_grad()
    def __call__(self, data: Sequence[torch.Tensor], h2d: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """One call of the step on ``data``, tensors on any device: a
        replay, a capture and its replay, or the eager step. ``h2d``: the
        tensors are the host's, and their one copy to the device (into a
        graph's input buffers where one replays) is the span
        ``cvm.infer.h2d``."""
        copying = span("cvm.infer.h2d") if h2d else contextlib.nullcontext()
        sig = signature(data)
        graph, reason = self._graphs.get(sig), self.blocked
        if reason is None and graph is None:
            if len(self._graphs) >= MAX_GRAPHS:
                reason = "cap"
            elif sig not in self._seen:
                self._seen.add(sig)
                reason = "first_sighting"
        if reason is not None:
            with copying:
                data = [t.to(self.device) for t in data]
            self.counts[reason] += 1
            return self.step(*data)
        with copying:
            if graph is None:
                inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device).copy_(t)
                          for t in data]
            else:
                for buf, t in zip(graph.inputs, data):
                    buf.copy_(t)
        if graph is None:  # the capture moved the counters itself
            return self._replay(self._capture(sig, inputs), counted=True)
        return self._replay(graph)

    def _capture(self, sig: tuple, inputs: List[torch.Tensor]) -> _Graph:
        counters = list(prof.LAUNCH_COUNTERS)
        before = _read(counters)
        replay, outputs = capture(self.step, inputs)
        added = [(owner, name, a - b) for (owner, name), a, b
                 in zip(counters, _read(counters), before) if a != b]
        graph = _Graph(replay, inputs, outputs, added)
        self._graphs[sig] = graph
        self.counts["captures"] += 1
        return graph

    def _replay(self, graph: _Graph, counted: bool = False) -> Dict[str, torch.Tensor]:
        """Run ``graph`` on what its input buffers hold; clones of its
        outputs."""
        with span("cvm.infer.replay"):
            graph.replay()
            out = {k: v.clone() for k, v in graph.outputs.items()}
        if not counted:
            for owner, name, n in graph.launches:
                setattr(owner, name, getattr(owner, name) + n)
        self.counts["replays"] += 1
        return out
