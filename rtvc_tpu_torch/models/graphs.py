"""What the student's CUDA-graph workspaces share (:mod:`.decode_graph`,
:mod:`.encode_graph`).

:func:`graphs_apply` is the choice both make from what a call can observe.
A :class:`GraphRegistry` keeps a model's workspaces, one a key of shapes,
and counts ``replays``, ``eager`` and ``captures``. Each workspace has a
``lock``; :meth:`GraphRegistry.checkout` hands one out locked, or None
where another thread holds it or the registry, and that call runs the
eager body instead of waiting. A copy of the model (``deepcopy``,
pickling) starts with no workspace: a graph belongs to the tensors it was
captured on.

A workspace warms its body up and captures it on a side stream
(:func:`capturing`), each graph in a private memory pool with
``capture_error_mode="thread_local"`` (:func:`capture`). The kernel
wrappers count their launches in Python: :func:`capturing` takes back what
the warm-up and the capture added, :func:`capture` returns what one graph
launches, and a replay adds that (:func:`add_counts`), so the counts read
as the eager path's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple, TypeVar

import torch

Counters = List[Tuple[object, str]]
W = TypeVar("W")


def read_counts(counters: Counters) -> List[int]:
    return [getattr(fn, attr) for fn, attr in counters]


def add_counts(counters: Counters, deltas: List[int], sign: int = 1) -> None:
    for (fn, attr), d in zip(counters, deltas):
        if d:
            setattr(fn, attr, getattr(fn, attr) + sign * d)


def graphs_apply(model: torch.nn.Module, x: torch.Tensor) -> bool:
    """Whether a call of ``model`` on ``x`` may replay graphs: real CUDA
    tensors, no compiler or export tracing, no stream capture under way,
    eval mode and grad off."""
    return (type(x) is torch.Tensor and x.is_cuda
            and not model.training and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def capturing(device: torch.device, counters: Counters) -> Iterator[None]:
    """A side stream of ``device`` for a warm-up and captures: it waits for
    the current stream first, the current stream waits for it after, and
    the launch counts are left as they were."""
    start = read_counts(counters)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.device(device), torch.cuda.stream(side):
            yield
    finally:
        torch.cuda.current_stream(device).wait_stream(side)
        add_counts(counters, [e - s for e, s in
                              zip(read_counts(counters), start)], -1)


def capture(body: Callable[[], W], pool, counters: Counters
            ) -> Tuple[torch.cuda.CUDAGraph, W, List[int]]:
    """One graph of ``body`` in ``pool``: the graph, the body's outputs
    (its static buffers) and the launches it counted."""
    before = read_counts(counters)
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        out = body()
    finally:
        graph.capture_end()
    return graph, out, [a - b for a, b in zip(read_counts(counters), before)]


class GraphRegistry:
    """A model's workspaces, one a key, and its counts: ``replays`` (calls
    that replayed a graph), ``eager`` (calls that ran the body) and
    ``captures`` (graphs captured). A copy starts with none."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._workspaces: Dict[tuple, object] = {}
        self.replays = 0
        self.eager = 0
        self.captures = 0

    def __deepcopy__(self, memo) -> "GraphRegistry":
        return type(self)()

    def __getstate__(self) -> dict:
        return {}

    def __setstate__(self, state: dict) -> None:
        self.__init__()

    def checkout(self, key: tuple, make: Callable[[], W]) -> Optional[W]:
        """The workspace of ``key`` (``make()`` where there is none yet),
        its ``lock`` taken; None where another thread holds it or the
        registry. The caller releases the lock."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            ws = self._workspaces.get(key)
            if ws is None:
                ws = self._workspaces[key] = make()
            if not ws.lock.acquire(blocking=False):
                return None
        finally:
            self._lock.release()
        return ws
