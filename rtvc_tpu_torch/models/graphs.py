"""The port's CUDA graphs of a model's body, one mechanism for all of them.

Three users keep graphs here: the student's decode, one graph a position
(:mod:`.decode_graph`); the student's encoder, one graph an input shape
(:mod:`.encode_graph`); the vision-language model's decode, two graphs a
layer (:class:`.kimi_lm.LatentWorkspace`, kept by :mod:`.kimi_vl`). Each
keeps its static buffers, its body, its replay and its spans; this module
answers for all of them:

- **May this call replay?** :func:`graphs_apply`, from what the call can
  observe: real CUDA tensors (not an export's or a compiler's stand-ins),
  no compiler tracing or stream capture under way, eval mode, grad off.
  :meth:`GraphRegistry.checkout` asks it; patching it to return False
  forces every user's eager body.
- **How is a graph captured?** :meth:`Workspace.capture_graphs`: on a side
  stream, one eager warm-up, then each body captured in one private memory
  pool with ``capture_error_mode="thread_local"``. The kernel wrappers
  count their launches in Python (:func:`launch_counters`); a user may add
  device tallies (the VLM's routed-token counts). What the warm-up and the
  capture added to them is taken back, each graph's launches are added at
  its replay (a graph adds to a device tally itself), so the counts read as
  the eager path's.
- **Is a captured graph still valid?** A graph reads its weights at the
  addresses they had when it was captured. :class:`Captured` keeps where
  each module under a user's roots holds each submodule, parameter and
  buffer (the parent's dictionary and the name), the object found there
  and each tensor's address, plus any extra tensors, and pins the tensors'
  storage, so that no other tensor can take an address the graph reads.
  The check runs when a caller takes the workspace: the same roots and
  extra tensors, every dictionary still holding the same object, every
  tensor at the same address (no signature is built). On any change
  (``.to()``, a reassigned parameter or buffer, a replaced submodule, a
  new extra tensor) the workspace drops its graphs and its user captures
  them again; other workspaces keep theirs. In-place updates
  (``load_state_dict``, the train step's copy-back, BatchNorm's running
  statistics) keep the storage, so the graphs read the new values. With
  the storage pinned, the same object at the same address has the dtype,
  shape and strides it had at capture, but for one change the check does
  not see: a parameter's ``.data`` set to another view of the same storage
  that starts at the same address, which no code of the port makes. The
  pins hold the captured weights' memory until the workspace is taken
  again.
- **Who may use a workspace?** A :class:`GraphRegistry` keeps a model's
  workspaces, one a key of shapes, and counts ``replays``, ``eager`` and
  ``captures``. :meth:`GraphRegistry.checkout` hands a workspace out with
  its ``lock`` taken, or None where another thread holds it or the
  registry, and that call runs the eager body instead of waiting. A copy
  of the model (``deepcopy``, pickling) starts with no workspace: a graph
  belongs to the tensors it was captured on.
"""

from __future__ import annotations

import operator
import threading
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, TypeVar)

import torch
from torch import nn

Counters = List[Tuple[object, str]]
W = TypeVar("W")


def launch_counters() -> Counters:
    """The launch counts of the kernel wrappers a graph's body may run, K1,
    K2 and K3: (wrapper, attribute)."""
    from ..ops import attention, int8_gemm, layernorm
    return [(attention.window_attention, "launches"),
            (layernorm.layer_norm, "launches"),
            (int8_gemm.w8_matmul, "launches")]


def read_counts(counters: Counters) -> list:
    """Each counter's value: an int, or a copy of a device tally."""
    return [v.clone() if isinstance(v, torch.Tensor) else v
            for v in (getattr(owner, attr) for owner, attr in counters)]


def add_counts(counters: Counters, deltas: list, sign: int = 1) -> None:
    for (owner, attr), d in zip(counters, deltas):
        if isinstance(d, torch.Tensor):
            getattr(owner, attr).add_(d, alpha=sign)
        elif d:
            setattr(owner, attr, getattr(owner, attr) + sign * d)


def graphs_apply(model: nn.Module, x: torch.Tensor) -> bool:
    """Whether a call of ``model`` on ``x`` may replay graphs: real CUDA
    tensors, no compiler or export tracing, no stream capture under way,
    eval mode and grad off."""
    return (type(x) is torch.Tensor and x.is_cuda
            and not model.training and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


class Captured:
    """What a workspace's graphs read: the modules ``roots``, every
    submodule, parameter and buffer under them where its module keeps it
    (``_modules``, ``_parameters``, ``_buffers``, so that a replaced or
    moved one is found where the module looks) and the extra ``tensors``;
    each tensor's address, its storage pinned. With no roots it is what a
    workspace holds before its first capture, current for nothing."""

    def __init__(self, roots: Sequence[nn.Module] = (),
                 tensors: Sequence[torch.Tensor] = ()):
        mods = [m for root in roots for m in root.modules()]
        slots = [(m._modules, name, c) for m in mods
                 for name, c in m._modules.items() if c is not None]
        slots += [(d, name, t) for m in mods
                  for d in (m._parameters, m._buffers)
                  for name, t in d.items() if t is not None]
        self.given = [*roots, *tensors]
        self.dicts = [d for d, _, _ in slots]
        self.names = [name for _, name, _ in slots]
        self.found = [o for _, _, o in slots]
        self.tensors = [o for o in self.found
                        if isinstance(o, torch.Tensor)] + list(tensors)
        self.addresses = [t.data_ptr() for t in self.tensors]
        self.pinned = [t.detach() for t in self.tensors]

    def current(self, roots: Sequence[nn.Module],
                tensors: Sequence[torch.Tensor] = ()) -> bool:
        """Whether ``roots`` and ``tensors`` still hold what was captured:
        the same objects in the same slots, each tensor at the same
        address."""
        given = [*roots, *tensors]
        return (len(given) == len(self.given) > 0
                and all(map(operator.is_, given, self.given))
                and all(map(operator.is_, map(dict.get, self.dicts,
                                              self.names), self.found))
                and list(map(torch.Tensor.data_ptr, self.tensors))
                == self.addresses)


class Workspace:
    """A user's static buffers and graphs for one key of shapes, held by one
    caller at a time (``lock``): ``graphs`` (empty until captured), the
    launches each counted (``deltas``), and what they read (``captured``).
    ``counters`` are :func:`launch_counters` and the user's device
    tallies."""

    def __init__(self, device: torch.device, tallies: Counters = ()):
        self.lock = threading.Lock()
        self.device = device
        self.counters = launch_counters() + list(tallies)
        self.captured = Captured()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.deltas: List[list] = []

    def capture_graphs(self, warm: Callable[[], object],
                       bodies: Iterable[Callable[[], W]]) -> List[W]:
        """Capture ``bodies``, in order, as the workspace's graphs (it has
        none: new, or found stale), after one eager ``warm()``; returns each
        body's outputs (its static buffers). The side stream waits for the current stream first, and
        the current stream for it after."""
        graphs, deltas, outs = [], [], []
        pool = torch.cuda.graph_pool_handle()
        start = read_counts(self.counters)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(side):
                warm()
                for body in bodies:
                    before = [getattr(o, a) for o, a in self.counters]
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        outs.append(body())
                    finally:
                        graph.capture_end()
                    graphs.append(graph)
                    # a graph adds to a device tally itself when replayed
                    d = [0 if isinstance(b, torch.Tensor) else
                         getattr(o, a) - b
                         for (o, a), b in zip(self.counters, before)]
                    deltas.append(d if any(d) else [])
        finally:
            current.wait_stream(side)
            add_counts(self.counters, [e - s for e, s in zip(
                read_counts(self.counters), start)], -1)
        self.graphs, self.deltas = graphs, deltas
        return outs

    def replay_graph(self, index: int) -> None:
        """Replay graph ``index`` and count its launches."""
        self.graphs[index].replay()
        if self.deltas[index]:
            add_counts(self.counters, self.deltas[index])


class GraphRegistry:
    """A model's workspaces, one a key, and its counts: ``replays`` (calls
    that replayed graphs), ``eager`` (calls that ran the body) and
    ``captures`` (graphs captured). A copy starts with none."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._workspaces: Dict[tuple, Workspace] = {}
        self.replays = 0
        self.eager = 0
        self.captures = 0

    def __deepcopy__(self, memo) -> "GraphRegistry":
        return type(self)()

    def __getstate__(self) -> dict:
        return {}

    def __setstate__(self, state: dict) -> None:
        self.__init__()

    def checkout(self, model: nn.Module, x: torch.Tensor, key: tuple,
                 make: Callable[[], W], roots: Sequence[nn.Module],
                 tensors: Sequence[torch.Tensor] = ()) -> Optional[W]:
        """The workspace of ``key`` (``make()`` where there is none yet), its
        ``lock`` taken, its graphs dropped where ``roots`` and ``tensors``
        no longer hold what they were captured on (the caller captures
        where ``graphs`` is empty); None where the graphs do not apply to a
        call of ``model`` on ``x`` or another thread holds the workspace or
        the registry. The caller releases the lock."""
        if not graphs_apply(model, x) or not self._lock.acquire(
                blocking=False):
            return None
        try:
            ws = self._workspaces.get(key)
            if ws is None:
                ws = self._workspaces[key] = make()
            if not ws.lock.acquire(blocking=False):
                return None
        finally:
            self._lock.release()
        try:
            if not ws.captured.current(roots, tensors):
                ws.graphs, ws.deltas = [], []
                ws.captured = Captured(roots, tensors)
        except BaseException:
            ws.lock.release()
            raise
        return ws
