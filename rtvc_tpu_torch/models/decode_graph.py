"""One CUDA graph per decode position for the student's one-token decode.

A greedy token of the student issues about 85 launches from Python in
:meth:`StudentCandidateV1.decode_step`'s body (embedding, positional
encoding, two post-norm decoder layers with K2, the vocab projection or
K3). On the card each costs more host time than device time, so a caption
waits on the host. A :class:`DecodeWorkspace` holds static buffers (each
layer's ``k``/``v``/``mem_k``/``mem_v`` cache, the token ``[B]``, the key
mask ``[B, slots]``) and one ``torch.cuda.CUDAGraph`` of that body for
each position ``0 … slots - 2`` (the positions ``decode.student_greedy``
decodes at), all in one private memory pool. ``decode_step`` on the
workspace's caches copies the token and the mask in, replays the
position's graph (the span ``rtvc.decode.graph``) and returns a clone of
its logits, which the caller owns: a later step never overwrites them.

The graphs hold the eager body itself: the same kernels, K2 and K3
included, on the same shapes in the same order, so replayed logits equal
eager ones bit for bit. A graph per position keeps the position a Python
int, as in the eager body (the cache write's slot, the positional
encoding's row).

The choice is made from what a call can observe (:func:`graphs_apply`):
CUDA tensors that are real (not an export's or a compiler's stand-ins),
no compiler or stream capture under way, the model in eval mode with
grad off, and the workspace free. Otherwise the caller gets caches from
``init_cache`` and the eager body runs, as it does for the CPU,
``student_beam`` (fresh gathered caches each step) and a second thread
while one holds the workspace.

A graph reads its weights at the addresses they had when it was
captured. :class:`DecodeGraphs` keeps each read tensor's address, dtype,
shape and strides, checks them once per caption and captures again on
any change (``.to()``, a reassigned parameter, a new ``vocab_w8`` pack).
In-place updates (``load_state_dict``, the train step's copy-back) keep
the storage, so the graphs read the new values.

The kernel wrappers count their launches in Python (``layer_norm.
launches`` and the like). Warm-up and capture take back what they added,
and each replay adds what its graph launches, so the counts read as the
eager path's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..utils.profiling import span
from .graphs import GraphRegistry, add_counts, capture, capturing, graphs_apply

Cache = Dict[str, torch.Tensor]


def _launch_counters() -> List[Tuple[object, str]]:
    """The launch counts of the kernels the decode body runs, K2 and K3:
    (wrapper, attribute)."""
    from ..ops import int8_gemm, layernorm
    return [(layernorm.layer_norm, "launches"),
            (int8_gemm.w8_matmul, "launches")]


def _signature(model: torch.nn.Module,
               vocab_w8: Optional[Dict[str, torch.Tensor]]) -> tuple:
    """Address, dtype, shape and strides of every tensor the decode body
    reads besides its caches, token and mask."""
    tensors = [*model.embed.parameters(), *model.pos_enc.buffers(),
               *model.decoder.parameters(), *model.linear.parameters()]
    if vocab_w8 is not None:
        tensors += [vocab_w8[k] for k in sorted(vocab_w8)
                    if isinstance(vocab_w8[k], torch.Tensor)]
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
                 for t in tensors)


class WorkspaceCaches(list):
    """A workspace's per-layer caches: the list ``init_cache`` returns,
    marked with the workspace whose static buffers they are."""

    def __init__(self, caches: List[Cache], workspace: "DecodeWorkspace"):
        super().__init__(caches)
        self.workspace = workspace


class DecodeWorkspace:
    """Static buffers and per-position graphs for one (device, dtype,
    batch, cache slots, memory length, vocab head) of one model. Held by
    one caption at a time (``lock``)."""

    def __init__(self, model: torch.nn.Module, batch: int, slots: int,
                 memory: torch.Tensor,
                 vocab_w8: Optional[Dict[str, torch.Tensor]]):
        self.lock = threading.Lock()
        self.vocab_w8 = vocab_w8
        self.signature: Optional[tuple] = None
        self.caches = WorkspaceCaches(
            model.init_cache(batch, slots, memory), self)
        self.token = torch.zeros((batch,), dtype=torch.int32,
                                 device=memory.device)
        self.mask = torch.ones((batch, slots), dtype=torch.bool,
                               device=memory.device)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.logits: List[torch.Tensor] = []
        self.deltas: List[List[int]] = []
        self.counters = _launch_counters()

    def capture(self, model: torch.nn.Module) -> int:
        """(Re)capture a graph of the decode body for every position but
        the last, after one eager warm-up (:func:`.graphs.capturing`).
        Returns the graphs captured."""
        for g in self.graphs:
            g.reset()
        self.graphs, self.logits, self.deltas = [], [], []
        pool = torch.cuda.graph_pool_handle()
        with capturing(self.token.device, self.counters):
            self._body(model, 0)
            for i in range(self.mask.shape[1] - 1):
                graph, logits, deltas = capture(
                    lambda: self._body(model, i), pool, self.counters)
                self.graphs.append(graph)
                self.logits.append(logits)
                self.deltas.append(deltas)
        return len(self.graphs)

    def _body(self, model: torch.nn.Module, index: int) -> torch.Tensor:
        # the class's body, not ``model.decode_step``: whatever wraps that
        # on the instance sees the per-token calls only
        return type(model).decode_body(model, self.token, index, self.caches,
                                       self.mask, self.vocab_w8)

    def load(self, model: torch.nn.Module,
             memory: torch.Tensor) -> WorkspaceCaches:
        """``init_cache`` into the static caches: self-attention keys and
        values zeroed, the memory's keys and values projected in."""
        for layer, cache in zip(model.decoder["layers"], self.caches):
            cache["k"].zero_()
            cache["v"].zero_()
            mem_k, mem_v = layer.multihead_attn.project_kv(memory)
            cache["mem_k"].copy_(mem_k)
            cache["mem_v"].copy_(mem_v)
        return self.caches

    def replay(self, token: torch.Tensor, index: int,
               kv_mask: Optional[torch.Tensor],
               vocab_w8: Optional[Dict[str, torch.Tensor]]
               ) -> Optional[torch.Tensor]:
        """The logits of position ``index`` from its graph, or None where
        the call is not the one captured (no mask, another head, another
        shape, a position without a graph)."""
        if (vocab_w8 is not self.vocab_w8 or kv_mask is None
                or not 0 <= index < len(self.graphs)
                or token.shape != self.token.shape
                or kv_mask.shape != self.mask.shape):
            return None
        self.token.copy_(token)
        self.mask.copy_(kv_mask)
        with span("rtvc.decode.graph"):
            self.graphs[index].replay()
        add_counts(self.counters, self.deltas[index])
        return self.logits[index].clone()


class DecodeGraphs(GraphRegistry):
    """A model's decode workspaces and counts (:class:`.graphs.
    GraphRegistry`): ``replays`` and ``eager`` count decode steps."""

    def _take(self, model: torch.nn.Module, batch: int, slots: int,
              memory: torch.Tensor,
              vocab_w8: Optional[Dict[str, torch.Tensor]]
              ) -> Optional[DecodeWorkspace]:
        """The workspace of this call's shapes, locked and captured for the
        model's present weights, or None where the graphs do not apply or
        another thread holds it."""
        if not graphs_apply(model, memory):
            return None
        key = (memory.device, memory.dtype, batch, slots, memory.shape[1],
               vocab_w8 is not None)
        ws = self.checkout(key, lambda: DecodeWorkspace(
            model, batch, slots, memory, vocab_w8))
        if ws is None:
            return None
        try:
            ws.vocab_w8 = vocab_w8
            signature = _signature(model, vocab_w8)
            if ws.signature != signature:
                ws.signature = None
                self.captures += ws.capture(model)
                ws.signature = signature
        except BaseException:
            ws.lock.release()
            raise
        return ws

    @contextlib.contextmanager
    def caches(self, model: torch.nn.Module, batch: int, slots: int,
               memory: torch.Tensor,
               vocab_w8: Optional[Dict[str, torch.Tensor]] = None
               ) -> Iterator[List[Cache]]:
        """Caches for one caption of ``batch`` rows and ``slots`` cache
        slots: a workspace's, held until the block ends, where the graphs
        apply and it is free, else ``model.init_cache``'s."""
        ws = self._take(model, batch, slots, memory, vocab_w8)
        if ws is None:
            yield model.init_cache(batch, slots, memory)
            return
        try:
            yield ws.load(model, memory)
        finally:
            ws.lock.release()
