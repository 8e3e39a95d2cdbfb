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

The choice to replay, the capture, the check of what the graphs read and
the lock are :mod:`.graphs`'s. Where the graphs do not apply or another
thread holds the workspace, the caller gets caches from ``init_cache``
and the eager body runs, as it does for the CPU, ``student_beam`` (fresh
gathered caches each step) and a second thread. The graphs read the
modules under ``embed``, ``pos_enc``, ``decoder`` and ``linear`` and the
``vocab_w8`` pack's tensors (:func:`reads`), checked once a caption.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .graphs import GraphRegistry, Workspace

Cache = Dict[str, torch.Tensor]


def reads(model: nn.Module, vocab_w8: Optional[Dict[str, torch.Tensor]]
          ) -> Tuple[List[nn.Module], List[torch.Tensor]]:
    """The modules and extra tensors the decode body reads besides its
    caches, token and mask (:class:`.graphs.Captured`)."""
    pack = [] if vocab_w8 is None else [
        vocab_w8[k] for k in sorted(vocab_w8)
        if isinstance(vocab_w8[k], torch.Tensor)]
    return [model.embed, model.pos_enc, model.decoder, model.linear], pack


class WorkspaceCaches(list):
    """A workspace's per-layer caches: the list ``init_cache`` returns,
    marked with the workspace whose static buffers they are."""

    def __init__(self, caches: List[Cache], workspace: "DecodeWorkspace"):
        super().__init__(caches)
        self.workspace = workspace


class DecodeWorkspace(Workspace):
    """Static buffers and per-position graphs for one (device, dtype,
    batch, cache slots, memory length, vocab head) of one model."""

    def __init__(self, model: nn.Module, batch: int, slots: int,
                 memory: torch.Tensor):
        super().__init__(memory.device)
        self.vocab_w8: Optional[Dict[str, torch.Tensor]] = None
        self.caches = WorkspaceCaches(
            model.init_cache(batch, slots, memory), self)
        self.token = torch.zeros((batch,), dtype=torch.int32,
                                 device=memory.device)
        self.mask = torch.ones((batch, slots), dtype=torch.bool,
                               device=memory.device)
        self.logits: List[torch.Tensor] = []

    def capture(self, model: nn.Module) -> int:
        """Capture a graph of the decode body for every position but the
        last, after one eager warm-up. Returns the graphs captured."""
        bodies = [functools.partial(self._body, model, i)
                  for i in range(self.mask.shape[1] - 1)]
        self.logits = self.capture_graphs(bodies[0], bodies)
        return len(self.graphs)

    def _body(self, model: nn.Module, index: int) -> torch.Tensor:
        # the class's body, not ``model.decode_step``: whatever wraps that
        # on the instance sees the per-token calls only
        return type(model).decode_body(model, self.token, index, self.caches,
                                       self.mask, self.vocab_w8)

    def load(self, model: nn.Module, memory: torch.Tensor) -> WorkspaceCaches:
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
            self.replay_graph(index)
        return self.logits[index].clone()


class DecodeGraphs(GraphRegistry):
    """A model's decode workspaces and counts (:class:`.graphs.
    GraphRegistry`): ``replays`` and ``eager`` count decode steps."""

    @contextlib.contextmanager
    def caches(self, model: nn.Module, batch: int, slots: int,
               memory: torch.Tensor,
               vocab_w8: Optional[Dict[str, torch.Tensor]] = None
               ) -> Iterator[List[Cache]]:
        """Caches for one caption of ``batch`` rows and ``slots`` cache
        slots: a workspace's, captured for the model's present weights and
        held until the block ends, where the graphs apply and it is free,
        else ``model.init_cache``'s."""
        key = (memory.device, memory.dtype, batch, slots, memory.shape[1],
               vocab_w8 is not None)
        ws = self.checkout(model, memory, key, lambda: DecodeWorkspace(
            model, batch, slots, memory), *reads(model, vocab_w8))
        if ws is None:
            yield model.init_cache(batch, slots, memory)
            return
        try:
            ws.vocab_w8 = vocab_w8
            if not ws.graphs:
                self.captures += ws.capture(model)
            yield ws.load(model, memory)
        finally:
            ws.lock.release()
