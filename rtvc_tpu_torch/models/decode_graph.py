"""One CUDA graph per decode position for the student's greedy token.

A greedy token of the student issues about 85 launches from Python in
:meth:`StudentCandidateV1.decode_step`'s body (embedding, positional
encoding, two post-norm decoder layers with K2, the vocab projection or
K3), and about a dozen more around it (the key mask, the argmax, the stop
test, the token write). On the card each costs more host time than device
time, so a caption waits on the host. A :class:`DecodeWorkspace` holds
static buffers (each layer's ``k``/``v``/``mem_k``/``mem_v`` cache, the
caller's step with its own buffers, a pinned host flag a position) and one
``torch.cuda.CUDAGraph`` for each position ``0 … slots - 2`` (the
positions ``decode.student_greedy`` decodes at), all in one private memory
pool.

The caller hands the step in: ``decode_caches(..., step=make)`` gives the
workspace ``make(batch, slots, device)`` (once), a callable ``step(body, index)
-> (logits, flag)`` that reads and writes its own buffers
(``decode.GreedyStep``: the key mask, the argmax, the token write, the
stop). Position ``i``'s graph is ``step(body, i)`` over the class's decode
body on the workspace's caches, then a copy of the flag into slot ``i`` of
the pinned host array. For the block the workspace is ``armed``: each
``decode_step`` on its caches replays its position's graph, in turn, and
returns a clone of the logits, which the caller owns: a later step never
overwrites them. The graph reads the step's buffers, which the caller
passes as the token and the mask; a call out of turn raises.
:meth:`DecodeWorkspace.flag` waits for a position's flag (an event
recorded on the workspace's card after the replay) and reads it. A block
opened without a step holds the caches alone, and ``decode_step`` on them
runs the eager body.

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
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .graphs import GraphRegistry, Workspace

Cache = Dict[str, torch.Tensor]
# ``step(body, index) -> (logits, flag)``, ``body(token, index, mask)``
Step = Callable[[Callable[..., torch.Tensor], int],
                Tuple[torch.Tensor, torch.Tensor]]


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
        self.step: Optional[Step] = None  # its buffers outlive a block
        self.armed = False  # the block's decode_step calls replay the step
        self.issued = 0     # positions replayed in the block
        # slot i: position i's flag, copied by its graph
        self.flags = torch.zeros((slots,), dtype=torch.bool,
                                 pin_memory=memory.is_cuda)
        self.landed: List[torch.cuda.Event] = []  # one a replay, after it
        self.logits: List[torch.Tensor] = []

    def positions(self, model: nn.Module) -> List[Callable[[], torch.Tensor]]:
        """Each position's work, as its graph holds it: the step over the
        class's body on the workspace's caches (not ``model.decode_step``:
        whatever wraps that on the instance sees the per-token calls only),
        then the flag's copy to the host."""
        def body(token, index, mask):
            return type(model).decode_body(model, token, index, self.caches,
                                           mask, self.vocab_w8)

        def position(index):
            logits, flag = self.step(body, index)
            self.flags[index].copy_(flag, non_blocking=True)
            return logits

        return [functools.partial(position, i)
                for i in range(len(self.flags) - 1)]

    def capture(self, model: nn.Module) -> int:
        """Capture every position's graph after one eager warm-up. Returns
        the graphs captured."""
        positions = self.positions(model)
        self.logits = self.capture_graphs(positions[0], positions)
        self.landed = [torch.cuda.Event() for _ in self.graphs]
        return len(self.graphs)

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

    def replay(self, index: int) -> torch.Tensor:
        """Position ``index``'s graph, the block's next: a clone of its
        logits. The event after it is recorded on the workspace's card,
        whichever card is current."""
        if index != self.issued or index >= len(self.graphs):
            raise RuntimeError(
                f"decode position {index} out of turn: the workspace "
                f"replays positions 0 … {len(self.graphs) - 1} in order, "
                f"and is at {self.issued}")
        with span("rtvc.decode.graph"):
            self.replay_graph(index)
        self.landed[index].record(torch.cuda.current_stream(self.device))
        self.issued += 1
        return self.logits[index].clone()

    def flag(self, index: int) -> bool:
        """Position ``index``'s flag, once it has reached the host."""
        self.landed[index].synchronize()
        return bool(self.flags[index])


class DecodeGraphs(GraphRegistry):
    """A model's decode workspaces and counts (:class:`.graphs.
    GraphRegistry`): ``replays`` and ``eager`` count decode steps,
    ``past_stop`` the positions greedy captions decoded past their stop
    (at most one a caption)."""

    def __init__(self) -> None:
        super().__init__()
        self.past_stop = 0

    @contextlib.contextmanager
    def caches(self, model: nn.Module, batch: int, slots: int,
               memory: torch.Tensor,
               vocab_w8: Optional[Dict[str, torch.Tensor]] = None,
               step: Optional[Callable[..., Step]] = None
               ) -> Iterator[List[Cache]]:
        """Caches for one caption of ``batch`` rows and ``slots`` cache
        slots: a workspace's, held until the block ends, where the graphs
        apply and it is free, else ``model.init_cache``'s. Given ``step``,
        the workspace is armed with ``step(batch, slots, device)``, made at
        its first such block, its graphs captured for the model's present
        weights."""
        key = (memory.device, memory.dtype, batch, slots, memory.shape[1],
               vocab_w8 is not None)
        ws = self.checkout(model, memory, key, lambda: DecodeWorkspace(
            model, batch, slots, memory), *reads(model, vocab_w8))
        if ws is None:
            yield model.init_cache(batch, slots, memory)
            return
        try:
            ws.vocab_w8 = vocab_w8
            if step is not None:
                if ws.step is None:
                    ws.step = step(batch, slots, memory.device)
                if not ws.graphs:
                    self.captures += ws.capture(model)
                ws.armed, ws.issued = True, 0
            yield ws.load(model, memory)
        finally:
            ws.armed = False
            ws.lock.release()
