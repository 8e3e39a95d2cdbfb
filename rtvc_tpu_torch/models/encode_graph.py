"""One CUDA graph per input shape for the student's frame encoder.

In eval mode TinyViT-21M issues about 330 launches from Python for one
:meth:`StudentCandidateV1.forward_image_enc` (the patch embed, the MBConv
blocks, three patch mergings, ten attention blocks with their window
copies, K2, the qkv GEMM, the bias gather, K1, the proj GEMM, the local
conv and its BatchNorm, the MLP). On the card each costs more host time
than device time, so the encoder waits on the host at batch 1 and 8
alike. An :class:`EncodeWorkspace` holds a static input of one (device,
dtype, shape, strides), the body's outputs (the four NHWC stage maps and
``memory [B, F, C]``) and one ``torch.cuda.CUDAGraph`` of
:meth:`~StudentCandidateV1.encode_body`, in a private memory pool. A call
copies its frames in and replays the graph (both inside the span
``rtvc.encode.graph``) and returns clones of the outputs, which the caller
owns.

The graph holds the eager body itself: the same kernels, K1 and K2
included, on the same shapes in the same order, so the replayed maps and
memory equal eager ones bit for bit.

The choice is made from what a call can observe
(:func:`.graphs.graphs_apply`, on the encoder): CUDA tensors that
are real (not an export's or a compiler's stand-ins), no compiler or
stream capture under way, the encoder in eval mode with grad off, and
the workspace free. Otherwise the eager body runs, as it does for the
CPU, training, ``remat_encoder`` and a second thread while one holds the
workspace.

The static buffers are made, and the graph warmed up, captured and
replayed, under ``torch.inference_mode()``; the clones are made in the
caller's mode, so a call under ``no_grad`` after one under
``inference_mode`` at the same shape gets ordinary tensors from the same
workspace.

A graph reads its weights at the addresses they had when it was
captured. A workspace keeps where the encoder holds each submodule,
parameter and buffer (the parent's dictionary and the name), the object
found there and each tensor's address, and pins the captured tensors'
storage, so that no other tensor can take an address the graph reads.
Each call checks that every dictionary still holds the same object and
every tensor the same address (one pass over ~500 slots; no signature is
built), and captures again on any change: ``.to()``, a reassigned
parameter or buffer, a replaced submodule. In-place updates
(``load_state_dict``, the train step's copy-back, BatchNorm's running
statistics) keep the storage, so the graph reads the new values. With the
storage pinned, the same object at the same address has the dtype, shape
and strides it had at capture, but for one change the check does not see:
a parameter's ``.data`` set to another view of the same storage that
starts at the same address, which no code of the port makes. The pins
hold the captured weights' memory until the workspace's next call
captures again.

The kernel wrappers count their launches in Python (``window_attention.
launches``, ``layer_norm.launches``); they read as the eager path's
(:mod:`.graphs`).
"""

from __future__ import annotations

import operator
import threading
from typing import List, Optional, Tuple

import torch

from ..utils.profiling import span
from .graphs import GraphRegistry, add_counts, capture, capturing, graphs_apply

Encoded = Tuple[List[torch.Tensor], torch.Tensor]


def _launch_counters() -> List[Tuple[object, str]]:
    """The launch counts of the kernels the encoder runs, K1 and K2:
    (wrapper, attribute)."""
    from ..ops import attention, layernorm
    return [(attention.window_attention, "launches"),
            (layernorm.layer_norm, "launches")]


def _slots(encoder: torch.nn.Module) -> List[Tuple[dict, str, object]]:
    """(dictionary, name, object) of every submodule, parameter and buffer
    of ``encoder``, tensors last: the dictionaries its modules keep them
    in (``_modules``, ``_parameters``, ``_buffers``), so that a replaced
    or moved one is found where the module looks."""
    mods = list(encoder.modules())
    tree = [(m._modules, name, c) for m in mods
            for name, c in m._modules.items() if c is not None]
    tensors = [(d, name, t) for m in mods
               for d in (m._parameters, m._buffers)
               for name, t in d.items() if t is not None]
    return tree + tensors


class EncodeWorkspace:
    """The static input, outputs and graph of one (device, dtype, input
    shape and strides) of one model. Held by one call at a time
    (``lock``)."""

    def __init__(self, x: torch.Tensor):
        self.lock = threading.Lock()
        with torch.inference_mode():
            self.x = torch.empty_like(x)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[Encoded] = None
        self.dicts: List[dict] = []
        self.names: List[str] = []
        self.found: List[object] = []
        self.tensors: List[torch.Tensor] = []
        self.addresses: List[int] = []
        self.pinned: List[torch.Tensor] = []
        self.deltas: List[int] = []
        self.counters = _launch_counters()

    def current(self) -> bool:
        """Whether the encoder still holds what the graph was captured on:
        the same objects in the same slots, each tensor at the same
        address."""
        return (self.graph is not None
                and all(map(operator.is_, map(dict.get, self.dicts,
                                              self.names), self.found))
                and list(map(torch.Tensor.data_ptr, self.tensors))
                == self.addresses)

    def capture(self, model: torch.nn.Module) -> None:
        """(Re)capture the encoder body after one eager warm-up
        (:func:`.graphs.capturing`)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self.out = None, None
        with torch.inference_mode(), capturing(self.x.device, self.counters):
            self._body(model)
            graph, out, deltas = capture(
                lambda: self._body(model), torch.cuda.graph_pool_handle(),
                self.counters)
        self.graph, self.out, self.deltas = graph, out, deltas
        self.remember(model.image_encoder["model"])

    def remember(self, encoder: torch.nn.Module) -> None:
        """Keep what the encoder holds now, and pin its tensors' storage."""
        slots = _slots(encoder)
        self.dicts = [d for d, _, _ in slots]
        self.names = [name for _, name, _ in slots]
        self.found = [o for _, _, o in slots]
        self.tensors = [o for o in self.found if isinstance(o, torch.Tensor)]
        self.addresses = [t.data_ptr() for t in self.tensors]
        self.pinned = [t.detach() for t in self.tensors]

    def _body(self, model: torch.nn.Module) -> Encoded:
        # the class's body, not an instance attribute: whatever wraps
        # ``forward_image_enc`` on the instance sees the caller's call only
        return type(model).encode_body(model, self.x)

    def replay(self, x: torch.Tensor) -> Encoded:
        """The encoder's outputs for ``x`` from the graph, cloned."""
        with span("rtvc.encode.graph"):
            with torch.inference_mode():
                self.x.copy_(x)
            self.graph.replay()
        add_counts(self.counters, self.deltas)
        fmaps, memory = self.out
        return [m.clone() for m in fmaps], memory.clone()


class EncodeGraphs(GraphRegistry):
    """A model's encode workspaces and counts (:class:`.graphs.
    GraphRegistry`): ``replays`` and ``eager`` count encoder calls."""

    def run(self, model: torch.nn.Module, x: torch.Tensor
            ) -> Optional[Encoded]:
        """The encoder's outputs for frames ``x [B, F, H, W, 3]`` from the
        workspace of its shape, captured for the model's present weights,
        or None where the graphs do not apply or another thread holds the
        workspace."""
        if not graphs_apply(model.image_encoder["model"], x):
            return None
        ws = self.checkout((x.device, x.dtype, tuple(x.shape), x.stride()),
                           lambda: EncodeWorkspace(x))
        if ws is None:
            return None
        try:
            if not ws.current():
                ws.capture(model)
                self.captures += 1
            out = ws.replay(x)
        finally:
            ws.lock.release()
        self.replays += 1
        return out
