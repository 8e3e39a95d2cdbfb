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

The choice to replay, the capture, the check of what the graph reads and
the lock are :mod:`.graphs`'s, asked about the encoder. Where the graphs
do not apply or another thread holds the workspace, the eager body runs,
as it does for the CPU, training, ``remat_encoder`` and a second thread.
The graph reads the modules under the encoder (:func:`reads`), checked on
every call: one pass over ~500 slots.

The static buffers are made, and the graph warmed up, captured and
replayed, under ``torch.inference_mode()``; the clones are made in the
caller's mode, so a call under ``no_grad`` after one under
``inference_mode`` at the same shape gets ordinary tensors from the same
workspace.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .graphs import GraphRegistry, Workspace

Encoded = Tuple[List[torch.Tensor], torch.Tensor]


def reads(model: nn.Module) -> Tuple[List[nn.Module], List[torch.Tensor]]:
    """The modules the encoder body reads besides its input
    (:class:`.graphs.Captured`)."""
    return [model.image_encoder["model"]], []


class EncodeWorkspace(Workspace):
    """The static input, outputs and graph of one (device, dtype, input
    shape and strides) of one model."""

    def __init__(self, x: torch.Tensor):
        super().__init__(x.device)
        with torch.inference_mode():
            self.x = torch.empty_like(x)
        self.out: Optional[Encoded] = None

    def capture(self, model: nn.Module) -> int:
        """Capture the encoder body after one eager warm-up. Returns the
        graphs captured."""
        # the class's body, not an instance attribute: whatever wraps
        # ``forward_image_enc`` on the instance sees the caller's call only
        body = functools.partial(type(model).encode_body, model, self.x)
        with torch.inference_mode():
            (self.out,) = self.capture_graphs(body, [body])
        return len(self.graphs)

    def replay(self, x: torch.Tensor) -> Encoded:
        """The encoder's outputs for ``x`` from the graph, cloned."""
        with span("rtvc.encode.graph"):
            with torch.inference_mode():
                self.x.copy_(x)
            self.replay_graph(0)
        fmaps, memory = self.out
        return [m.clone() for m in fmaps], memory.clone()


class EncodeGraphs(GraphRegistry):
    """A model's encode workspaces and counts (:class:`.graphs.
    GraphRegistry`): ``replays`` and ``eager`` count encoder calls."""

    def run(self, model: nn.Module, x: torch.Tensor) -> Optional[Encoded]:
        """The encoder's outputs for frames ``x [B, F, H, W, 3]`` from the
        workspace of its shape, captured for the model's present weights,
        or None where the graphs do not apply or another thread holds the
        workspace."""
        ws = self.checkout(
            model.image_encoder["model"], x,
            (x.device, x.dtype, tuple(x.shape), x.stride()),
            lambda: EncodeWorkspace(x), *reads(model))
        if ws is None:
            return None
        try:
            if not ws.graphs:
                self.captures += ws.capture(model)
            out = ws.replay(x)
        finally:
            ws.lock.release()
        self.replays += 1
        return out
