"""Int8 quantization: the student's vocab pack and the W8A8 teacher.

Counterpart of ``rtvc_tpu/ops/quantization.py``:

- :func:`quantize_weight`: symmetric per-output-channel int8;
- :func:`quantize_vocab_head`: the student's weight-only vocab pack,
  pre-padded to a multiple of 1024 columns with a -1e9 bias on the pad, so
  a pad column never wins the argmax and nothing is padded per token;
- :func:`quantize_activations`, :func:`int8_matmul`, :class:`QuantLinear`
  (JAX's ``QuantDense``) and :func:`quantize_teacher_` (JAX's
  ``quantize_teacher_params``): W8A8 dynamic inference of the frozen
  teacher, weights per output channel once at load, activations per token
  at run time, the GEMM on kernel K7. Inference only: on a card, K7 raises
  where the activations require grad.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .int8_gemm import w8a8_dense

PAD_MULTIPLE = 1024
PAD_BIAS = -1e9


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` float kernel → (int8 kernel, float32 scale ``[out]``)."""
    w32 = w.float()
    scale = w32.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return q.to(torch.int8), scale


@torch.no_grad()
def quantize_vocab_head(linear: nn.Linear) -> Dict[str, torch.Tensor]:
    """The vocab projection ``linear`` (torch layout ``[V, D]``) →
    ``{"wq" [D, Vp] int8, "sw" [1, Vp] f32, "bias" [1, Vp] f32}``, Vp the
    vocab rounded up to 1024, for the ``vocab_w8`` route of the decode
    step. ``wq`` holds JAX's values in JAX's shape, as the transposed view
    of a contiguous ``[Vp, D]`` pack: kernel K3 reads each output column's
    D weights as one contiguous run. Compute it once per weight set."""
    wq, sw = quantize_weight(linear.weight.t())
    pack = wq.t().contiguous()
    bias = linear.bias.float()
    pad = (-pack.shape[0]) % PAD_MULTIPLE
    if pad:
        pack = F.pad(pack, (0, 0, 0, pad))
        sw = F.pad(sw, (0, pad))
        bias = F.pad(bias, (0, pad), value=PAD_BIAS)
    return {"wq": pack.t(), "sw": sw.reshape(1, -1),
            "bias": bias.reshape(1, -1)}


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., in]`` float → (int8, float32 per-row scale ``[..., 1]``)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W8A8 dynamic matmul of ``x [..., K]`` with ``w_q [K, N]``: per-token
    quantization, then the int8 GEMM with its rescale and bias. JAX has two
    routes here (its XLA int8 dot, or the Pallas kernel under
    ``USE_PALLAS_INT8``) with the same result; the port has one,
    :func:`~.int8_gemm.w8a8_dense` (K7 on a card)."""
    return w8a8_dense(x, w_q, w_scale, bias, out_dtype)


class QuantLinear(nn.Module):
    """A frozen ``nn.Linear`` in W8A8: ``weight_q [out, in]`` int8 (the
    Linear's own layout, so K7 reads it K-contiguous), ``weight_scale
    [out]`` and ``bias [out]`` float32, output in the input's dtype. Built
    by :meth:`from_linear`. The scales and bias are float buffers, so a
    later ``.to(dtype)`` casts them too: quantize a model after casting it
    to its compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias",
                             torch.zeros(out_features) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        q = cls(linear.in_features, linear.out_features,
                linear.bias is not None).to(linear.weight.device)
        wq, scale = quantize_weight(linear.weight.t())
        q.weight_q.copy_(wq.t())
        q.weight_scale.copy_(scale)
        if linear.bias is not None:
            q.bias.copy_(linear.bias.float())
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.weight_q.t(), self.weight_scale,
                           self.bias, out_dtype=x.dtype)


@torch.no_grad()
def quantize_teacher_(model: nn.Module) -> nn.Module:
    """Replace every ``nn.Linear`` of ``model`` with its
    :class:`QuantLinear`, in place, as ``quantize_teacher_params`` turns
    every 2-D kernel into ``kernel_q`` + ``kernel_scale``. The patch conv,
    the embeddings, the norms and the biases stay float."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear):
                setattr(parent, name, QuantLinear.from_linear(child))
    return model
