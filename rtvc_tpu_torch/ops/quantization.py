"""Weight-only int8 packing of the student's vocab projection.

Counterpart of ``quantize_weight`` and ``quantize_vocab_head`` in
``rtvc_tpu/ops/quantization.py``: symmetric per-output-channel int8, and
the vocab pack pre-padded to a multiple of 1024 columns with a -1e9 bias on
the pad, so a pad column never wins the argmax and nothing is padded per
token. The teacher's W8A8 surface is not on the caption step and is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
    step. Compute it once per weight set."""
    wq, sw = quantize_weight(linear.weight.t())
    bias = linear.bias.float()
    pad = (-wq.shape[1]) % PAD_MULTIPLE
    if pad:
        wq = F.pad(wq, (0, pad))
        sw = F.pad(sw, (0, pad))
        bias = F.pad(bias, (0, pad), value=PAD_BIAS)
    return {"wq": wq.contiguous(), "sw": sw.reshape(1, -1),
            "bias": bias.reshape(1, -1)}
