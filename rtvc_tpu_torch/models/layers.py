"""Shared layers: the sinusoidal positional encoding and TinyViT's MLP.

Counterpart of ``rtvc_tpu/models/layers.py``. This package only runs
inference, where ``DropPath`` and dropout are the identity, so neither
exists here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import FusedLayerNorm


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Static ``[max_len, d_model]`` table: pe[pos, 2i] = sin,
    pe[pos, 2i+1] = cos (reference model.py:324-333)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Adds ``pe[offset : offset + L]`` to ``x [B, L, D]``. The table is a
    non-persistent buffer: it follows ``.to()`` but is not in the state
    dict."""

    def __init__(self, d_model: int, max_len: int = 500):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(
                max_len, d_model)), persistent=False)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        pos = self.pe[offset:offset + x.shape[1]].to(x.dtype)
        return x + pos[None]


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


class Mlp(nn.Module):
    """LayerNorm → Linear → GELU → Linear on ``[..., dim]`` tokens."""

    def __init__(self, dim: int, hidden: int, gelu_approximate: bool = False):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.norm = FusedLayerNorm(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(self.norm(x)), self.gelu_approximate))
