"""Shared layers: the sinusoidal positional encoding, TinyViT's MLP,
DropPath, and the key mapping of packed Linears.

Counterpart of ``rtvc_tpu/models/layers.py``. ``DropPath`` and the MLP's
dropout act in train mode only, drawing from the explicit CPU
``torch.Generator`` passed to ``forward`` (:mod:`..ops.dropout`); in eval
mode they are the identity, as JAX's ``deterministic=True``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import drop_path, dropout
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


class DropPath(nn.Module):
    """Stochastic depth: in train mode the whole residual branch of a
    sample is dropped with probability ``rate``, kept ones scaled by
    ``1 / (1 - rate)``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_path(x, self.rate if self.training else 0.0, generator)


class Mlp(nn.Module):
    """LayerNorm → Linear → GELU → dropout → Linear → dropout on
    ``[..., dim]`` tokens (dropout in train mode only)."""

    def __init__(self, dim: int, hidden: int, gelu_approximate: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.dropout = dropout
        self.norm = FusedLayerNorm(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        x = gelu(self.fc1(self.norm(x)), self.gelu_approximate)
        x = dropout(x, rate, generator)
        return dropout(self.fc2(x), rate, generator)


def save_under_reference_keys(module: nn.Module, attr: str,
                              keys: Dict[str, Sequence[str]]) -> None:
    """Save and load the Linear ``module.<attr>`` under the reference
    checkpoint's names. ``keys`` maps ``"weight"`` and ``"bias"`` to their
    key names relative to ``module``; with three names the tensor is the
    q|k|v packing of three Linears, split along dim 0 on save and
    concatenated on load. A quantized ``attr`` keeps its ``weight_q`` and
    ``weight_scale`` keys (only its bias is split)."""
    def save(mod, state, prefix, local_metadata):
        for leaf, names in keys.items():
            packed = state.pop(f"{prefix}{attr}.{leaf}", None)
            if packed is not None:
                for name, part in zip(names, packed.chunk(len(names))):
                    state[prefix + name] = part

    def load(mod, state, prefix, *args):
        for leaf, names in keys.items():
            if all(prefix + name in state for name in names):
                state[f"{prefix}{attr}.{leaf}"] = torch.cat(
                    [state.pop(prefix + name) for name in names])

    module.register_state_dict_post_hook(save)
    module.register_load_state_dict_pre_hook(load)
