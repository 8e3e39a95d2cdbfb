"""MoonViT, Kimi-VL's image tower, with its 2×2 patch merge and the MLP
projector into the language model's width.

A frame ``[H, W, 3]`` (normalised, at ``image_size``) → a 14×14 stride-14
patch convolution with bias → plus the learned ``pos_grid``² position
table, resized bicubically to the patch grid → ``layers`` pre-LayerNorm
blocks (qkv and output biases, 2D RoPE on q and k, a tanh-GELU MLP) → a
final LayerNorm → each 2×2 neighbourhood of patches merged into one token
of ``4 · width`` (row-major inside the neighbourhood) → the projector:
LayerNorm(width) on each patch, Linear(4w → 4w), the erf GELU,
Linear(4w → hidden).

2D RoPE (MoonViT's ``Rope2DPosEmb``): head dimension ``d`` holds ``d/2``
adjacent rotary pairs; pair ``2i`` turns by ``col · f_i`` and pair
``2i + 1`` by ``row · f_i``, ``f_i = θ^(-4i/d)`` for i < d/4, θ = 10000.

Every frame is encoded alone (attention within a frame, as MoonViT's
packed sequences do). Kernels on a card: K2 for every LayerNorm (any
width); attention through ``F.scaled_dot_product_attention`` (head
dimension 72); cuBLAS for the rest.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MoonViTConfig
from ..ops.layernorm import FusedLayerNorm
from .layers import rotate_pairs


def rope_2d_angles(rows: int, cols: int, head_dim: int, theta: float,
                   device=None) -> torch.Tensor:
    """Float32 ``[rows · cols, head_dim / 2]``: the angle of each rotary
    pair at each patch (row-major), pair 2i on the column, 2i + 1 on the
    row."""
    freqs = 1.0 / theta ** (torch.arange(0, head_dim, 4, device=device)
                            [: head_dim // 4].float() / head_dim)
    r = torch.arange(rows, device=device).float().repeat_interleave(cols)
    c = torch.arange(cols, device=device).float().repeat(rows)
    return torch.stack((c[:, None] * freqs, r[:, None] * freqs),
                       dim=-1).flatten(1)


def grid_positions(table: torch.Tensor, rows: int, cols: int
                   ) -> torch.Tensor:
    """The learned ``[G, G, w]`` table at a ``rows × cols`` patch grid,
    ``[rows · cols, w]``: as it is where the grid is ``G × G``, else
    resized bicubically (align_corners False) in float32."""
    if tuple(table.shape[:2]) == (rows, cols):
        return table.flatten(0, 1)
    out = F.interpolate(table.permute(2, 0, 1)[None].float(),
                        size=(rows, cols), mode="bicubic",
                        align_corners=False)
    return out[0].permute(1, 2, 0).flatten(0, 1).to(table.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.width, cfg.patch_size,
                              stride=cfg.patch_size)
        self.pos_emb = nn.Parameter(
            torch.empty(cfg.pos_grid, cfg.pos_grid, cfg.width))

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """``[N, H, W, 3]`` → (``[N, rows · cols, width]``, rows, cols)."""
        x = self.proj(pixels.permute(0, 3, 1, 2).to(self.proj.weight.dtype))
        rows, cols = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        return x + grid_positions(self.pos_emb, rows, cols), rows, cols


class MoonViTMlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc0 = nn.Linear(width, hidden)
        self.fc1 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(F.gelu(self.fc0(x), approximate="tanh"))


class MoonViTBlock(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.heads = cfg.heads
        self.norm0 = FusedLayerNorm(cfg.width, cfg.norm_eps)
        self.norm1 = FusedLayerNorm(cfg.width, cfg.norm_eps)
        self.wqkv = nn.Linear(cfg.width, 3 * cfg.width)
        self.wo = nn.Linear(cfg.width, cfg.width)
        self.mlp = MoonViTMlp(cfg.width, cfg.mlp)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        n, length, width = x.shape
        qkv = self.wqkv(self.norm0(x)).view(n, length, 3, self.heads, -1)
        q = rotate_pairs(qkv[:, :, 0], cos, sin).transpose(1, 2)
        k = rotate_pairs(qkv[:, :, 1], cos, sin).transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v)
        x = x + self.wo(o.transpose(1, 2).reshape(n, length, width))
        return x + self.mlp(self.norm1(x))


class MoonViTEncoder(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.blocks = nn.ModuleList(MoonViTBlock(cfg)
                                    for _ in range(cfg.layers))
        self.final_layernorm = FusedLayerNorm(cfg.width, cfg.norm_eps)


class MoonViT(nn.Module):
    """Frames → merged patch tokens ``[N, rows/2 · cols/2, 4, width]``."""

    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.encoder = MoonViTEncoder(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x, rows, cols = self.patch_embed(pixels)
        angles = rope_2d_angles(rows, cols, cfg.width // cfg.heads,
                                cfg.rope_theta, x.device)[:, None]
        cos, sin = angles.cos(), angles.sin()
        for block in self.encoder.blocks:
            x = block(x, cos, sin)
        x = self.encoder.final_layernorm(x)
        return merge_patches(x, rows, cols, cfg.merge)


def merge_patches(x: torch.Tensor, rows: int, cols: int, m: int
                  ) -> torch.Tensor:
    """``[N, rows · cols, w]`` → ``[N, rows/m · cols/m, m · m, w]``: each
    m × m neighbourhood, row-major inside it."""
    n, _, w = x.shape
    x = x.view(n, rows // m, m, cols // m, m, w).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (rows // m) * (cols // m), m * m, w)


class Projector(nn.Module):
    """Kimi-VL's multi-modal projector: ``[..., m², w]`` →
    ``[..., hidden]``."""

    def __init__(self, width: int, merged: int, hidden: int,
                 eps: float = 1e-5):
        super().__init__()
        self.pre_norm = FusedLayerNorm(width, eps)
        self.linear_1 = nn.Linear(merged * width, merged * width)
        self.linear_2 = nn.Linear(merged * width, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_norm(x).flatten(-2)
        return self.linear_2(F.gelu(self.linear_1(x)))
