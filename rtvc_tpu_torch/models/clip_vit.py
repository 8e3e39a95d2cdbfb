"""CLIP ViT image tower (the GIT teacher's frame encoder), inference only.

Counterpart of ``rtvc_tpu/models/clip_vit.py``: OpenAI CLIP's visual
transformer as GIT modified it, returning the full token grid (1 CLS + the
patches) after ``ln_post``, without the contrastive projection. A 14×14
stride-14 patch conv (no bias) → CLS embedding → learned positional
embedding → ``ln_pre`` → pre-LN residual blocks (QuickGELU MLP) →
``ln_post``.

The module tree has the reference's state-dict keys (``conv1``,
``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``, ``ln_post``), which
``rtvc_tpu.models.convert.clip_params_from_torch`` reads. Kernels on a
card: K2 for ln_pre, ln_1 and ln_post; K5 for the attention, on the QKV
product's ``[B, L, H, D]`` view; K6 for the residual add and ln_2; K7 for
every Linear of a quantized tower.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import CLIPViTConfig, clip_vit_l14_config
from ..ops.attention import blhd_attention
from ..ops.layernorm import FusedAddLayerNorm, FusedLayerNorm
from ..ops.quantization import quantize_teacher_
from .layers import save_under_reference_keys


def clip_vit_b16_config(**overrides) -> CLIPViTConfig:
    """CLIP ViT-B/16 at 224 px: 197 tokens of width 768."""
    cfg = CLIPViTConfig(patch_size=16, width=768, layers=12, heads=12)
    return dataclasses.replace(cfg, **overrides)


IMAGE_ENCODERS = {
    "CLIPViT_L_14": clip_vit_l14_config,
    "CLIPViT_B_16": clip_vit_b16_config,
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's QuickGELU: x · sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Self-attention with one packed q|k|v Linear (saved as the
    reference's ``in_proj_weight`` / ``in_proj_bias``) and ``out_proj``."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width = width
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        save_under_reference_keys(self, "qkv", {"weight": ["in_proj_weight"],
                                                "bias": ["in_proj_bias"]})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        # q, k and v as strided [B, L, H, D] views of the product: K5 reads
        # them in place
        q, k, v = self.qkv(x).view(b, l, 3, self.heads, -1).unbind(2)
        out = blhd_attention(q, k, v)
        return self.out_proj(out.view(b, l, self.width))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP; the residual add and
    ln_2 run as one op."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = FusedLayerNorm(width)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = FusedAddLayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width),
                                  "c_proj": nn.Linear(4 * width, width)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, h = self.ln_2(x, self.attn(self.ln_1(x)))
        return x + self.mlp["c_proj"](quick_gelu(self.mlp["c_fc"](h)))


class CLIPViT(nn.Module):
    """``forward(x, block_indices)`` → (tokens ``[B, 1 + grid², width]``,
    the block outputs at the requested indices)."""

    def __init__(self, config: CLIPViTConfig = clip_vit_l14_config()):
        super().__init__()
        self.config = cfg = config
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, cfg.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, cfg.width))
        self.ln_pre = FusedLayerNorm(cfg.width)
        self.transformer = nn.ModuleDict({"resblocks": nn.ModuleList(
            [ResidualAttentionBlock(cfg.width, cfg.heads)
             for _ in range(cfg.layers)])})
        self.ln_post = FusedLayerNorm(cfg.width)

    def forward(self, x: torch.Tensor,
                block_indices: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``x [B, H, W, 3]`` (or ``[B, 3, H, W]``) frames."""
        dtype = self.conv1.weight.dtype
        x = x.to(dtype)
        if not (x.shape[1] == 3 and x.shape[-1] != 3):  # NHWC → NCHW
            x = x.permute(0, 3, 1, 2)
        x = self.conv1(x).flatten(2).transpose(1, 2)  # [B, grid², width]
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        wanted = set(block_indices or [])
        taps: List[torch.Tensor] = []
        for i, block in enumerate(self.transformer["resblocks"]):
            x = block(x)
            if i in wanted:
                taps.append(x)
        return self.ln_post(x), taps


def get_image_encoder(encoder_type: str = "CLIPViT_B_16",
                      input_resolution: int = 224, **overrides) -> CLIPViT:
    """The factory of generativeimage2text's ``get_image_encoder``;
    ``quantized=True`` packs the tower's Linears for K7."""
    if encoder_type not in IMAGE_ENCODERS:
        raise ValueError(f"unknown image encoder {encoder_type!r}; "
                         f"known: {sorted(IMAGE_ENCODERS)}")
    cfg = IMAGE_ENCODERS[encoder_type](image_size=input_resolution,
                                       **overrides)
    model = CLIPViT(cfg).to(cfg.dtype)
    return quantize_teacher_(model) if cfg.quantized else model
