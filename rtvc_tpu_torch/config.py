"""The defaults of the caption step.

A copy of the values the port needs from the JAX package: importing
``rtvc_tpu.config`` would import ``rtvc_tpu``, whose ``__init__`` imports
jax. A test holds every field here equal to its JAX counterpart:

- :class:`StudentConfig` ➜ ``rtvc_tpu/config.py`` ``StudentConfig``;
- :class:`TinyViTConfig`, :func:`tiny_vit_21m_config` ➜
  ``rtvc_tpu/models/tinyvit.py`` (``dtype`` as a torch dtype);
- :class:`Config` ➜ the fields of ``rtvc_tpu.config.Config`` the student is
  built from: ``tpu.compute_dtype``, ``data.num_frames`` and the teacher
  widths its distillation heads project to.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import torch


@dataclass(frozen=True)
class StudentConfig:
    image_enc_name: str = "tiny_vit_21m_224"
    d_model: int = 576
    n_head: int = 8
    d_ffn: int = 1024
    dropout: float = 0.3
    num_decoder_layers: int = 2
    vocab_size: int = 30522
    cls_token_id: int = 101
    sep_token_id: int = 102
    max_pos_len: int = 500
    # tanh GELU in the encoder, the JAX student's default; timm's TinyViT
    # (and converted checkpoints) use the exact erf form
    gelu_approximate: bool = True


@dataclass(frozen=True)
class TinyViTConfig:
    embed_dims: Tuple[int, ...] = (96, 192, 384, 576)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 18)
    window_sizes: Tuple[int, ...] = (7, 7, 14, 7)
    mlp_ratio: float = 4.0
    mbconv_expand_ratio: float = 4.0
    drop_path_rate: float = 0.2
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32
    gelu_approximate: bool = False


def tiny_vit_21m_config(**overrides) -> TinyViTConfig:
    """tiny_vit_21m_224 hyperparameters (the student's encoder)."""
    return dataclasses.replace(TinyViTConfig(), **overrides)


@dataclass(frozen=True)
class Config:
    student: StudentConfig = field(default_factory=StudentConfig)
    compute_dtype: str = "bfloat16"      # TpuConfig.compute_dtype
    num_frames: int = 6                  # DataConfig.num_frames
    teacher_visual_dim: int = 1024       # TeacherConfig.visual_feature_size
    teacher_num_frames: int = 6          # TeacherConfig.num_image_with_embedding
    teacher_hidden: int = 768            # TeacherConfig.hidden_size

    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.compute_dtype]


cfg = Config()
