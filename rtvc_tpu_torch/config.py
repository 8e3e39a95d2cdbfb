"""The defaults of the caption step, the teacher and the train step.

A copy of the values the port needs from the JAX package: importing
``rtvc_tpu.config`` would import ``rtvc_tpu``, whose ``__init__`` imports
jax. A test holds every field here equal to its JAX counterpart:

- :class:`StudentConfig` ➜ ``rtvc_tpu/config.py`` ``StudentConfig``;
- :class:`TinyViTConfig`, :func:`tiny_vit_21m_config` ➜
  ``rtvc_tpu/models/tinyvit.py`` (``dtype`` as a torch dtype);
- :class:`CLIPViTConfig`, :func:`clip_vit_l14_config` ➜
  ``rtvc_tpu/models/clip_vit.py``; :class:`GITConfig` ➜
  ``rtvc_tpu/models/git_teacher.py``; :class:`TeacherConfig` ➜
  ``rtvc_tpu/config.py`` ``TeacherConfig`` (``dtype`` as a torch dtype);
- :class:`DataConfig` ➜ ``rtvc_tpu/config.py`` ``DataConfig`` (the data
  paths, relative to the working directory, ``num_frames`` and the
  loader's ``prefetch_depth``) and :class:`LoggerConfig` ➜
  ``LoggerConfig`` (where runs and their checkpoints live);
- :class:`TrainConfig` ➜ the fields of ``rtvc_tpu/config.py``
  ``TrainConfig`` that the train step and ``train()`` read (``lr``,
  ``batch_size``, the ``plateau_*`` scheduler or ``onecycle``,
  ``grad_accum_steps``, the teacher-output caches, ``eval_beam_size``,
  ``async_checkpointing``, ``checkpoint_on_preemption``), with
  :class:`TrainerConfig` ➜ ``TrainerConfig`` (``max_epochs``,
  ``precision``, ``enable_checkpointing``); :class:`CallbackConfig` ➜
  ``CheckpointConfig.save_top_k``; :class:`WandbConfig` ➜ ``WandbConfig``;
- ``train()`` reads ``DataConfig.wordnet_path`` (METEOR's synonym stage)
  and ``TrainConfig.eval_beam_size``; ``DataConfig.sampler`` is held equal
  to JAX's, but neither package reads it;
- :class:`Config` ➜ the fields of ``rtvc_tpu.config.Config`` the student,
  the teacher, the train loop and evaluation are built from: ``data``,
  ``callback``, ``logger``, ``student``, ``teacher``, ``train``,
  ``wandb``, ``tpu.compute_dtype``, ``tpu.quantize_teacher``,
  ``tpu.remat_encoder`` and ``seed`` (the random inits, the caption
  choice of the loaders, the shuffle and the dropout draws);
- not ported: ``tpu.steps_per_dispatch`` (a scan over batches that
  measured slower on the TPU; CUDA graphs are the GPU's analogue).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import torch


@dataclass(frozen=True)
class DataConfig:
    videos_path: str = "data/MSRVTT/videos/all"
    captions_path: str = "data/labels/labels.csv"
    encoded_caption_ids: str = "data/labels/encoded_captions.pkl"
    annotation_path: str = "data/MSRVTT/annotation/MSR_VTT.json"
    num_frames: int = 6
    prefetch_depth: int = 2
    sampler: str = "even"  # one of data.frame_sampling.SAMPLERS
    # WordNet database dir (or synonym-group file) for METEOR's synonym
    # stage (metrics.load_wordnet_synonyms); '' = exact + stem only
    wordnet_path: str = ""


@dataclass(frozen=True)
class CallbackConfig:
    save_top_k: int = 1  # epoch checkpoints kept, newest first


@dataclass(frozen=True)
class LoggerConfig:
    save_dir: str = "results/"
    name: str = "captions"


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
class CLIPViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    dtype: torch.dtype = torch.float32
    quantized: bool = False  # W8A8 Linears (frozen-teacher inference only)


def clip_vit_l14_config(**overrides) -> CLIPViTConfig:
    """CLIP ViT-L/14 at 224 px: 257 tokens of width 1024 (the teacher's
    image tower)."""
    return dataclasses.replace(CLIPViTConfig(), **overrides)


@dataclass(frozen=True)
class GITConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    attention_heads: int = 12
    feedforward_size: int = 3072
    visual_feature_size: int = 1024
    max_caption_length: int = 1024
    num_image_with_embedding: int = 6
    dropout: float = 0.1
    clip: CLIPViTConfig = clip_vit_l14_config()
    dtype: torch.dtype = torch.float32
    quantized: bool = False  # W8A8 textual-head Linears


@dataclass(frozen=True)
class TeacherConfig:
    param_path: str = "data/teacher_configs/GIT_LARGE_MSRVTT/parameter.yaml"
    pretrained_weights: str = "results/model.pt"
    num_image_with_embedding: int = 6
    visual_feature_size: int = 1024
    image_encoder_type: str = "CLIPViT_L_14"
    hidden_size: int = 768
    num_layers: int = 6
    attention_heads: int = 12
    feedforward_size: int = 3072
    vocab_size: int = 30522
    max_caption_length: int = 1024
    beam_size: int = 4
    max_steps: int = 15
    length_penalty: float = 0.6


@dataclass(frozen=True)
class TrainerConfig:
    max_epochs: int = 20
    precision: str = "bf16"
    enable_checkpointing: bool = True


@dataclass(frozen=True)
class TrainConfig:
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    lr: float = 1e-4
    batch_size: int = 8
    plateau_patience: int = 4
    plateau_factor: float = 0.5
    plateau_min_lr: float = 1e-8
    # teacher-output caches ('' = off; top_k 0 = full-vocab rows, exact)
    teacher_cache_dir: str = ""
    teacher_cache_top_k: int = 0
    teacher_beam_cache_dir: str = ""
    teacher_beam_cache_top_k: int = 0
    # 0 = greedy eval (the reference's validation decode); K > 0 = the
    # student's K-beam search
    eval_beam_size: int = 0
    async_checkpointing: bool = True
    scheduler: str = "plateau"  # or "onecycle" (needs a sized loader)
    onecycle_max_lr: float = 0.01
    # SIGTERM → ckpt_preempt at the next step boundary
    checkpoint_on_preemption: bool = True
    grad_accum_steps: int = 1


@dataclass(frozen=True)
class WandbConfig:
    mode: str = "offline"


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    callback: CallbackConfig = field(default_factory=CallbackConfig)
    logger: LoggerConfig = field(default_factory=LoggerConfig)
    student: StudentConfig = field(default_factory=StudentConfig)
    teacher: TeacherConfig = field(default_factory=TeacherConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    compute_dtype: str = "bfloat16"      # TpuConfig.compute_dtype
    quantize_teacher: bool = False       # TpuConfig.quantize_teacher
    remat_encoder: bool = False          # TpuConfig.remat_encoder
    seed: int = 5                        # Config.seed

    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.compute_dtype]


cfg = Config()
