"""The defaults of the caption step, the teacher and the train step.

A copy of the values the port needs from the JAX package: importing
``rtvc_tpu.config`` would import ``rtvc_tpu``, whose ``__init__`` imports
jax. A test holds every field here equal to its JAX counterpart:

- :class:`StudentConfig` ➜ ``rtvc_tpu/config.py`` ``StudentConfig``;
- :class:`TinyViTConfig`, :func:`tiny_vit_21m_config`,
  :func:`tiny_vit_5m_config` ➜ ``rtvc_tpu/models/tinyvit.py`` (``dtype``
  as a torch dtype);
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
  ``tpu.remat_encoder``, the mesh (``tpu.mesh_shape``, ``tpu.mesh_axes``,
  ``tpu.multihost``: ``rtvc_tpu_torch.parallel``) and ``seed`` (the
  random inits, the caption choice of the loaders, the shuffle and the
  dropout draws);
- the reference-style access of ``rtvc_tpu/config.py``:
  ``Config.__getitem__`` (``cfg["TRAIN"]["BATCH_SIZE"]``, read-only
  :class:`_DictView` s with the reference's UPPER keys) and
  :func:`from_dict`; the six ported ``tpu`` fields sit on ``Config``
  itself and are read and overridden under ``"TPU"`` / ``"tpu"`` as JAX's;
- :class:`MoonViTConfig`, :class:`KimiVLConfig` and
  :func:`kimi_vl_a3b_config` have no JAX counterpart: Kimi-VL-A3B-Instruct,
  the vision-language captioner the port serves beside the student
  (``models/kimi_vl.py``);
- not ported: ``tpu.steps_per_dispatch`` (a scan over batches that
  measured slower on the TPU; CUDA graphs are the GPU's analogue).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

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


def tiny_vit_5m_config(**overrides) -> TinyViTConfig:
    """tiny_vit_5m_224 hyperparameters."""
    config = TinyViTConfig(embed_dims=(64, 128, 160, 320),
                           depths=(2, 2, 6, 2), num_heads=(2, 4, 5, 10),
                           window_sizes=(7, 7, 14, 7), drop_path_rate=0.0)
    return dataclasses.replace(config, **overrides)


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
class MoonViTConfig:
    """MoonViT, Kimi-VL's image tower, and its 2×2 merge. The widths are
    SigLIP-so400m-patch14's, from which MoonViT was initialised (the
    published config gives none): pre-LayerNorm blocks with qkv and output
    biases, a tanh-GELU MLP, 2D RoPE on q and k, a learned ``pos_grid``²
    position table resized bicubically to the patch grid."""
    image_size: int = 448
    patch_size: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp: int = 4304
    pos_grid: int = 64
    merge: int = 2
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5


@dataclass(frozen=True)
class KimiVLConfig:
    """Kimi-VL-A3B-Instruct (moonshotai/Kimi-VL-A3B-Instruct config.json):
    MoonViT and an MLP projector in front of a DeepSeek-V3-style language
    model (MLA without a q latent, sigmoid-scored experts with a correction
    bias, shared experts, leading dense layers). ``eos_token_id`` is the
    tokenizer's, assumed; ``pixel_mean`` / ``pixel_std`` are the
    processor's 0.5 / 0.5."""
    vision: MoonViTConfig = field(default_factory=MoonViTConfig)
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    max_position_embeddings: int = 131072
    eos_token_id: int = 163585
    pixel_mean: Tuple[float, ...] = (0.5, 0.5, 0.5)
    pixel_std: Tuple[float, ...] = (0.5, 0.5, 0.5)
    dtype: torch.dtype = torch.bfloat16


def kimi_vl_a3b_config(**overrides) -> KimiVLConfig:
    """Kimi-VL-A3B-Instruct at its published widths (16.4 B parameters)."""
    return dataclasses.replace(KimiVLConfig(), **overrides)


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
    # (dp, tp); -1 = all remaining ranks          TpuConfig.mesh_shape
    mesh_shape: Tuple[int, ...] = (-1, 1)
    mesh_axes: Tuple[str, ...] = ("dp", "tp")   # TpuConfig.mesh_axes
    multihost: bool = False              # TpuConfig.multihost
    seed: int = 5                        # Config.seed

    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.compute_dtype]

    # ---- dict-compatible view (reference-style access) ------------------
    _ALIASES = {
        "SEED": ("seed",),
        "DATA": ("data",),
        "CALLBACK": ("callback",),
        "LOGGER": ("logger",),
        "TRAIN": ("train",),
        "MODEL": None,  # handled specially below
        "TPU": None,    # the ported TpuConfig fields, below
        "WANDB": ("wandb",),
    }

    def __getitem__(self, key: str) -> Any:
        if key == "MODEL":
            return {
                "StudentCandidateV1": _as_view(self.student),
                "GenerativeImageTextTeacher": _as_view(self.teacher),
            }
        if key == "TPU":
            return _DictView({name: getattr(self, name)
                              for name in TPU_FIELDS})
        path = self._ALIASES.get(key)
        if path is None:
            raise KeyError(key)
        obj: Any = self
        for attr in path:
            obj = getattr(obj, attr)
        return _as_view(obj)


# the fields of JAX's ``Config.tpu`` that the port keeps on ``Config``
TPU_FIELDS = ("compute_dtype", "quantize_teacher", "remat_encoder",
              "mesh_shape", "mesh_axes", "multihost")


class _DictView(dict):
    """Read-only dict view over a dataclass, with reference-style UPPER
    keys."""


_UPPER_KEYS = {
    # reference key -> dataclass attr
    "VIDEOS_PATH": "videos_path",
    "CAPTIONS_PATH": "captions_path",
    "ENCODED_CAPTION_IDS": "encoded_caption_ids",
    "STUDENT_MODEL_DEF": "student_model_def",
    "TEACHER_MODEL_DEF": "teacher_model_def",
    "TRAINER": "trainer",
    "LR": "lr",
    "BATCH_SIZE": "batch_size",
    "MODE": "mode",
    "max_epochs": "max_epochs",
    "precision": "precision",
    "enable_checkpointing": "enable_checkpointing",
    "strategy": "strategy",
}


def _as_view(obj: Any) -> Any:
    if not dataclasses.is_dataclass(obj):
        return obj
    view = _DictView()
    for f in dataclasses.fields(obj):
        view[f.name] = _as_view(getattr(obj, f.name))
    # add reference-style UPPER aliases
    for upper, attr in _UPPER_KEYS.items():
        if attr in view and upper not in view:
            view[upper] = view[attr]
    return view


def from_dict(overrides: Mapping[str, Any],
              base: Optional[Config] = None) -> Config:
    """Build a Config from a (possibly nested) plain-dict override tree,
    keys in either case. A ``tpu`` subtree sets the ported TpuConfig
    fields (``TPU_FIELDS``); any other key raises KeyError."""
    base = base or Config()

    def merge(dc: Any, over: Mapping[str, Any]) -> Any:
        updates = {}
        fields = {f.name for f in dataclasses.fields(dc)}
        for key, value in over.items():
            name = key.lower() if key.lower() in fields else key
            if dc is base and name.lower() == "tpu" \
                    and isinstance(value, Mapping):
                updates.update(merge_tpu(value))
                continue
            if name not in fields:
                raise KeyError(f"unknown config key {key!r} for "
                               f"{type(dc).__name__}")
            current = getattr(dc, name)
            if dataclasses.is_dataclass(current) and isinstance(value,
                                                                Mapping):
                updates[name] = merge(current, value)
            else:
                updates[name] = value
        return dataclasses.replace(dc, **updates)

    def merge_tpu(over: Mapping[str, Any]) -> dict:
        out = {}
        for key, value in over.items():
            if key.lower() not in TPU_FIELDS:
                raise KeyError(f"unknown config key {key!r} for TpuConfig "
                               f"(the port keeps {TPU_FIELDS})")
            out[key.lower()] = value
        return out

    return merge(base, overrides)


# The global default, mirroring the reference's module-level ``cfg``.
cfg = Config()
