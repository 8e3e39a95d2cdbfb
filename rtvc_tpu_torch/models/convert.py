"""JAX parameter trees → the port's state dicts (the weight bridge).

:func:`student_state_dict_from_jax` is the inverse of
``rtvc_tpu.models.convert.student_params_from_torch``: it takes the JAX
student's ``params`` and ``batch_stats`` (nested dicts of arrays) and
returns the reference's torch state dict, which
:class:`~rtvc_tpu_torch.models.student.StudentCandidateV1` loads.
:func:`teacher_state_dict_from_jax` is the inverse of
``git_teacher_params_from_torch``: the GIT ``model.pt`` keys that
:class:`~rtvc_tpu_torch.models.git_teacher.GITTeacher` loads, with each
packed ``qkv`` split back into the reference's query, key and value. Dense
kernels ``[in, out]`` become Linear weights ``[out, in]``; HWIO conv
kernels become OIHW; LayerNorm/BatchNorm ``scale`` becomes ``weight``; BN
``mean``/``var`` become ``running_mean``/``running_var``; the packed
``in_proj_kernel`` becomes ``in_proj_weight``. No jax import: leaves are
read with ``numpy.asarray``.

:func:`clip_params_from_hf` and :func:`git_teacher_params_from_hf` are the
transformers bridge, under JAX's names: a ``CLIPVisionModel`` or
``GitForCausalLM`` state dict remapped onto the keys that
:class:`~rtvc_tpu_torch.models.clip_vit.CLIPViT` and
:class:`~rtvc_tpu_torch.models.git_teacher.GITTeacher` load (both keep
torch's layouts, so no tensor is transposed), each with the list of source
keys left unused; :func:`git_config_from_hf` reads the matching
``GITConfig`` fields off a transformers ``GitConfig``.

:func:`student_jax_path`, :func:`to_jax_layout` and
:func:`from_jax_layout` go the other way for one student entry: its key
path in the JAX tree and its values in the JAX layout, for code that must
walk the weights in JAX's order (``pruning``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# JAX module name → torch path (the timm / reference layout)
_MODULE_RULES = (
    (re.compile(r"stage(\d+)_block(\d+)"), r"stages.\1.blocks.\2"),
    (re.compile(r"stage(\d+)_downsample"), r"stages.\1.downsample"),
    (re.compile(r"decoder_layer_(\d+)"), r"decoder.layers.\1"),
    (re.compile(r"projector_(\d+)"), r"projectors.\1"),
    (re.compile(r"cross_attn"), "multihead_attn"),
    (re.compile(r"image_encoder"), "image_encoder.model"),
)
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "in_proj_kernel": "in_proj_weight", "mean": "running_mean",
               "var": "running_var"}


# torch module path → JAX module names: the inverse of _MODULE_RULES, on
# whole dotted components
_INVERSE_RULES = tuple(
    (re.compile(r"(?<![^.])" + pattern + r"(?![^.])"), repl) for
    pattern, repl in ((r"image_encoder\.model", "image_encoder"),
                      (r"stages\.(\d+)\.blocks\.(\d+)", r"stage\1_block\2"),
                      (r"stages\.(\d+)\.downsample", r"stage\1_downsample"),
                      (r"decoder\.layers\.(\d+)", r"decoder_layer_\1"),
                      (r"projectors\.(\d+)", r"projector_\1"),
                      (r"multihead_attn", "cross_attn")))
# the student's JAX modules whose ``embedding`` leaf is a torch ``weight``
# (its one nn.Embedding)
_EMBEDDINGS = ("embed",)


def _module_path(parts: List[str]) -> str:
    out = []
    for part in parts:
        for pattern, repl in _MODULE_RULES:
            if pattern.fullmatch(part):
                part = pattern.sub(repl, part)
                break
        out.append(part)
    return ".".join(out)


def _leaf(name: str, value: Any) -> torch.Tensor:
    # Dense [in, out] -> Linear [out, in]; conv HWIO -> OIHW (a copy: the
    # JAX leaf's buffer may be read-only)
    return from_jax_layout(torch.from_numpy(np.array(value)),
                           name).contiguous()


def _walk(tree: Mapping[str, Any], parts: List[str],
          out: Dict[str, torch.Tensor]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, parts + [key], out)
        else:
            name = _module_path(parts)
            out[f"{name}.{_LEAF_NAMES.get(key, key)}"] = _leaf(key, value)


def student_jax_path(key: str, ndim: int) -> Tuple[str, ...]:
    """The key path in the JAX student's ``params`` (or ``batch_stats``)
    of the student state-dict entry ``key`` holding an ``ndim``-dimensional
    tensor: the inverse of :func:`student_state_dict_from_jax`'s names."""
    module, _, leaf = key.rpartition(".")
    for pattern, repl in _INVERSE_RULES:
        module = pattern.sub(repl, module)
    if leaf == "weight":
        leaf = ("embedding" if module in _EMBEDDINGS else
                "scale" if ndim == 1 else "kernel")
    else:
        leaf = {v: k for k, v in _LEAF_NAMES.items()
                if v != "weight"}.get(leaf, leaf)
    return tuple(module.split(".")) + (leaf,)


def to_jax_layout(t: torch.Tensor, leaf: str) -> torch.Tensor:
    """A torch entry's values in the layout of its JAX ``leaf``: Linear
    ``[out, in]`` → Dense ``[in, out]``, conv OIHW → HWIO (views)."""
    if leaf in ("kernel", "in_proj_kernel"):
        return t.t() if t.ndim == 2 else t.permute(2, 3, 1, 0)
    return t


def from_jax_layout(a: torch.Tensor, leaf: str) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout` (views)."""
    if leaf in ("kernel", "in_proj_kernel"):
        return a.t() if a.ndim == 2 else a.permute(3, 2, 0, 1)
    return a


def student_state_dict_from_jax(params: Mapping[str, Any],
                                batch_stats: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``StudentCandidateV1`` variables → torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, [], out)
    _walk(batch_stats, [], out)
    return out


def teacher_state_dict_from_jax(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``GITTeacher`` params → the reference ``model.pt`` state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(dst: str, tree: Mapping[str, Any]) -> None:
        for key, value in tree.items():
            out[f"{dst}.{_LEAF_NAMES.get(key, key)}"] = _leaf(key, value)

    def split_qkv(names, tree: Mapping[str, Any]) -> None:
        for key, value in tree.items():
            parts = np.split(np.asarray(value), 3, axis=-1)
            for name, part in zip(names, parts):
                put(name, {key: part})

    enc = params["image_encoder"]
    put("image_encoder.conv1", enc["conv1"])
    for key in ("class_embedding", "positional_embedding"):
        out[f"image_encoder.{key}"] = _leaf(key, enc[key])
    for key in ("ln_pre", "ln_post"):
        put(f"image_encoder.{key}", enc[key])
    i = 0
    while f"resblock_{i}" in enc:
        blk = enc[f"resblock_{i}"]
        base = f"image_encoder.transformer.resblocks.{i}"
        for src, dst in (("ln_1", "ln_1"), ("ln_2", "ln_2"),
                         ("mlp_fc", "mlp.c_fc"), ("mlp_proj", "mlp.c_proj")):
            put(f"{base}.{dst}", blk[src])
        put(f"{base}.attn.out_proj", blk["attn"]["out_proj"])
        qkv = blk["attn"]["qkv"]
        out[f"{base}.attn.in_proj_weight"] = _leaf("kernel", qkv["kernel"])
        out[f"{base}.attn.in_proj_bias"] = _leaf("bias", qkv["bias"])
        i += 1
    i = 0
    while f"img_temporal_embedding_{i}" in params:
        out[f"img_temperal_embedding.{i}"] = _leaf(
            "embedding", np.asarray(params[f"img_temporal_embedding_{i}"])
            .reshape(1, 1, -1))
        i += 1

    tx, t = params["textual"], "textual"
    for src, dst in (("visual_projection", "visual_projection.0"),
                     ("visual_ln", "visual_projection.1"),
                     ("word_embeddings", "embedding.words"),
                     ("position_embeddings", "embedding.positions"),
                     ("emb_norm", "embedding.layer_norm"),
                     ("output", "output")):
        put(f"{t}.{dst}", tx[src])
    i = 0
    while f"layer_{i}" in tx:
        layer, base = tx[f"layer_{i}"], f"{t}.transformer.encoder.layer.{i}"
        split_qkv([f"{base}.attention.self.{p}"
                   for p in ("query", "key", "value")], layer["qkv"])
        for src, dst in (("attn_out", "attention.output.dense"),
                         ("attn_norm", "attention.output.LayerNorm"),
                         ("inter", "intermediate.dense"),
                         ("out", "output.dense"),
                         ("out_norm", "output.LayerNorm")):
            put(f"{base}.{dst}", layer[src])
        i += 1
    return out


# ---------------------------------------------------------------------------
# transformers (GitForCausalLM / CLIPVisionModel state dicts)
# ---------------------------------------------------------------------------

StateDict = Mapping[str, torch.Tensor]


def _layer_indices(sd: StateDict, pattern: str) -> int:
    """Count consecutive layer indices for keys like pattern.format(i)."""
    n = 0
    while pattern.format(n) in sd:
        n += 1
    return n


def _copy(sd: StateDict, out: Dict[str, torch.Tensor], used: set,
          src: str, dst: str, leaves=("weight", "bias")) -> None:
    for leaf in leaves:
        out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]
        used.add(f"{src}.{leaf}")


def clip_params_from_hf(sd: StateDict, prefix: str
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A transformers CLIP vision tower (keys ``<prefix>embeddings...``) →
    (the :class:`CLIPViT` state dict, the source keys under ``prefix`` left
    unused). Each block's q, k and v projections are packed into the
    ``in_proj`` weight and bias in that order."""
    used: set = set()
    p = prefix
    out: Dict[str, torch.Tensor] = {
        "class_embedding": sd[p + "embeddings.class_embedding"],
        "positional_embedding": sd[p + "embeddings.position_embedding.weight"],
    }
    _copy(sd, out, used, p + "embeddings.patch_embedding", "conv1",
          ("weight",))
    _copy(sd, out, used, p + "pre_layrnorm", "ln_pre")  # HF's spelling
    _copy(sd, out, used, p + "post_layernorm", "ln_post")
    used.update({p + "embeddings.class_embedding",
                 p + "embeddings.position_embedding.weight",
                 p + "embeddings.position_ids"})  # buffer in older dumps
    for i in range(_layer_indices(
            sd, p + "encoder.layers.{}.layer_norm1.weight")):
        src, dst = f"{p}encoder.layers.{i}", f"transformer.resblocks.{i}"
        for leaf in ("weight", "bias"):
            names = [f"{src}.self_attn.{x}_proj.{leaf}" for x in "qkv"]
            out[f"{dst}.attn.in_proj_{leaf}"] = torch.cat(
                [sd[n] for n in names])
            used.update(names)
        for s, d in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                     ("self_attn.out_proj", "attn.out_proj"),
                     ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            _copy(sd, out, used, f"{src}.{s}", f"{dst}.{d}")
    unused = [k for k in sd if k.startswith(p) and k not in used]
    return out, unused


def git_teacher_params_from_hf(sd: StateDict
                               ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """transformers ``GitForCausalLM.state_dict()`` → (the
    :class:`GITTeacher` state dict, the keys left unused). Layer and frame
    counts are read off the keys; both spellings of the temporal embedding
    are read, and the output weight is taken from the tied word embedding
    where the dump carries no ``output.weight``."""
    used: set = set()
    clip, clip_unused = clip_params_from_hf(
        sd, prefix="git.image_encoder.vision_model.")
    out = {f"image_encoder.{k}": v for k, v in clip.items()}
    # HF used GIT's original `img_temperal_embedding` through 4.56, then
    # fixed the typo
    for spelled in ("git.img_temporal_embedding.{}",
                    "git.img_temperal_embedding.{}"):
        num_frames = _layer_indices(sd, spelled)
        if num_frames:
            break
    for i in range(num_frames):
        key = spelled.format(i)
        out[f"img_temperal_embedding.{i}"] = sd[key].reshape(1, 1, -1)
        used.add(key)
    t = "textual"
    for src, dst in (("git.visual_projection.visual_projection.0",
                      "visual_projection.0"),
                     ("git.visual_projection.visual_projection.1",
                      "visual_projection.1"),
                     ("git.embeddings.LayerNorm", "embedding.layer_norm")):
        _copy(sd, out, used, src, f"{t}.{dst}")
    for src, dst in (("word_embeddings", "words"),
                     ("position_embeddings", "positions")):
        _copy(sd, out, used, f"git.embeddings.{src}",
              f"{t}.embedding.{dst}", ("weight",))
    used.add("git.embeddings.position_ids")
    out[f"{t}.output.weight"] = sd.get(
        "output.weight", sd["git.embeddings.word_embeddings.weight"])
    out[f"{t}.output.bias"] = sd["output.bias"]
    used.update({"output.weight", "output.bias"})
    for i in range(_layer_indices(
            sd, "git.encoder.layer.{}.attention.self.query.weight")):
        for part in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense",
                     "attention.output.LayerNorm", "intermediate.dense",
                     "output.dense", "output.LayerNorm"):
            _copy(sd, out, used, f"git.encoder.layer.{i}.{part}",
                  f"{t}.transformer.encoder.layer.{i}.{part}")
    unused = clip_unused + [k for k in sd if not k.startswith(
        "git.image_encoder.") and k not in used]
    return out, unused


def git_config_from_hf(cfg) -> Dict[str, Any]:
    """transformers ``GitConfig`` (or its dict) → ``GITConfig`` keyword
    arguments, with the CLIP tower's under ``clip_kwargs`` (JAX's
    ``git_config_from_hf``)."""
    if hasattr(cfg, "to_dict"):
        cfg = cfg.to_dict()
    vis = cfg["vision_config"]
    return dict(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        attention_heads=cfg["num_attention_heads"],
        feedforward_size=cfg["intermediate_size"],
        visual_feature_size=vis["hidden_size"],
        max_caption_length=cfg["max_position_embeddings"],
        num_image_with_embedding=cfg["num_image_with_embedding"] or 1,
        clip_kwargs=dict(
            image_size=vis["image_size"], patch_size=vis["patch_size"],
            width=vis["hidden_size"], layers=vis["num_hidden_layers"],
            heads=vis["num_attention_heads"]),
    )
