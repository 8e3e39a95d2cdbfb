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
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

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
    a = np.asarray(value)
    if name in ("kernel", "in_proj_kernel"):
        # Dense [in, out] -> Linear [out, in]; conv HWIO -> OIHW
        a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


def _walk(tree: Mapping[str, Any], parts: List[str],
          out: Dict[str, torch.Tensor]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, parts + [key], out)
        else:
            name = _module_path(parts)
            out[f"{name}.{_LEAF_NAMES.get(key, key)}"] = _leaf(key, value)


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
