"""JAX parameter trees → the port's state dict (the weight bridge).

The inverse of ``rtvc_tpu.models.convert.student_params_from_torch``: it
takes the JAX student's ``params`` and ``batch_stats`` (nested dicts of
arrays) and returns the reference's torch state dict, which
:class:`~rtvc_tpu_torch.models.student.StudentCandidateV1` loads. Dense
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
