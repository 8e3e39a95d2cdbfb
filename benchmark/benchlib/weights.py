"""Seeded weights, made on the device in one draw and handed to both sides.

The rule a parameter is drawn by follows from its name and shape alone
(LeCun-normal matrices and convolutions, unit-normal word and position
tables, N(0, width^-1/2) CLIP and temporal embeddings, N(0, 0.1) window
attention biases, biases and norm shifts, N(1, 0.1) norm scales), so the
program's modules and the reference's parameter list get the same
values. Every BatchNorm also gets running statistics: a mean N(0, 0.1)
and a variance exp(N(0, 0.2)), as ``<norm>.running_mean`` and
``<norm>.running_var`` beside its parameters. Nothing is a constant, so a
bias dropped or doubled, or a norm's scale, shift or running statistics
applied wrongly, moves the outputs the check compares.
:func:`make` draws every value of a model in one call from a device
generator seeded from the run's seed, scales each leaf and rounds it to
the type it is served in; the reference upcasts those same values.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Spec = Sequence[Tuple[str, Tuple[int, ...]]]

UNIT_TABLES = ("embed.weight", "textual.embedding.words.weight",
               "textual.embedding.positions.weight")
WIDTH_TABLES = ("image_encoder.class_embedding",
                "image_encoder.positional_embedding")


SMALL = 0.1    # biases, norm shifts and scales' spread, BatchNorm means
LOG_VAR = 0.2  # spread of the log of a BatchNorm's running variance


def rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of the normal draw of one parameter or statistic."""
    if name.endswith("attention_biases"):
        return 0.0, 0.1
    if name in UNIT_TABLES:
        return 0.0, 1.0
    if name in WIDTH_TABLES or name.startswith("img_temperal_embedding."):
        return 0.0, shape[-1] ** -0.5
    if name.endswith("running_var"):
        return 0.0, LOG_VAR  # exponentiated in make()
    if len(shape) == 1:
        return (0.0 if name.endswith(("bias", "running_mean")) else 1.0,
                SMALL)
    return 0.0, math.prod(shape[1:]) ** -0.5


def with_statistics(spec: Spec) -> Spec:
    """``spec`` and, after each BatchNorm's scale, its running mean and
    variance."""
    out = []
    for name, shape in spec:
        out.append((name, shape))
        if name.endswith(".bn.weight"):
            norm = name[: -len(".weight")]
            out += [(f"{norm}.running_mean", shape),
                    (f"{norm}.running_var", shape)]
    return out


def make(spec: Spec, seed: int, device, dtype: torch.dtype
         ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``spec``, and every BatchNorm's running
    statistics, in ``dtype`` on ``device``."""
    spec = with_statistics(spec)
    total = sum(math.prod(s) for _, s in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in spec:
        mean, std = rule(name, shape)
        n = math.prod(shape)
        v = flat[at:at + n].view(shape) * std + mean
        if name.endswith("running_var"):
            v = v.exp()
        out[name] = v.to(dtype)
        at += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, values: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``values`` into ``module``'s parameters and BatchNorm running
    statistics, which must be exactly the names and shapes of the spec."""
    params = dict(module.named_parameters())
    params.update((n, b) for n, b in module.named_buffers()
                  if n.endswith(("running_mean", "running_var")))
    missing = sorted(set(values) - set(params))
    extra = sorted(set(params) - set(values))
    if missing or extra:
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's: not in the program {missing[:5]}, "
                         f"not in the benchmark {extra[:5]}")
    for name, p in params.items():
        v = values[name]
        if tuple(p.shape) != tuple(v.shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                             f"{tuple(v.shape)}")
        p.copy_(v)
