"""Seeded weights of the vision-language captioner, drawn a leaf at a time.

:func:`benchlib.weights.make` draws a whole model in one call, which at
16.4 B parameters would hold 66 GB of float32. Here every leaf has a seed
of its own, ``sub_seed(seed, WEIGHTS, index)`` for its place in
:func:`param_spec`, and is drawn alone on the device in float32, scaled,
and rounded to the served type: set-up never holds more than one leaf in
float32, and the reference draws any leaf again, alone, when it reads it
(:class:`LazyValues`).

The rules follow :func:`benchlib.weights.rule` by name and shape:
biases (the router's correction bias too) N(0, 0.1), norm scales
N(1, 0.1), matrices and convolutions N(0, fan_in^-1/2); and, for this
model, every stacked expert matrix ``[E, out, in]`` N(0, in^-1/2), the
word table N(0, 1), the position table ``[G, G, w]`` N(0, w^-1/2). No
value is a constant, so a dropped bias, norm or correction moves the
compared logits.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

import torch

from . import seeds, weights

Spec = List[Tuple[str, Tuple[int, ...]]]


def param_spec(cfg: dict) -> Spec:
    """(name, shape) of every parameter of the captioner of ``cfg`` (the
    benchmark's configuration file), in a fixed order."""
    v, h = cfg["vision"], cfg["hidden_size"]
    w, m2 = v["width"], v["merge"] ** 2
    spec: Spec = [
        ("vision_tower.patch_embed.proj.weight",
         (w, 3, v["patch_size"], v["patch_size"])),
        ("vision_tower.patch_embed.proj.bias", (w,)),
        ("vision_tower.patch_embed.pos_emb", (v["pos_grid"], v["pos_grid"],
                                              w))]
    for i in range(v["layers"]):
        b = f"vision_tower.encoder.blocks.{i}."
        spec += [(b + "norm0.weight", (w,)), (b + "norm0.bias", (w,)),
                 (b + "norm1.weight", (w,)), (b + "norm1.bias", (w,)),
                 (b + "wqkv.weight", (3 * w, w)), (b + "wqkv.bias", (3 * w,)),
                 (b + "wo.weight", (w, w)), (b + "wo.bias", (w,)),
                 (b + "mlp.fc0.weight", (v["mlp"], w)),
                 (b + "mlp.fc0.bias", (v["mlp"],)),
                 (b + "mlp.fc1.weight", (w, v["mlp"])),
                 (b + "mlp.fc1.bias", (w,))]
    spec += [("vision_tower.encoder.final_layernorm.weight", (w,)),
             ("vision_tower.encoder.final_layernorm.bias", (w,)),
             ("multi_modal_projector.pre_norm.weight", (w,)),
             ("multi_modal_projector.pre_norm.bias", (w,)),
             ("multi_modal_projector.linear_1.weight", (m2 * w, m2 * w)),
             ("multi_modal_projector.linear_1.bias", (m2 * w,)),
             ("multi_modal_projector.linear_2.weight", (h, m2 * w)),
             ("multi_modal_projector.linear_2.bias", (h,)),
             ("language_model.embed_tokens.weight", (cfg["vocab_size"], h))]
    heads, rank = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    e, inter = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = inter * cfg["n_shared_experts"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"language_model.layers.{i}."
        a = p + "self_attn."
        spec += [(p + "input_layernorm.weight", (h,)),
                 (a + "q_proj.weight", (heads * (nope + rope), h)),
                 (a + "kv_a_proj_with_mqa.weight", (rank + rope, h)),
                 (a + "kv_a_layernorm.weight", (rank,)),
                 (a + "kv_b_proj.weight", (heads * (nope + vd), rank)),
                 (a + "o_proj.weight", (h, heads * vd)),
                 (p + "post_attention_layernorm.weight", (h,))]
        m = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            d = cfg["intermediate_size"]
            spec += [(m + "gate_proj.weight", (d, h)),
                     (m + "up_proj.weight", (d, h)),
                     (m + "down_proj.weight", (h, d))]
        else:
            spec += [(m + "gate.weight", (e, h)),
                     (m + "gate.e_score_correction_bias", (e,)),
                     (m + "experts.gate_proj", (e, inter, h)),
                     (m + "experts.up_proj", (e, inter, h)),
                     (m + "experts.down_proj", (e, h, inter)),
                     (m + "shared_experts.gate_proj.weight", (shared, h)),
                     (m + "shared_experts.up_proj.weight", (shared, h)),
                     (m + "shared_experts.down_proj.weight", (h, shared))]
    spec += [("language_model.norm.weight", (h,)),
             ("language_model.lm_head.weight", (cfg["vocab_size"], h))]
    return spec


def rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of one leaf's normal draw."""
    if name.endswith("embed_tokens.weight"):
        return 0.0, 1.0
    if len(shape) == 3:  # stacked experts [E, out, in]; the position table
        return 0.0, shape[-1] ** -0.5
    return weights.rule(name, shape)


def leaf(name: str, shape: Tuple[int, ...], index: int, seed: int, device,
         dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``index`` of the spec: its own generator on ``device``, a
    float32 draw scaled by :func:`rule`, rounded to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.sub_seed(seed, seeds.WEIGHTS, index))
    mean, std = rule(name, shape)
    v = torch.randn(shape, generator=gen, device=device)
    return (v.mul_(std).add_(mean)).to(dtype)


def draws(spec: Spec, seed: int, device, dtype: torch.dtype
          ) -> Iterator[Tuple[str, torch.Tensor]]:
    for i, (name, shape) in enumerate(spec):
        yield name, leaf(name, shape, i, seed, device, dtype)


@torch.no_grad()
def fill(module: torch.nn.Module, spec: Spec, seed: int) -> None:
    """Copy every leaf into ``module``'s parameter of that name; the
    names and shapes must be exactly the spec's."""
    params = dict(module.named_parameters())
    names = [n for n, _ in spec]
    missing = sorted(set(names) - set(params))
    extra = sorted(set(params) - set(names))
    if missing or extra:
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's: not in the program {missing[:5]}, "
                         f"not in the benchmark {extra[:5]}")
    for name, value in draws(spec, seed, next(iter(params.values())).device,
                             next(iter(params.values())).dtype):
        p = params[name]
        if tuple(p.shape) != tuple(value.shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                             f"{tuple(value.shape)}")
        p.copy_(value)
        del value


class LazyValues(Mapping):
    """name → the leaf in ``dtype``, drawn when read (and not kept): the
    same values :func:`fill` gave the program."""

    def __init__(self, spec: Spec, seed: int, device, dtype: torch.dtype):
        self.index: Dict[str, Tuple[int, Tuple[int, ...]]] = {
            name: (i, shape) for i, (name, shape) in enumerate(spec)}
        self.seed, self.device, self.dtype = seed, device, dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        i, shape = self.index[name]
        return leaf(name, shape, i, self.seed, self.device, self.dtype)

    def __iter__(self):
        return iter(self.index)

    def __len__(self) -> int:
        return len(self.index)

