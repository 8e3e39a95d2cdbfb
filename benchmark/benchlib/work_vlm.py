"""Operations and bytes of the vision-language captioner (Kimi-VL-A3B),
counted from the configuration's widths, with :mod:`benchlib.work`'s
conventions: 2 operations per multiply-add of every matrix product and
attention product; norms, activations, softmax, RoPE and the router's
top-k not counted.

A clip (:func:`clip_flops`) is MoonViT over its frames (the patch
convolution, each block's products with attention over the frame's
patches, the projector over the merged tokens), the prefill over the
prompt and the visual tokens (MLA's projections, causal attention at half
the square, the dense MLP or the router, the chosen experts and the
shared experts a token; the head at the last position alone), and one
decode token (:func:`decode_token_flops`) for each further token, each at
the cache length it attends.

The kernels' bounds: :func:`grouped_mm_work` for one grouped expert
product from its operands' shapes; :func:`mla_decode_work` for one
layer's absorbed attention at one position, every byte it reads once.
"""

from __future__ import annotations

from typing import Tuple

BF16 = 2


def vision_tokens(cfg: dict) -> Tuple[int, int]:
    """(patches, merged tokens) of one frame."""
    v = cfg["vision"]
    grid = v["image_size"] // v["patch_size"]
    return grid * grid, grid * grid // (v["merge"] ** 2)


def moonvit_block_flops(cfg: dict) -> float:
    """One MoonViT block over one frame: qkv, Q·Kᵀ and P·V over the
    frame's patches, the output projection, the MLP."""
    v = cfg["vision"]
    n, _ = vision_tokens(cfg)
    w = v["width"]
    macs = n * w * 3 * w + 2 * n * n * w + n * w * w + 2 * n * w * v["mlp"]
    return 2.0 * macs


def frame_flops(cfg: dict) -> float:
    """One frame through MoonViT and the projector."""
    v = cfg["vision"]
    n, t = vision_tokens(cfg)
    w, m2 = v["width"], v["merge"] ** 2
    macs = n * w * 3 * v["patch_size"] ** 2                   # patch conv
    macs += t * (m2 * w * m2 * w + m2 * w * cfg["hidden_size"])  # projector
    return 2.0 * macs + v["layers"] * moonvit_block_flops(cfg)


def _attn_proj_macs(cfg: dict) -> float:
    """MLA's projections for one token: q, [c, k_pe], kv_b, o."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    rank = cfg["kv_lora_rank"]
    return (h * heads * qk + h * (rank + cfg["qk_rope_head_dim"])
            + rank * heads * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"])
            + heads * cfg["v_head_dim"] * h)


def _mlp_macs(cfg: dict, layer: int) -> float:
    """The MLP of one token: dense SwiGLU, or the router, the chosen
    experts and the shared experts."""
    h = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        return 3 * h * cfg["intermediate_size"]
    e = cfg["moe_intermediate_size"]
    return (h * cfg["n_routed_experts"]
            + cfg["num_experts_per_tok"] * 3 * h * e
            + 3 * h * e * cfg["n_shared_experts"])


def moe_layer_flops(cfg: dict, tokens: int) -> float:
    """One MoE layer's MLP over ``tokens`` tokens."""
    return 2.0 * tokens * _mlp_macs(cfg, cfg["first_k_dense_replace"])


def prefill_flops(cfg: dict, length: int) -> float:
    """The language model over ``length`` positions, causal, with the
    head at the last."""
    heads = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    pairs = length * (length + 1) // 2
    macs = 0.0
    for layer in range(cfg["num_hidden_layers"]):
        macs += length * (_attn_proj_macs(cfg) + _mlp_macs(cfg, layer))
        macs += pairs * heads * (qk + cfg["v_head_dim"])
    macs += cfg["hidden_size"] * cfg["vocab_size"]
    return 2.0 * macs


def decode_token_flops(cfg: dict, seen: int) -> float:
    """One decode token attending ``seen`` cache positions (itself
    included), in the absorbed form, and the head."""
    heads, rank = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    lat = rank + cfg["qk_rope_head_dim"]
    absorbed = heads * (cfg["qk_nope_head_dim"] * rank
                        + seen * (lat + rank) + rank * cfg["v_head_dim"])
    macs = 0.0
    for layer in range(cfg["num_hidden_layers"]):
        macs += (_attn_proj_macs(cfg) - rank * heads
                 * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"])
                 + absorbed + _mlp_macs(cfg, layer))
    macs += cfg["hidden_size"] * cfg["vocab_size"]
    return 2.0 * macs


def prompt_length(cfg: dict) -> int:
    return cfg["num_frames"] * vision_tokens(cfg)[1] + cfg["prompt"]["length"]


def clip_flops(cfg: dict, tokens: int) -> float:
    """One clip captioned to ``tokens`` generated tokens (the first from
    the prefill's head)."""
    length = prompt_length(cfg)
    return (cfg["num_frames"] * frame_flops(cfg) + prefill_flops(cfg, length)
            + sum(decode_token_flops(cfg, length + i + 1)
                  for i in range(tokens - 1)))


def grouped_mm_work(a_dims, b_dims, elem: int = BF16) -> Tuple[float, float]:
    """One grouped product of ``a [M, K]`` by ``b [E, K, N]``: a and every
    expert's matrix read, ``[M, N]`` written. (bytes, operations)."""
    m, k = a_dims
    e, _, n = b_dims
    return elem * (m * k + e * k * n + m * n), 2.0 * m * k * n


def mla_decode_work(cfg: dict, batch: int, seen: int,
                    elem: int = BF16) -> Tuple[float, float]:
    """One layer's absorbed attention for ``batch`` rows at one position
    over ``seen`` cache rows: the projections' weights, the latent cache
    ``[batch, seen, rank + rope]``, the rows in and out read or written
    once. (bytes, operations)."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    rank = cfg["kv_lora_rank"]
    lat = rank + cfg["qk_rope_head_dim"]
    weights = _attn_proj_macs(cfg)  # one element a weight
    nbytes = elem * (weights + batch * seen * lat + 2 * batch * h)
    flops = 2.0 * batch * (
        _attn_proj_macs(cfg) - rank * heads * (cfg["qk_nope_head_dim"]
                                               + cfg["v_head_dim"])
        + heads * (cfg["qk_nope_head_dim"] * rank + seen * (lat + rank)
                   + rank * cfg["v_head_dim"]))
    return nbytes, flops
