"""The yardstick: peaks of the card, and the operations and bytes of the
work, counted from the configuration's widths.

Peaks are NVIDIA's data sheet for the H100 SXM (dense): 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s
of HBM. They assume the card's full 700 W; a run prints the card's power
limit beside its numbers.

Operations count 2 per multiply-add of every matrix product, convolution
(depthwise included) and attention product (Q·Kᵀ and P·V over the keys
each query may see). Norms, activations, softmax and the optimizer are
not counted: they are a few operations an element next to products of
hundreds. Model work counts what the request needs: a caption's encoder
over its frames and the decoder over the tokens it decoded; padding rows
of a batch, recomputation and the backward's own products are not
counted beyond the convention of three forward passes for a
forward-and-backward.
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "int8": 1979e12, "float8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------- TinyViT

def tinyvit_stage_flops(enc: dict, stage: int) -> float:
    """FLOPs of one image through stage ``stage`` (its downsample, if it
    has one, and its blocks); stage 0 includes the patch embedding."""
    size = enc["input_size"]
    dims, depths = enc["embed_dims"], enc["depths"]
    hw = size // 4 // (2 ** stage)
    c = dims[stage]
    t = hw * hw
    macs = 0.0
    if stage == 0:
        half = size // 2
        macs += half * half * (c // 2) * 3 * 9          # stem conv1
        macs += t * c * (c // 2) * 9                    # stem conv2
        hid = int(c * enc["mbconv_expand_ratio"])
        macs += depths[0] * t * (c * hid + hid * 9 + hid * c)
        return 2.0 * macs
    cin = dims[stage - 1]
    t_in = (2 * hw) ** 2
    macs += t_in * cin * c + t * c * 9 + t * c * c      # PatchMerging
    win = min(enc["window_sizes"][stage], hw)
    padded = -(-hw // win) * win
    n = win * win
    t_pad = padded * padded
    ffn = int(c * enc["mlp_ratio"])
    per_block = (t_pad * c * 3 * c          # qkv over the padded windows
                 + 2 * t_pad * n * c        # Q·Kᵀ and P·V in each window
                 + t_pad * c * c            # proj
                 + t * c * 9                # local depthwise conv
                 + 2 * t * c * ffn)         # MLP
    macs += depths[stage] * per_block
    return 2.0 * macs


def tinyvit_image_flops(enc: dict) -> float:
    return sum(tinyvit_stage_flops(enc, s) for s in range(4))


# ---------------------------------------------------------------- decoder

def decoder_memory_flops(dec: dict, frames: int) -> float:
    """Keys and values of the ``frames`` memory tokens, every layer, once
    a caption."""
    d = dec["d_model"]
    return dec["num_decoder_layers"] * 2.0 * 2 * frames * d * d


def decoder_token_flops(dec: dict, frames: int, position: int) -> float:
    """One decoded token at ``position`` (0 = the CLS input), attending to
    the ``position + 1`` tokens so far and the ``frames`` memory tokens,
    and the vocabulary projection."""
    d, ffn = dec["d_model"], dec["d_ffn"]
    per_layer = (4 * d * d                  # self q, k, v, out
                 + 2 * (position + 1) * d   # self Q·Kᵀ, P·V
                 + 2 * d * d                # cross q, out
                 + 2 * frames * d           # cross Q·Kᵀ, P·V
                 + 2 * d * ffn)             # FFN
    return 2.0 * (dec["num_decoder_layers"] * per_layer
                  + d * dec["vocab_size"])


def caption_flops(cfg: dict, tokens: int) -> float:
    """One window: the encoder over its frames, the memory's keys and
    values, and ``tokens`` decode steps."""
    f, dec = cfg["num_frames"], cfg["decoder"]
    return (f * tinyvit_image_flops(cfg["encoder"])
            + decoder_memory_flops(dec, f)
            + sum(decoder_token_flops(dec, f, i) for i in range(tokens)))


def student_forward_flops(cfg: dict, batch: int, length: int) -> float:
    """The train step's student forward: the encoder over ``batch``
    windows and the teacher-forced decoder over ``length`` tokens (causal
    self-attention)."""
    f, dec = cfg["num_frames"], cfg["decoder"]
    d, ffn = dec["d_model"], dec["d_ffn"]
    pairs = length * (length + 1) // 2
    per_layer = (length * (4 * d * d + 2 * d * d + 2 * d * ffn)
                 + 2 * pairs * d + 2 * length * f * d
                 + 2 * f * d * d)
    dec_macs = dec["num_decoder_layers"] * per_layer + (
        length * d * dec["vocab_size"])
    return batch * (f * tinyvit_image_flops(cfg["encoder"])
                    + 2.0 * dec_macs)


# ---------------------------------------------------------------- teacher

def clip_image_flops(clip: dict) -> float:
    w, p = clip["width"], clip["patch_size"]
    grid = clip["image_size"] // p
    length = grid * grid + 1
    macs = grid * grid * w * 3 * p * p
    macs += clip["layers"] * (length * w * 3 * w + 2 * length * length * w
                              + length * w * w + 2 * length * w * 4 * w)
    return 2.0 * macs


def prefix_causal_pairs(length: int, prefix: int) -> int:
    """(row, key) pairs a head takes: rows see every prefix key and the
    keys up to themselves."""
    return sum(max(prefix, r + 1) for r in range(length))


def teacher_forward_flops(cfg: dict, batch: int, text_len: int) -> float:
    t = cfg["teacher"]
    clip = t["clip"]
    grid = clip["image_size"] // clip["patch_size"]
    frames = t["num_image_with_embedding"]
    prefix = frames * (grid * grid + 1)
    length = prefix + text_len
    h, ffn = t["hidden_size"], t["feedforward_size"]
    macs = prefix * t["visual_feature_size"] * h
    macs += t["num_layers"] * (length * (3 * h * h + h * h + 2 * h * ffn)
                               + 2 * prefix_causal_pairs(length, prefix) * h)
    macs += text_len * h * t["vocab_size"]
    return batch * (frames * clip_image_flops(clip) + 2.0 * macs)


def train_step_flops(cfg: dict) -> float:
    """Teacher forward plus three student forwards (forward and
    backward), for one step of ``cfg["train"]``."""
    tr = cfg["train"]
    b, length = tr["batch_size"], tr["caption_len"]
    return (teacher_forward_flops(cfg, b, length)
            + 3.0 * student_forward_flops(cfg["student"], b, length))


# ------------------------------------------------------- kernels' bounds

def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16"
            ) -> Tuple[float, str]:
    """The least time of a launch: the larger of its bytes over HBM and
    its operations over the peak, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_work(b: int, h: int, n: int, d: int, elem: int = 2,
                bias_elem: int = 4) -> Tuple[float, float]:
    """K1 on q, k, v ``[b, h, n, d]`` and a bias ``[h, n, n]``: q, k, v and
    the bias read, O written; 4·d per (row, key). (bytes, operations)."""
    qkv = b * h * n * d * elem
    return 4 * qkv + h * n * n * bias_elem, 4.0 * b * h * n * n * d


def flash_work(b: int, h: int, length: int, d: int, prefix: int,
               elem: int = 2) -> Tuple[float, float]:
    """K4 prefix-causal self-attention on q, k, v ``[b, h, length, d]``:
    q, k, v read, O written; two products of 2·d per allowed pair."""
    pairs = b * prefix_causal_pairs(length, prefix)
    return 4 * b * h * length * d * elem, 4.0 * d * h * pairs
