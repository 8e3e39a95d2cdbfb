"""Multi-head attention: the plain path and kernels K1, K4, K5 and K8
(K4n and K8n in the input-dtype softmax).

Counterpart of ``rtvc_tpu/ops/attention.py``:

- :func:`attention_plain` is ``xla_attention`` (masks, learned bias, f32 or
  input-dtype softmax, dropout on the probabilities) in plain PyTorch ops,
  as JAX runs it in XLA: the student decoder's short self- and
  cross-attention;
- :func:`window_attention` is ``window_attention`` (the Pallas kernel
  ``_window_attention_fwd_pallas`` and its closed-form backward
  ``_window_attention_bwd``) as the CUDA kernel ``csrc/window_attention.cu``
  (bfloat16 on the tensor cores, ``csrc/window_attention_sm90.cu``) and
  :func:`window_attention_bwd_plain`, with :func:`window_attention_plain`
  beside it: TinyViT's window attention with its relative-position bias;
- :func:`flash_attention` is ``flash_attention`` (the Pallas kernels
  ``_pallas_attention`` and ``_pallas_attention_bwd`` under one
  ``custom_vjp``) as K4 and K8 in ``csrc/flash_attention.cu`` (for
  bfloat16 on the tensor cores, ``csrc/flash_attention_sm90.cu`` and
  ``csrc/flash_attention_bwd_sm90.cu``), with
  :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`
  beside them: the GIT teacher's joint prefix-causal attention, with the
  TPU kernel's in-kernel dropout (:func:`dropout_bits`, a counter hash of
  the global (seed, batch, head, row, column), so that the backward
  regenerates the forward's mask bit for bit), and its input-dtype softmax
  (``softmax_native``: bfloat16 scores, max and exponentials, a float32
  normaliser; the module switch ``SOFTMAX_NATIVE_PALLAS``, set by
  :func:`set_softmax_native_pallas`, picks it where the caller leaves it
  open), which bfloat16 inputs run on their own kernels, K4n and K8n;
- :func:`blhd_attention` is ``blhd_attention`` as K5 (the same sources,
  its own entry point), with :func:`blhd_attention_plain`: the CLIP tower's
  attention read in place from the QKV GEMM's ``[B, L, H, D]`` view;
- :func:`multi_head_attention` routes as JAX does: bias-carrying, unmasked
  window attention without dropout to K1, bias-free attention over at
  least ``PALLAS_MIN_KV_LEN`` keys to K4, everything else (and everything
  when ``use_pallas=False``) to the plain path.

K1 and K4 are ``torch.autograd.Function``s: their forward takes the plain
version for CPU tensors and the kernel for CUDA tensors, and their backward
is one code path for both (K1's in PyTorch ops, as JAX writes it in XLA;
K4's through :func:`flash_attention_bwd`, which launches K8 on a card). K5
has no backward, as in JAX, and raises on CUDA inputs that require grad.

Layout as in JAX: q/k/v ``[B, H, L, D]``, except for the BLHD functions.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernel
from .dropout import draw_seed, uniform

NEG_INF = -1e30


def _mask_bias(lq: int, lkv: int, causal: bool, prefix_len: int,
               kv_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """Additive float32 bias ``[*, lq, lkv]``; ``kv_mask`` [B, lkv] bool,
    True = attend."""
    bias = torch.zeros((1, 1, lq, lkv), dtype=torch.float32, device=device)
    if causal:
        q_idx = torch.arange(lq, device=device)[:, None]
        k_idx = torch.arange(lkv, device=device)[None, :]
        allowed = (k_idx < prefix_len) | (k_idx <= q_idx)
        bias = bias.masked_fill(~allowed, NEG_INF)
    if kv_mask is not None:
        bias = bias + torch.where(kv_mask[:, None, None, :], 0.0, NEG_INF)
    return bias


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, prefix_len: int = 0,
                    kv_mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    softmax_in_input_dtype: bool = False) -> torch.Tensor:
    """``xla_attention``: scores and softmax in float32, or in ``q.dtype``
    with ``softmax_in_input_dtype``; with ``dropout_rate`` > 0 each
    probability is kept where a uniform draw from ``generator`` is below
    ``1 - rate`` and divided by ``1 - rate``; probabilities cast to
    ``v.dtype`` before the P.V product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc_t = q.dtype if softmax_in_input_dtype else torch.float32
    scores = torch.matmul(q.to(acc_t), k.to(acc_t).transpose(-1, -2)) * scale
    if causal or kv_mask is not None:
        scores = scores + _mask_bias(q.shape[2], k.shape[2], causal,
                                     prefix_len, kv_mask, q.device).to(acc_t)
    if bias is not None:
        scores = scores + bias.to(acc_t)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        keep = uniform(probs.shape, generator, probs.device) < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            probs.new_zeros(()))
    return torch.matmul(probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# K1: window attention with the learned bias
# ---------------------------------------------------------------------------

def window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor, *,
                           scale: Optional[float] = None,
                           softmax_in_input_dtype: bool = False
                           ) -> torch.Tensor:
    """K1's arithmetic in PyTorch ops: float32 score products; with
    ``softmax_in_input_dtype`` the scaled score, the bias and their sum are
    rounded to the input dtype; float32 softmax; probabilities rounded to
    ``v.dtype``; float32 P.V; output in the input dtype.

    The softmax stays float32 in both modes, here and in the card's K1. The
    TPU kernel takes max, exp, sum and divide in the input dtype (bf16)
    under ``softmax_in_input_dtype`` (rtvc_tpu/ops/attention.py:754-757);
    float32 is the more exact of the two, and how the TPU rounds that bf16
    arithmetic under ``--xla_allow_excess_precision`` is uncertain
    (:739-748). Against the JAX kernel in interpret mode the choice costs
    6.2e-3 of max|out| at N = 196 (4.6e-3 at N = 49), 80% of the 2^-7 the
    bf16 K1 is held to (``test_k1_plain_stays_inside_the_card_limit_of_jax``
    in tests/test_torch_ops.py)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softmax_in_input_dtype:
        s = s.to(q.dtype) + bias.to(q.dtype)
    else:
        s = s + bias.float()
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the dtype JAX's einsum promotes the two to."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(t), b.to(t))


def window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               g: torch.Tensor, *, scale: float,
                               softmax_in_input_dtype: bool = False):
    """(dq, dk, dv, dbias): ``_window_attention_bwd`` in PyTorch ops. The
    probabilities are recomputed (the forward keeps no score tensor), the
    score and softmax math in float32 or, with ``softmax_in_input_dtype``,
    in the input dtype; dbias sums dS over the windows in float32."""
    acc_t = q.dtype if softmax_in_input_dtype else torch.float32
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.to(acc_t) + bias[None].to(acc_t)
    p = torch.softmax(s, dim=-1)
    dv = _mm(p.to(v.dtype).transpose(-1, -2), g)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2)).to(acc_t)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_scaled = ds * scale
    dq = _mm(ds_scaled, k).to(q.dtype)
    dk = _mm(ds_scaled.transpose(-1, -2), q).to(k.dtype)
    dbias = ds.float().sum(dim=0).to(bias.dtype)
    return dq, dk, dv.to(v.dtype), dbias


def _window_forward(q, k, v, bias, scale: float, native: bool):
    """The plain version for CPU tensors, K1 for CUDA tensors."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale=scale,
                                      softmax_in_input_dtype=native)
    name = "window_attention"
    b, h, n, d = q.shape
    _kernel.require_cuda(name, q, k, v, bias)
    _kernel.require(name, q.shape == k.shape == v.shape,
                    "q, k and v must share a shape")
    _kernel.require(name, q.dtype == k.dtype == v.dtype,
                    "q, k and v must share a dtype")
    _kernel.require(name, bias.dtype == torch.float32,
                    "bias must be float32")
    _kernel.require(name, n <= 256 and d <= 64,
                    f"takes N <= 256 and D <= 64, got N={n}, D={d}")
    code = _kernel.dtype_code(name, q)
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel copies 16-byte pieces of 64-byte rows
        _kernel.require(name, d == 32, f"bfloat16 takes D = 32, got {d}")
        _kernel.require(name, all(t.data_ptr() % 16 == 0
                                  for t in (q, k, v, out)),
                        "bfloat16 q, k, v must start 16-byte aligned")
    if b:
        _kernel.launch("rtvc_window_attention", q, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), b, h, n, d, float(scale),
                       int(native), code)
        window_attention.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, native):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.native = scale, native
        return _window_forward(q, k, v, bias, scale, native)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        grads = window_attention_bwd_plain(
            q, k, v, bias, g, scale=ctx.scale,
            softmax_in_input_dtype=ctx.native)
        return (*grads, None, None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, *, scale: Optional[float] = None,
                     softmax_in_input_dtype: bool = False) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias[h]) v per window. q/k/v ``[B·nW, H, N, D]``,
    bias ``[H, N, N]`` float32. CPU tensors take
    :func:`window_attention_plain`; CUDA tensors launch K1 (contiguous,
    float32 with D ≤ 64, or bfloat16 with D = 32 on the tensor cores;
    N ≤ 256) or raise. Differentiable in q,
    k, v and bias (:func:`window_attention_bwd_plain`)."""
    b, h, n, d = q.shape
    _kernel.require("window_attention", bias.shape == (h, n, n),
                    f"bias must be [{h}, {n}, {n}], got {tuple(bias.shape)}")
    if scale is None:
        scale = d ** -0.5
    return _WindowAttention.apply(q, k, v, bias, float(scale),
                                  bool(softmax_in_input_dtype))


window_attention.launches = 0

# bias-free attention over at least this many keys goes to K4 (JAX's
# PALLAS_MIN_KV_LEN): the teacher's 1542- and 1582-key contexts
PALLAS_MIN_KV_LEN = 512


# ---------------------------------------------------------------------------
# K4 / K8: flash attention with in-kernel dropout, forward and backward
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x · c mod 2^32`` for x in [0, 2^32) held in int64, in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_bits(seed: int, b: int, h: int, lq: int, lkv: int,
                 device=None) -> torch.Tensor:
    """``_dropout_bits`` over the whole ``[b, h, lq, lkv]`` grid: the
    uint32 murmur3-style hash of the global (seed, batch, head, row,
    column), as int64 values in [0, 2^32). torch's uint32 has too few ops,
    so every product is reduced mod 2^32 by :func:`_mul32`."""
    i64 = dict(dtype=torch.int64, device=device)
    r = torch.arange(lq, **i64)[:, None]
    c = torch.arange(lkv, **i64)[None, :]
    bi = torch.arange(b, **i64)[:, None, None, None]
    hi = torch.arange(h, **i64)[None, :, None, None]
    x = _mul32(r, 0x9E3779B1) ^ _mul32(c, 0x85EBCA77)
    x = x ^ ((seed * 0xC2B2AE3D) & _M32)
    x = x ^ ((_mul32(bi, 0x27D4EB2F) + _mul32(hi, 0x165667B1)) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """A score is kept where its bits are >= this (JAX's ``thresh``)."""
    return int(rate * (2 ** 32))


def _allowed(lq: int, lkv: int, causal: bool, prefix_len: int,
             kv_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """Bool ``[B or 1, 1, lq, lkv]``: the keys each query may attend."""
    allowed = torch.ones((1, 1, lq, lkv), dtype=torch.bool, device=device)
    if causal:
        q_idx = torch.arange(lq, device=device)[:, None]
        k_idx = torch.arange(lkv, device=device)[None, :]
        allowed = allowed & ((k_idx < prefix_len) | (k_idx <= q_idx))
    if kv_mask is not None:
        allowed = allowed & kv_mask[:, None, None, :].bool()
    return allowed


def _flash_probs(q, k, causal, prefix_len, kv_mask, scale, dropout_rate,
                 seed, native: bool = False):
    """(P, drop(P)) as ``_block_probs`` computes them, as float32 tensors.
    With ``native`` (``softmax_native``), in q's dtype: the float32 score
    product rounded to it, times the scale rounded to it; the row max and
    ``exp(s - max)`` in it; the normaliser summed in float32, its
    reciprocal rounded to q's dtype and multiplied in; a kept probability
    divided by ``1 - rate`` rounded to q's dtype (0.8984375 at rate 0.1 in
    bfloat16)."""
    dt = q.dtype if native else torch.float32
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).to(dt)
    s = s * torch.tensor(scale, dtype=dt) if native else s * scale
    if causal or kv_mask is not None:
        s = s.masked_fill(~_allowed(q.shape[2], k.shape[2], causal,
                                    prefix_len, kv_mask, q.device), NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    z = e.float().sum(dim=-1, keepdim=True)
    p = e * (1.0 / z).to(dt) if native else e / z
    if dropout_rate <= 0.0:
        return p.float(), p.float()
    b, h, lq, lkv = p.shape
    kept = dropout_bits(seed, b, h, lq, lkv, p.device) >= dropout_threshold(
        dropout_rate)
    keep = (torch.tensor(1.0 - dropout_rate, dtype=dt) if native
            else 1.0 - dropout_rate)
    return p.float(), torch.where(kept, p / keep, p.new_zeros(())).float()


def _native_mode(q: torch.Tensor, softmax_in_input_dtype: bool) -> bool:
    """Whether the input-dtype softmax applies: a no-op for float32 inputs,
    as JAX demotes it (``_pallas_attention``, ``_pallas_attention_bwd``)."""
    return bool(softmax_in_input_dtype) and q.dtype != torch.float32


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False, prefix_len: int = 0,
                          kv_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          seed: Optional[int] = None,
                          softmax_in_input_dtype: bool = False
                          ) -> torch.Tensor:
    """K4's arithmetic in PyTorch ops, as ``_block_probs`` computes it:
    float32 score products; disallowed scores set to -1e30 (a row with no
    allowed key averages V uniformly); float32 softmax, its normaliser over
    every key, kept or dropped; with ``dropout_rate`` > 0 a probability is
    kept where ``dropout_bits(seed, ...)`` >= ``rate · 2^32`` and divided by
    ``1 - rate``; float32 probabilities times float32 V; output in the input
    dtype. ``softmax_in_input_dtype`` takes the softmax in a bfloat16
    input's dtype (:func:`_flash_probs`), and then the probabilities enter
    the P.V product rounded to it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, p_used = _flash_probs(q, k, causal, prefix_len, kv_mask, scale,
                             dropout_rate, seed,
                             _native_mode(q, softmax_in_input_dtype))
    return torch.matmul(p_used, v.float()).to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor, *,
                              causal: bool = False, prefix_len: int = 0,
                              kv_mask: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None,
                              dropout_rate: float = 0.0,
                              seed: Optional[int] = None,
                              softmax_in_input_dtype: bool = False):
    """(dq, dk, dv): the closed form of ``_make_bwd_kernel`` in PyTorch ops,
    float32 throughout and cast to the input dtypes. P is recomputed (in
    the input dtype with ``softmax_in_input_dtype``, then upcast, as JAX
    upcasts the mode's probabilities); the kept mask is recovered as
    drop(P) > 0; dS = P∘(dP − rowsum(P∘dP)) with the row sum taken from the
    recomputed P and dP; dP of a kept probability is divided by the float32
    ``1 - rate`` in both modes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    p, p_used = _flash_probs(q, k, causal, prefix_len, kv_mask, scale,
                             dropout_rate, seed,
                             _native_mode(q, softmax_in_input_dtype))
    dv = torch.matmul(p_used.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v32.transpose(-1, -2))
    if dropout_rate > 0.0:
        dp = torch.where(p_used > 0.0, dp / (1.0 - dropout_rate),
                         dp.new_zeros(()))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(t: torch.Tensor, *dims: int) -> list:
    return [t.stride(d) for d in dims]


def _tma_strides(name: str, t: torch.Tensor, *dims: int) -> list:
    """``t``'s element strides over ``dims`` as the bfloat16 kernel's TMA
    tensor maps take them: the base 16-byte aligned and every stride a
    positive multiple of 8 elements (16 bytes), or raise. A dim of size 1
    is never stepped, so its stride is rounded up to a multiple of 8."""
    _kernel.require(name, t.data_ptr() % 16 == 0,
                    "bfloat16 q, k and v must start 16-byte aligned (TMA)")
    out = []
    for d in dims:
        st = t.stride(d)
        if t.shape[d] == 1:
            st = -(-max(st, 1) // 8) * 8
        _kernel.require(name, st > 0 and st % 8 == 0,
                        f"bfloat16 q, k and v need strides that are positive "
                        f"multiples of 8 elements (16 bytes, for TMA), got "
                        f"{tuple(t.stride())}")
        out.append(st)
    return out


def _qkv_strides(name: str, q, k, v, dims) -> list:
    """The strides the kernels take for q, k, v over ``dims``: checked and
    normalised for TMA in bfloat16, as they are in float32."""
    if q.dtype == torch.bfloat16:
        return [s for t in (q, k, v) for s in _tma_strides(name, t, *dims)]
    return [s for t in (q, k, v) for s in _strides(t, *dims)]


def _dropout_args(dropout_rate: float, seed: Optional[int]) -> list:
    """(seed, threshold, 1 - rate, on) as the kernels take them."""
    if dropout_rate <= 0.0:
        return [0, 0, 1.0, 0]
    return [int(seed), dropout_threshold(dropout_rate),
            float(1.0 - dropout_rate), 1]


def _flash_checks(name, q, k, v, kv_mask, *more):
    """Check what K4 and K8 take; returns the key mask as contiguous
    ``[B, Lkv]`` bytes on q's device, or None."""
    b, h, _, d = q.shape
    lkv = k.shape[2]
    _kernel.require(name, k.shape == v.shape == (b, h, lkv, d),
                    "k and v must be [B, H, Lkv, D] of q's B, H and D")
    _kernel.require(name, q.dtype == k.dtype == v.dtype,
                    "q, k and v must share a dtype")
    _kernel.require(name, d <= 64 and lkv >= 1,
                    f"takes D <= 64 and Lkv >= 1, got D={d}, Lkv={lkv}")
    for t in (q, k, v) + more:
        _kernel.require(name, t.is_cuda and t.device == q.device
                        and t.stride(3) == 1,
                        f"tensors must lie on {q.device} with D contiguous")
    if kv_mask is None:
        return None
    _kernel.require(name, kv_mask.shape in ((b, lkv), (1, lkv)),
                    f"kv_mask must be [{b} or 1, {lkv}]")
    return kv_mask.to(q.device, torch.bool).expand(b, lkv).contiguous()


def _flash_forward(q, k, v, kv_mask, causal: bool, prefix_len: int,
                   scale: float, dropout_rate: float, seed: Optional[int],
                   native: bool):
    """The plain version for CPU tensors, K4 (K4n with ``native``) for CUDA
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     prefix_len=prefix_len, kv_mask=kv_mask,
                                     scale=scale, dropout_rate=dropout_rate,
                                     seed=seed, softmax_in_input_dtype=native)
    name = "flash_attention"
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    mask = _flash_checks(name, q, k, v, kv_mask)
    code = _kernel.dtype_code(name, q)
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    if b and lq:
        _kernel.launch("rtvc_flash_attention", q, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(),
                       0 if mask is None else mask.data_ptr(), b, h, lq, lkv,
                       d, *_qkv_strides(name, q, k, v, (0, 1, 2)),
                       *_strides(out, 0, 1, 2), float(scale), int(causal),
                       int(prefix_len), *_dropout_args(dropout_rate, seed),
                       int(native), code)
        if native:
            flash_attention.native_launches += 1
        else:
            flash_attention.launches += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, *, causal: bool = False,
                        prefix_len: int = 0,
                        kv_mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        dropout_rate: float = 0.0,
                        seed: Optional[int] = None,
                        softmax_in_input_dtype: bool = False):
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``g [B, H, Lq, D]``, in the input dtype. CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch K8 (float32 on
    the CUDA cores, or bfloat16 on the tensor cores with 16-byte aligned
    strides for TMA; D ≤ 64, D contiguous), or K8n for bfloat16 with
    ``softmax_in_input_dtype``, or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    native = _native_mode(q, softmax_in_input_dtype)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, g, causal=causal, prefix_len=prefix_len,
            kv_mask=kv_mask, scale=scale, dropout_rate=dropout_rate,
            seed=seed, softmax_in_input_dtype=native)
    name = "flash_attention_bwd"
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    _kernel.require(name, g.shape == q.shape and g.dtype == q.dtype,
                    "g must be q's shape and dtype")
    mask = _flash_checks(name, q, k, v, kv_mask, g)
    code = _kernel.dtype_code(name, q)
    dq, dk, dv = (torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
                  for n in (lq, lkv, lkv))
    # per query row: max, softmax normaliser and rowsum(P∘dP), float32,
    # for every row of the 64-row tiles (the bfloat16 kernels' layout)
    stats = torch.empty(3 * b * h * -(-lq // 64) * 64, dtype=torch.float32,
                        device=q.device)
    if q.dtype == torch.bfloat16:
        strides = [s for t in (q, k, v, g)
                   for s in _tma_strides(name, t, 0, 1, 2)]
    else:
        strides = [s for t in (q, k, v, g) for s in _strides(t, 0, 1, 2)]
    if b and lq:
        _kernel.launch("rtvc_flash_attention_bwd", q, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), g.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       stats.data_ptr(),
                       0 if mask is None else mask.data_ptr(), b, h, lq, lkv,
                       d, *strides, float(scale), int(causal), int(prefix_len),
                       *_dropout_args(dropout_rate, seed), int(native), code)
        if native:
            flash_attention_bwd.native_launches += 1
        else:
            flash_attention_bwd.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.native_launches = 0


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, prefix_len, scale,
                dropout_rate, seed, native):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.args = dict(causal=causal, prefix_len=prefix_len, scale=scale,
                        dropout_rate=dropout_rate, seed=seed,
                        softmax_in_input_dtype=native)
        return _flash_forward(q, k, v, kv_mask, causal, prefix_len, scale,
                              dropout_rate, seed, native)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        grads = flash_attention_bwd(q, k, v, g, kv_mask=kv_mask, **ctx.args)
        return (*grads,) + (None,) * 7


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, prefix_len: int = 0,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    seed: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    softmax_in_input_dtype: Optional[bool] = None
                    ) -> torch.Tensor:
    """Fused attention over q ``[B, H, Lq, D]``, k/v ``[B, H, Lkv, D]``
    (any strides with D contiguous, e.g. head views of a packed QKV
    product), ``kv_mask`` ``[B or 1, Lkv]`` bool (True = attend). Returns a
    contiguous ``[B, H, Lq, D]``. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch K4 (float32 on the
    CUDA cores, or bfloat16 on the tensor cores with 16-byte aligned
    strides for TMA; D ≤ 64) or raise. Differentiable in q, k and v
    (:func:`flash_attention_bwd`, K8 on a card).

    ``dropout_rate`` > 0 drops probabilities inside the kernel by
    :func:`dropout_bits` of ``seed``, an int in [0, 2^31 - 1), or of one
    drawn from the CPU ``generator``; the backward regenerates the same
    mask. ``softmax_in_input_dtype`` (``SOFTMAX_NATIVE_PALLAS`` where None)
    takes the softmax in a bfloat16 input's dtype, on K4n and K8n; float32
    inputs ignore it."""
    if softmax_in_input_dtype is None:
        softmax_in_input_dtype = SOFTMAX_NATIVE_PALLAS
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if dropout_rate > 0.0:
        if seed is None:
            if generator is None:
                raise ValueError("dropout_rate > 0 requires a seed or a "
                                 "generator")
            seed = draw_seed(generator)
    else:
        seed = None
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal),
                                 int(prefix_len), float(scale),
                                 float(dropout_rate), seed,
                                 _native_mode(q, softmax_in_input_dtype))


flash_attention.launches = 0
flash_attention.native_launches = 0

# The input-dtype softmax in the flash kernels where a caller leaves
# ``softmax_in_input_dtype`` open (JAX's switch of the same name; off by
# default, as there). No-op for float32 inputs.
SOFTMAX_NATIVE_PALLAS = False


def set_softmax_native_pallas(value: bool) -> None:
    """Flip the flash kernels' softmax dtype for the callers that leave it
    open (JAX's ``set_softmax_native_pallas``)."""
    global SOFTMAX_NATIVE_PALLAS
    SOFTMAX_NATIVE_PALLAS = bool(value)


# ---------------------------------------------------------------------------
# K5: BLHD attention (inference only)
# ---------------------------------------------------------------------------

def blhd_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None) -> torch.Tensor:
    """K5's arithmetic (K4's with no mask) on ``[B, L, H, D]``; returns a
    contiguous ``[B, L, H, D]``."""
    heads = (t.transpose(1, 2) for t in (q, k, v))
    return flash_attention_plain(*heads, scale=scale).transpose(
        1, 2).contiguous()


def blhd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Bidirectional, maskless attention read straight from ``[B, L, H, D]``
    (any strides with D contiguous: the q/k/v column blocks of the QKV
    product need no copy). Returns a contiguous ``[B, L, H, D]``. CPU
    tensors take :func:`blhd_attention_plain`; CUDA tensors launch K5
    (float32, or bfloat16 with 16-byte aligned strides; D ≤ 64, nothing
    requiring grad) or raise."""
    name = "blhd_attention"
    b, l, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return blhd_attention_plain(q, k, v, scale=scale)
    _kernel.require_no_grad(name, q, k, v)
    _kernel.require(name, q.shape == k.shape == v.shape,
                    "q, k and v must share a shape")
    _kernel.require(name, q.dtype == k.dtype == v.dtype,
                    "q, k and v must share a dtype")
    _kernel.require(name, d <= 64, f"takes D <= 64, got {d}")
    for t in (q, k, v):
        _kernel.require(name, t.is_cuda and t.device == q.device
                        and t.stride(3) == 1,
                        f"q, k and v must lie on {q.device} with D contiguous")
    code = _kernel.dtype_code(name, q)
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    if b and l:
        _kernel.launch("rtvc_blhd_attention", q, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), b, l, h, d,
                       *_qkv_strides(name, q, k, v, (0, 1, 2)), float(scale),
                       code)
        blhd_attention.launches += 1
    return out


blhd_attention.launches = 0


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False, prefix_len: int = 0,
                         kv_mask: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         use_pallas: Optional[bool] = None,
                         softmax_in_input_dtype: bool = False
                         ) -> torch.Tensor:
    """JAX's routing: unmasked self-attention with an ``[H, N, N]`` (or
    ``[1, H, N, N]``) bias and no dropout goes to :func:`window_attention`;
    bias-free attention over at least ``PALLAS_MIN_KV_LEN`` keys (or any,
    with ``use_pallas=True``) to :func:`flash_attention`; the rest, and all
    of it with ``use_pallas=False``, to :func:`attention_plain`. Dropout
    applies where ``dropout_rate`` > 0 and a CPU ``generator`` is given, as
    JAX applies it where a ``dropout_rng`` is."""
    heads, lq, lkv = q.shape[1], q.shape[2], k.shape[2]
    rate = dropout_rate if dropout_rate > 0.0 and generator is not None \
        else 0.0
    if (bias is not None and use_pallas is not False and rate == 0.0
            and not causal and kv_mask is None
            and q.shape == k.shape == v.shape
            and tuple(bias.shape) in ((1, heads, lq, lkv), (heads, lq, lkv))):
        return window_attention(
            q, k, v, bias[0] if bias.dim() == 4 else bias, scale=scale,
            softmax_in_input_dtype=softmax_in_input_dtype)
    if use_pallas is None:
        use_pallas = bias is None and lkv >= PALLAS_MIN_KV_LEN
    if use_pallas:
        return flash_attention(
            q, k, v, causal=causal, prefix_len=prefix_len, kv_mask=kv_mask,
            scale=scale, dropout_rate=rate, generator=generator,
            softmax_in_input_dtype=softmax_in_input_dtype or None)
    return attention_plain(q, k, v, causal=causal, prefix_len=prefix_len,
                           kv_mask=kv_mask, bias=bias, scale=scale,
                           dropout_rate=rate, generator=generator,
                           softmax_in_input_dtype=softmax_in_input_dtype)
