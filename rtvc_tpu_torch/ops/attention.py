"""Multi-head attention: the plain path and kernels K1, K4 and K5.

Counterpart of ``rtvc_tpu/ops/attention.py``:

- :func:`attention_plain` is ``xla_attention`` (masks, learned bias, f32 or
  input-dtype softmax) in plain PyTorch ops, as JAX runs it in XLA: the
  student decoder's short self- and cross-attention;
- :func:`window_attention` is ``window_attention`` (the Pallas kernel
  ``_window_attention_fwd_pallas``) as the CUDA kernel
  ``csrc/window_attention.cu``, with :func:`window_attention_plain` beside
  it: TinyViT's window attention with its relative-position bias;
- :func:`flash_attention` is ``flash_attention`` (the Pallas kernel
  ``_pallas_attention``, forward, no dropout) as the CUDA kernel K4 in
  ``csrc/flash_attention.cu``, with :func:`flash_attention_plain` beside
  it: the GIT teacher's joint prefix-causal attention;
- :func:`blhd_attention` is ``blhd_attention`` as K5 (the same source, its
  own entry point), with :func:`blhd_attention_plain`: the CLIP tower's
  attention read in place from the QKV GEMM's ``[B, L, H, D]`` view;
- :func:`multi_head_attention` routes as JAX does: bias-carrying, unmasked
  window attention to K1, bias-free attention over at least
  ``PALLAS_MIN_KV_LEN`` keys to K4, everything else (and everything when
  ``use_pallas=False``) to the plain path.

Layout as in JAX: q/k/v ``[B, H, L, D]``, except for the BLHD functions.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernel

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
                    softmax_in_input_dtype: bool = False) -> torch.Tensor:
    """``xla_attention`` without dropout: scores and softmax in float32, or
    in ``q.dtype`` with ``softmax_in_input_dtype``; probabilities cast to
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
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor, *,
                           scale: Optional[float] = None,
                           softmax_in_input_dtype: bool = False
                           ) -> torch.Tensor:
    """K1's arithmetic in PyTorch ops: float32 score products; with
    ``softmax_in_input_dtype`` the scaled score, the bias and their sum are
    rounded to the input dtype; float32 softmax; probabilities rounded to
    ``v.dtype``; float32 P.V; output in the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softmax_in_input_dtype:
        s = s.to(q.dtype) + bias.to(q.dtype)
    else:
        s = s + bias.float()
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _grid(b: int, h: int, n: int, device) -> tuple:
    """(windows per block, query rows per block): query chunks of at most
    64 rows, then windows grouped so that about 16 blocks land on each SM."""
    chunks = -(-n // 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, (b * h * chunks) // (16 * sms)), -(-n // chunks)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, *, scale: Optional[float] = None,
                     softmax_in_input_dtype: bool = False) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias[h]) v per window. q/k/v ``[B·nW, H, N, D]``,
    bias ``[H, N, N]`` float32. CPU tensors take
    :func:`window_attention_plain`; CUDA tensors launch K1 (contiguous,
    float32 or bfloat16, N ≤ 256, D ≤ 64) or raise."""
    b, h, n, d = q.shape
    name = "window_attention"
    _kernel.require(name, bias.shape == (h, n, n),
                    f"bias must be [{h}, {n}, {n}], got {tuple(bias.shape)}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return window_attention_plain(
            q, k, v, bias, scale=scale,
            softmax_in_input_dtype=softmax_in_input_dtype)
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
    if b:
        _kernel.launch("rtvc_window_attention", q, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), b, h, n, d,
                       *_grid(b, h, n, q.device), float(scale),
                       int(softmax_in_input_dtype), code)
        window_attention.launches += 1
    return out


window_attention.launches = 0

# bias-free attention over at least this many keys goes to K4 (JAX's
# PALLAS_MIN_KV_LEN): the teacher's 1542- and 1582-key contexts
PALLAS_MIN_KV_LEN = 512


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False, prefix_len: int = 0,
                          kv_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """K4's arithmetic in PyTorch ops, as ``_block_probs`` computes it:
    float32 score products; disallowed scores set to -1e30 (a row with no
    allowed key averages V uniformly); float32 softmax; float32
    probabilities times float32 V; output in the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal or kv_mask is not None:
        s = s.masked_fill(~_allowed(q.shape[2], k.shape[2], causal,
                                    prefix_len, kv_mask, q.device), NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.float()).to(q.dtype)


def _strides(t: torch.Tensor, *dims: int) -> list:
    return [t.stride(d) for d in dims]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, prefix_len: int = 0,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    softmax_in_input_dtype: bool = False) -> torch.Tensor:
    """Fused attention over q ``[B, H, Lq, D]``, k/v ``[B, H, Lkv, D]``
    (any strides with D contiguous, e.g. head views of a packed QKV
    product), ``kv_mask`` ``[B or 1, Lkv]`` bool (True = attend). Returns a
    contiguous ``[B, H, Lq, D]``. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch K4 (float32 or
    bfloat16, D ≤ 64) or raise. The TPU kernel's in-kernel dropout and its
    input-dtype softmax come with the backward kernel and raise here."""
    name = "flash_attention"
    if dropout_rate > 0.0 or softmax_in_input_dtype:
        raise NotImplementedError(
            f"{name}: dropout and the input-dtype softmax are not ported")
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     prefix_len=prefix_len, kv_mask=kv_mask,
                                     scale=scale)
    _kernel.require(name, k.shape == v.shape == (b, h, lkv, d),
                    "k and v must be [B, H, Lkv, D] of q's B, H and D")
    _kernel.require(name, q.dtype == k.dtype == v.dtype,
                    "q, k and v must share a dtype")
    _kernel.require(name, d <= 64 and lkv >= 1,
                    f"takes D <= 64 and Lkv >= 1, got D={d}, Lkv={lkv}")
    for t in (q, k, v):
        _kernel.require(name, t.is_cuda and t.device == q.device
                        and t.stride(3) == 1,
                        f"q, k and v must lie on {q.device} with D contiguous")
    mask_ptr = 0
    if kv_mask is not None:
        _kernel.require(name, kv_mask.shape in ((b, lkv), (1, lkv)),
                        f"kv_mask must be [{b} or 1, {lkv}]")
        kv_mask = kv_mask.to(q.device, torch.bool).expand(b, lkv).contiguous()
        mask_ptr = kv_mask.data_ptr()
    code = _kernel.dtype_code(name, q)
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    if b and lq:
        _kernel.launch("rtvc_flash_attention", q, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), mask_ptr, b, h, lq, lkv,
                       d, *_strides(q, 0, 1, 2), *_strides(k, 0, 1, 2),
                       *_strides(v, 0, 1, 2), *_strides(out, 0, 1, 2),
                       float(scale), int(causal), int(prefix_len), code)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


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
    (float32 or bfloat16, D ≤ 64) or raise."""
    name = "blhd_attention"
    b, l, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return blhd_attention_plain(q, k, v, scale=scale)
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
                       *_strides(q, 0, 1, 2), *_strides(k, 0, 1, 2),
                       *_strides(v, 0, 1, 2), float(scale), code)
        blhd_attention.launches += 1
    return out


blhd_attention.launches = 0


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False, prefix_len: int = 0,
                         kv_mask: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         use_pallas: Optional[bool] = None,
                         softmax_in_input_dtype: bool = False
                         ) -> torch.Tensor:
    """JAX's routing: unmasked self-attention with an ``[H, N, N]`` (or
    ``[1, H, N, N]``) bias goes to :func:`window_attention`; bias-free
    attention over at least ``PALLAS_MIN_KV_LEN`` keys (or any, with
    ``use_pallas=True``) to :func:`flash_attention`; the rest, and all of
    it with ``use_pallas=False``, to :func:`attention_plain`."""
    heads, lq, lkv = q.shape[1], q.shape[2], k.shape[2]
    if (bias is not None and use_pallas is not False
            and not causal and kv_mask is None
            and q.shape == k.shape == v.shape
            and tuple(bias.shape) in ((1, heads, lq, lkv), (heads, lq, lkv))):
        return window_attention(
            q, k, v, bias[0] if bias.dim() == 4 else bias, scale=scale,
            softmax_in_input_dtype=softmax_in_input_dtype)
    if use_pallas is None:
        use_pallas = bias is None and lkv >= PALLAS_MIN_KV_LEN
    if use_pallas:
        return flash_attention(q, k, v, causal=causal, prefix_len=prefix_len,
                               kv_mask=kv_mask, scale=scale,
                               softmax_in_input_dtype=softmax_in_input_dtype)
    return attention_plain(q, k, v, causal=causal, prefix_len=prefix_len,
                           kv_mask=kv_mask, bias=bias, scale=scale,
                           softmax_in_input_dtype=softmax_in_input_dtype)
