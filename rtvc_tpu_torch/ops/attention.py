"""Multi-head attention: the plain path and the window kernel K1.

Counterpart of ``rtvc_tpu/ops/attention.py``:

- :func:`attention_plain` is ``xla_attention`` (masks, learned bias, f32 or
  input-dtype softmax) in plain PyTorch ops, as JAX runs it in XLA: the
  student decoder's short self- and cross-attention;
- :func:`window_attention` is ``window_attention`` (the Pallas kernel
  ``_window_attention_fwd_pallas``) as the CUDA kernel
  ``csrc/window_attention.cu``, with :func:`window_attention_plain` beside
  it: TinyViT's window attention with its relative-position bias;
- :func:`multi_head_attention` routes bias-carrying, unmasked window
  attention to K1 and everything else to the plain path.

Layout as in JAX: q/k/v ``[B, H, L, D]``. The flash kernel of the teacher
(``flash_attention``, ``blhd_attention``) is not on the caption step and
is not ported yet.
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


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False, prefix_len: int = 0,
                         kv_mask: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         softmax_in_input_dtype: bool = False
                         ) -> torch.Tensor:
    """Unmasked self-attention with an ``[H, N, N]`` (or ``[1, H, N, N]``)
    bias goes to :func:`window_attention`; the rest to
    :func:`attention_plain`."""
    heads, lq, lkv = q.shape[1], q.shape[2], k.shape[2]
    if (bias is not None and not causal and kv_mask is None
            and q.shape == k.shape == v.shape
            and tuple(bias.shape) in ((1, heads, lq, lkv), (heads, lq, lkv))):
        return window_attention(
            q, k, v, bias[0] if bias.dim() == 4 else bias, scale=scale,
            softmax_in_input_dtype=softmax_in_input_dtype)
    return attention_plain(q, k, v, causal=causal, prefix_len=prefix_len,
                           kv_mask=kv_mask, bias=bias, scale=scale,
                           softmax_in_input_dtype=softmax_in_input_dtype)
