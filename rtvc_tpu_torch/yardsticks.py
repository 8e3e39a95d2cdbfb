"""Each kernel's bound and its library yardstick.

The **bound** of a kernel call is the least time an H100 SXM could take
for its work: the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s, and its operations over the
peak rate for its input type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
float32 CUDA cores, 1979 TOP/s int8; NVIDIA's data sheet, dense). Where
the work depends on the data (masked attention), it counts what these
inputs need.

The **yardstick** is one PyTorch library call that computes the same
function on the same inputs, where there is one. ``chip_smoke.py`` times
it beside the kernel; ``tests/test_torch_yardsticks.py`` holds it to the
kernel's plain version on the CPU. The port never calls a yardstick.

Every ``*_library`` function returns a :class:`Yardstick`: the call's name
and a zero-argument function, or ``fn=None`` and the reason there is none.
Set-up (masks, casts, a forward pass for a gradient) happens when the
yardstick is made, outside what is timed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  torch.int8: 1979e12}


@dataclass
class Work:
    """What one kernel call must do: bytes moved, operations, and the peak
    rate of the units that can do them."""
    bytes: float
    ops: float
    peak: float

    def bound(self) -> tuple:
        """(seconds, "bytes" or "operations"): the larger of the two
        times and which one it is."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = self.ops / self.peak
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


@dataclass
class Yardstick:
    name: str
    fn: Optional[Callable]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def peak(dtype: torch.dtype) -> float:
    return PEAK_OPS_PER_S[dtype]


# ---------------------------------------------------------------------------
# the work of each kernel
# ---------------------------------------------------------------------------

def allowed_pairs(b: int, lq: int, lkv: int, causal: bool = False,
                  prefix_len: int = 0,
                  kv_mask: Optional[torch.Tensor] = None) -> int:
    """(row, key) pairs K4 must take, summed over the ``b`` batch rows of
    one head: the keys each row may attend (prefix-causal ``k < P or
    k <= q``, and ``kv_mask`` [B or 1, lkv]); a row with no allowed key
    averages every key, so it counts ``lkv``."""
    rows = torch.arange(lq)
    reach = torch.full((lq,), lkv)
    if causal:
        reach = torch.clamp(torch.clamp(rows + 1, min=prefix_len), max=lkv)
    if kv_mask is None:
        return b * int(reach.sum())
    mask = kv_mask.to("cpu", torch.bool).expand(b, lkv)
    csum = torch.cat([torch.zeros(b, 1, dtype=torch.long),
                      mask.long().cumsum(1)], dim=1)
    per_row = csum[:, reach]
    return int(torch.where(per_row == 0, lkv, per_row).sum())


def flash_work(q, k, v, *, causal: bool = False, prefix_len: int = 0,
               kv_mask: Optional[torch.Tensor] = None, **_) -> Work:
    """K4: q, k, v (and the key mask) read, O written; two products of
    2·D operations per allowed pair."""
    b, h, lq, d = q.shape
    pairs = allowed_pairs(b, lq, k.shape[2], causal, prefix_len, kv_mask)
    extra = 0 if kv_mask is None else kv_mask.numel()
    return Work(2 * nbytes(q) + nbytes(k, v) + extra, 4 * d * h * pairs,
                peak(q.dtype))


def flash_bwd_work(q, k, v, g, *, causal: bool = False, prefix_len: int = 0,
                   kv_mask: Optional[torch.Tensor] = None, **_) -> Work:
    """K8: q, k, v, dO read, dQ, dK, dV written; five products of 2·D
    operations per allowed pair (S recomputed, dV, dP, dQ, dK)."""
    b, h, lq, d = q.shape
    pairs = allowed_pairs(b, lq, k.shape[2], causal, prefix_len, kv_mask)
    extra = 0 if kv_mask is None else kv_mask.numel()
    return Work(2 * nbytes(q, k, v) + nbytes(g) + extra,
                10 * d * h * pairs, peak(q.dtype))


def blhd_work(q, k, v) -> Work:
    """K5: q, k, v read from [B, L, H, D], O written; every key allowed."""
    b, l, h, d = q.shape
    return Work(2 * nbytes(q) + nbytes(k, v), 4 * d * h * b * l * l,
                peak(q.dtype))


def window_work(q, k, v, bias, **_) -> Work:
    """K1: q, k, v and the bias read, O written; 4·D per (row, key)."""
    b, h, n, d = q.shape
    return Work(2 * nbytes(q) + nbytes(k, v, bias), 4 * b * h * n * n * d,
                peak(q.dtype))


def layer_norm_work(x, w, b, *_) -> Work:
    """K2: x, weight, bias read, y written; ~8 operations per element."""
    return Work(2 * nbytes(x) + nbytes(w, b), 8 * x.numel(), peak(x.dtype))


def add_layer_norm_work(x, delta, w, b, *_) -> Work:
    """K6: x, delta, weight, bias read, the sum and its norm written."""
    return Work(3 * nbytes(x) + nbytes(delta, w, b), 9 * x.numel(),
                peak(x.dtype))


def w8_work(x, wq, sw, b=None) -> Work:
    """K3: x, the int8 weight, its scales and the bias read, y written;
    2·K per output."""
    m, kdim = x.shape
    n = wq.shape[1]
    extra = 0 if b is None else nbytes(b)
    return Work(nbytes(x, wq, sw) + extra + m * n * x.element_size(),
                2 * m * kdim * n, peak(x.dtype))


def w8a8_work(xq, sx, wq, sw, b, out_dtype) -> Work:
    """K7: int8 x and w, their scales and the bias read, y written in
    ``out_dtype``; 2·K int8 operations per output."""
    m, kdim = xq.shape
    n = wq.shape[1]
    extra = 0 if b is None else nbytes(b)
    out = m * n * torch.empty((), dtype=out_dtype).element_size()
    return Work(nbytes(xq, sx, wq, sw) + extra + out, 2 * m * kdim * n,
                peak(torch.int8))


def dw3x3_wgrad_work(x, dy) -> Work:
    """K9: x and dy read, the float32 [C, 1, 3, 3] gradient written; 18
    operations per element."""
    return Work(nbytes(x, dy) + 9 * x.shape[1] * 4, 18 * x.numel(),
                peak(x.dtype))


# ---------------------------------------------------------------------------
# the library call beside each kernel
# ---------------------------------------------------------------------------

def window_library(q, k, v, bias, scale=None, **_) -> Yardstick:
    """K1: SDPA with the bias as an additive mask (cast to q's dtype)."""
    mask = bias.to(q.dtype)
    return Yardstick(
        "F.scaled_dot_product_attention(attn_mask=bias)",
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=scale))


def layer_norm_library(x, w, b, eps: float = 1e-5) -> Yardstick:
    return Yardstick("F.layer_norm",
                     lambda: F.layer_norm(x, (x.shape[-1],), w, b, eps))


def add_layer_norm_library(x, delta, w, b, eps: float = 1e-5) -> Yardstick:
    """K6: two calls, the add and ``F.layer_norm``; returns (sum, norm) as
    K6 does."""
    def fn():
        y = x + delta
        return y, F.layer_norm(y, (x.shape[-1],), w, b, eps)
    return Yardstick("x + delta, then F.layer_norm (two calls)", fn)


def w8_library(x, wq, sw, b=None) -> Yardstick:
    """K3: ``torch._weight_int8pack_mm`` (int8 weight [N, K], per-column
    scales in x's dtype; the bias is added by a second call, left out of
    the time). Where the card's torch lacks it, the call raises and the
    kernel phase records none."""
    if not hasattr(torch, "_weight_int8pack_mm"):
        return Yardstick("none: torch has no _weight_int8pack_mm", None)
    w_nk = wq.t().contiguous()
    scales = sw.to(x.dtype)
    return Yardstick("torch._weight_int8pack_mm (no bias)",
                     lambda: torch._weight_int8pack_mm(x, w_nk, scales))


def w8a8_library(xq, sx, wq, sw, b, out_dtype) -> Yardstick:
    """K7: ``torch._int_mm``, the int32 product alone (no rescale, bias or
    cast)."""
    return Yardstick("torch._int_mm (the int32 product alone)",
                     lambda: torch._int_mm(xq, wq))


def flash_mask(q, k, causal: bool, prefix_len: int,
               kv_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """K4's allowed (row, key) pairs as SDPA's bool mask [B or 1, 1, Lq,
    Lkv], or None where every key is allowed."""
    if not causal and kv_mask is None:
        return None
    lq, lkv = q.shape[2], k.shape[2]
    allowed = torch.ones((1, 1, lq, lkv), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None]
        keys = torch.arange(lkv, device=q.device)[None, :]
        allowed = allowed & ((keys < prefix_len) | (keys <= rows))
    if kv_mask is not None:
        allowed = allowed & kv_mask.to(q.device, torch.bool)[:, None, None, :]
    return allowed


def flash_library(q, k, v, *, causal: bool = False, prefix_len: int = 0,
                  kv_mask: Optional[torch.Tensor] = None, scale=None,
                  dropout_rate: float = 0.0, **_) -> Yardstick:
    """K4 without dropout: SDPA with the bool mask. A row with no allowed
    key gives NaN there (the kernel averages V). With dropout there is
    none: SDPA's dropout draws other bits."""
    if dropout_rate > 0.0:
        return Yardstick("none: SDPA's dropout draws other bits", None)
    mask = flash_mask(q, k, causal, prefix_len, kv_mask)
    return Yardstick(
        "F.scaled_dot_product_attention(attn_mask=bool)",
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=scale))


def blhd_library(q, k, v, scale=None) -> Yardstick:
    """K5: SDPA on the [B, H, L, D] transposes of the [B, L, H, D] views;
    its output is the [B, L, H, D] transpose back (a view)."""
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    return Yardstick(
        "F.scaled_dot_product_attention on the transposed views",
        lambda: F.scaled_dot_product_attention(*heads, scale=scale)
        .transpose(1, 2))


def flash_bwd_library(q, k, v, g, *, causal: bool = False,
                      prefix_len: int = 0,
                      kv_mask: Optional[torch.Tensor] = None, scale=None,
                      dropout_rate: float = 0.0, **_) -> Yardstick:
    """K8 without dropout: the backward of SDPA with the bool mask, through
    ``torch.autograd.grad``; its forward runs here, once, outside what is
    timed. With dropout there is none."""
    if dropout_rate > 0.0:
        return Yardstick("none: SDPA's dropout draws other bits", None)
    mask = flash_mask(q, k, causal, prefix_len, kv_mask)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             scale=scale)
    return Yardstick(
        "backward of F.scaled_dot_product_attention(attn_mask=bool)",
        lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))


def dw3x3_wgrad_library(x, dy) -> Yardstick:
    """K9: ``torch.nn.grad.conv2d_weight`` of the depthwise conv (cuDNN; a
    float32 call runs in TF32 where ``torch.backends.cudnn.allow_tf32``)."""
    c = x.shape[1]
    return Yardstick(
        "torch.nn.grad.conv2d_weight(groups=C)",
        lambda: torch.nn.grad.conv2d_weight(x, (c, 1, 3, 3), dy, padding=1,
                                            groups=c))
