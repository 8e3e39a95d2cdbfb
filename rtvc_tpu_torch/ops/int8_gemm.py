"""Int8 GEMMs: kernels K3 and K7 and their plain versions.

Counterpart of ``rtvc_tpu/ops/int8_gemm.py``:

- :func:`w8_matmul` / :func:`w8_dense` (K3, ``csrc/w8_matmul.cu``): the
  weight-only int8 GEMV of the student's 576→30522 vocab projection on the
  ``vocab_int8`` caption step. Unlike the JAX function, the output dtype
  is the dtype of ``x`` (the decode step asks for exactly that). ``wq``
  keeps JAX's ``[K, N]`` shape, but the kernel reads it K-contiguous: on a
  card, pass the ``[K, N]`` transposed view of an ``[N, K]`` pack (as
  ``quantization.quantize_vocab_head`` returns it, made once);
- :func:`w8a8_matmul` / :func:`w8a8_dense` (K7,
  ``csrc/w8a8_matmul_sm90.cu``, int8 wgmma): the W8A8 GEMM of the
  quantized teacher, bit-exact against :func:`w8a8_matmul_plain`. ``wq``
  keeps JAX's ``[K, N]`` shape, but the kernel reads it K-contiguous: pass
  the ``[K, N]`` transposed view of an ``[N, K]`` pack
  (``QuantLinear.weight_q.t()``, made once by
  ``quantization.quantize_teacher_``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernel

MAX_ROWS = 32


def w8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x · float(wq)) · sw + bias in float32, cast to ``x.dtype``."""
    y = torch.matmul(x.float(), wq.float()) * sw.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.to(x.dtype)


def w8_matmul(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [M, K]`` float32/bfloat16, ``wq [K, N]`` int8, ``sw`` and ``bias``
    N float32 values → ``[M, N]`` in ``x.dtype``. CPU tensors take
    :func:`w8_matmul_plain` (any layout of ``wq``); CUDA tensors launch K3
    or raise. K3 takes ``x`` contiguous with 1 ≤ M ≤ 32, ``wq`` the
    transposed view of a contiguous ``[N, K]`` pack (never copied here: a
    copy would move the whole weight again on every call), K a multiple of
    16, 16-byte aligned operands, and nothing requiring grad (K3 has no
    backward)."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, wq, sw, bias)
    name = "w8_matmul"
    _kernel.require_no_grad(name, x, sw, bias)
    _kernel.require(name, x.dim() == 2 and wq.dim() == 2,
                    "x and wq must be 2-D")
    m, k = x.shape
    n = wq.shape[1]
    _kernel.require(name, wq.shape[0] == k,
                    f"wq must be [{k}, N], got {tuple(wq.shape)}")
    pack = wq.t()
    _kernel.require(name, pack.is_contiguous(),
                    "wq must be the [K, N] view of a contiguous [N, K] pack "
                    "(quantization.quantize_vocab_head)")
    tensors = [x, pack, sw] + ([bias] if bias is not None else [])
    _kernel.require_cuda(name, *tensors)
    _kernel.require(name, wq.dtype == torch.int8, "wq must be int8")
    _kernel.require(name, 1 <= m <= MAX_ROWS,
                    f"takes 1 <= M <= {MAX_ROWS} rows, got {m}")
    _kernel.require(name, k % 16 == 0 and x.data_ptr() % 16 == 0
                    and pack.data_ptr() % 16 == 0,
                    f"takes K % 16 == 0 and 16-byte aligned x and wq, K={k}")
    for t, what in ((sw, "sw"), (bias, "bias")):
        if t is not None:
            _kernel.require(name, t.dtype == torch.float32 and t.numel() == n,
                            f"{what} must hold {n} float32 values")
    code = _kernel.dtype_code(name, x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _kernel.launch("rtvc_w8_matmul", x, x.data_ptr(), pack.data_ptr(),
                   sw.data_ptr(), 0 if bias is None else bias.data_ptr(),
                   out.data_ptr(), m, k, n, code)
    w8_matmul.launches += 1
    return out


w8_matmul.launches = 0


def w8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[..., K]`` activations through :func:`w8_matmul`."""
    lead = x.shape[:-1]
    y = w8_matmul(x.reshape(-1, x.shape[-1]), wq, sw, bias)
    return y.reshape(*lead, wq.shape[1])


def w8a8_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                      sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``float(xq · wq) · sx · sw + bias``: the integer sums exact in
    float64 (|sum| ≤ 127²·K stays far below 2^53; float32 would not be
    exact past 2^24), rounded to float32 as JAX casts its int32 sums, then
    the epilogue in float32 in the kernel's order."""
    acc = torch.matmul(xq.double(), wq.double()).float()
    y = acc * sx.reshape(-1, 1).float() * sw.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def w8a8_matmul(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``xq [M, K]`` int8 with per-row scales ``sx`` (M values), ``wq
    [K, N]`` int8 with per-column scales ``sw`` and ``bias`` (N float32
    values each) → ``[M, N]`` ``out_dtype``. CPU tensors take
    :func:`w8a8_matmul_plain`; CUDA tensors launch K7 or raise. K7 takes
    ``xq`` contiguous, ``wq`` the transposed view of a contiguous ``[N, K]``
    pack, K a multiple of 16, ``out_dtype`` float32 or bfloat16, and no
    scale or bias requiring grad (K7 has no backward; per-token scales of
    activations that require grad do)."""
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, sx, wq, sw, bias, out_dtype)
    name = "w8a8_matmul"
    _kernel.require_no_grad(name, sx, sw, bias)
    _kernel.require(name, xq.dim() == 2 and wq.dim() == 2,
                    "xq and wq must be 2-D")
    m, k = xq.shape
    n = wq.shape[1]
    pack = wq.t()
    tensors = [xq, sx, pack, sw] + ([bias] if bias is not None else [])
    _kernel.require_cuda(name, *tensors)
    _kernel.require(name, xq.dtype == wq.dtype == torch.int8,
                    "xq and wq must be int8")
    _kernel.require(name, wq.shape[0] == k,
                    f"wq must be [{k}, N], got {tuple(wq.shape)}")
    _kernel.require(name, k % 16 == 0 and xq.data_ptr() % 16 == 0
                    and pack.data_ptr() % 16 == 0,
                    f"takes K % 16 == 0 and 16-byte aligned operands, K={k}")
    for t, what, count in ((sx, "sx", m), (sw, "sw", n), (bias, "bias", n)):
        if t is not None:
            _kernel.require(name, t.dtype == torch.float32
                            and t.numel() == count,
                            f"{what} must hold {count} float32 values")
    code = _kernel.DTYPE_CODES.get(out_dtype)
    _kernel.require(name, code is not None,
                    f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m:
        _kernel.launch("rtvc_w8a8_matmul", xq, xq.data_ptr(), sx.data_ptr(),
                       pack.data_ptr(), sw.data_ptr(),
                       0 if bias is None else bias.data_ptr(),
                       out.data_ptr(), m, n, k, code)
        w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def w8a8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[..., K]`` float activations quantized per token (plain PyTorch,
    as JAX leaves it to XLA), then :func:`w8a8_matmul`."""
    from .quantization import quantize_activations

    lead = x.shape[:-1]
    k = x.shape[-1]
    xq, sx = quantize_activations(x)
    y = w8a8_matmul(xq.reshape(-1, k), sx.reshape(-1), wq, sw, bias,
                    out_dtype)
    return y.reshape(*lead, wq.shape[1])
