"""Weight-only int8 GEMV for decode rows: kernel K3 and its plain version.

Counterpart of ``w8_matmul`` / ``w8_dense`` in
``rtvc_tpu/ops/int8_gemm.py``; the CUDA kernel is ``csrc/w8_matmul.cu``.
It runs the student's 576→30522 vocab projection on the ``vocab_int8``
caption step. Unlike the JAX function, the output dtype is the dtype of
``x`` (the decode step asks for exactly that). The teacher's W8A8 GEMM
(``w8a8_matmul``) is not on the caption step and is not ported yet.
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
    :func:`w8_matmul_plain`; CUDA tensors launch K3 (contiguous, M ≤ 32,
    N a multiple of 4) or raise."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, wq, sw, bias)
    name = "w8_matmul"
    _kernel.require(name, x.dim() == 2 and wq.dim() == 2,
                    "x and wq must be 2-D")
    m, k = x.shape
    n = wq.shape[1]
    tensors = [x, wq, sw] + ([bias] if bias is not None else [])
    _kernel.require_cuda(name, *tensors)
    _kernel.require(name, wq.shape[0] == k,
                    f"wq must be [{k}, N], got {tuple(wq.shape)}")
    _kernel.require(name, wq.dtype == torch.int8, "wq must be int8")
    _kernel.require(name, 1 <= m <= MAX_ROWS,
                    f"takes 1 <= M <= {MAX_ROWS} rows, got {m}")
    _kernel.require(name, n % 4 == 0 and wq.data_ptr() % 4 == 0,
                    f"wq rows must be 4-byte aligned (N % 4 == 0), got N={n}")
    for t, what in ((sw, "sw"), (bias, "bias")):
        if t is not None:
            _kernel.require(name, t.dtype == torch.float32 and t.numel() == n,
                            f"{what} must hold {n} float32 values")
    code = _kernel.dtype_code(name, x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _kernel.launch("rtvc_w8_matmul", x, x.data_ptr(), wq.data_ptr(),
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
