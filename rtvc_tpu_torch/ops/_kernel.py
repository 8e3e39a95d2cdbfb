"""What every kernel wrapper does before and at a launch: check the
tensors it was given, name their dtype to the C side, launch on the current
stream and raise if the launch failed."""

from __future__ import annotations

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def require(name: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All tensors contiguous and on the first one's CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        require(name, t.is_cuda and t.device == dev,
                f"tensors must all be on {dev}, got {t.device}")
        require(name, t.is_contiguous(), "tensors must be contiguous")


def require_no_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a gradient through a kernel that has
    no backward: its output, filled by the kernel, would carry no autograd
    history and cut the gradient without an error."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; call it under "
            f"torch.no_grad() or on tensors that do not require grad")


def launch(fn_name: str, like: torch.Tensor, *args) -> None:
    """Call C entry ``fn_name`` with ``args`` and the current stream of
    ``like``'s device, and raise if ``cudaGetLastError()`` reports a failed
    launch."""
    stream = torch.cuda.current_stream(like.device).cuda_stream
    _build.check(getattr(_build.lib(), fn_name)(*args, stream), fn_name)
