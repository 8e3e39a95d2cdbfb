"""Stride-1 depthwise 3x3 conv with a one-pass weight gradient: kernel K9
and its plain version.

Counterpart of ``rtvc_tpu/ops/depthwise.py``, in the port's NCHW layout
(weights ``[C, 1, 3, 3]``, JAX's are HWIO ``[3, 3, 1, C]``):

- :func:`dw3x3_wgrad_plain` is ``dw3x3_wgrad_xla``: nine multiply-reduces
  of the zero-padded x against dy, in float32;
- :func:`dw3x3_wgrad` is ``dw3x3_wgrad_pallas`` as the CUDA kernel
  ``csrc/depthwise_wgrad.cu`` (K9);
- :func:`depthwise_conv3x3` is ``depthwise_conv3x3`` with its custom VJP:
  the forward is ``F.conv2d`` (JAX's is a lax conv), the input gradient the
  depthwise conv of dy with the spatially flipped kernel, the weight
  gradient :func:`dw3x3_wgrad`. TinyViT sends every stride-1 depthwise 3x3
  (MBConv ``conv2``, each block's ``local_conv``) through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernel


def dw3x3_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` x, dy → float32 ``[C, 1, 3, 3]``: wgrad[c, ki, kj] =
    Σ x_pad[n, c, h + ki, w + kj] · dy[n, c, h, w]."""
    _, c, h, w = x.shape
    xpad = F.pad(x.float(), (1, 1, 1, 1))
    dyf = dy.float()
    taps = [(xpad[:, :, ki:ki + h, kj:kj + w] * dyf).sum(dim=(0, 2, 3))
            for ki in range(3) for kj in range(3)]
    return torch.stack(taps, dim=1).reshape(c, 1, 3, 3)


def dw3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The depthwise 3x3 weight gradient, float32 ``[C, 1, 3, 3]``. CPU
    tensors take :func:`dw3x3_wgrad_plain`; CUDA tensors launch K9 (x and
    dy contiguous ``[N, C, H, W]`` of one dtype, float32 or bfloat16, N at
    most 65535, one plane of x and one of dy at most 200 KB together) or
    raise. K9 sums each image into a float32 scratch ``[N, C, 9]``, then
    those over N in a fixed order: the same bits on every run."""
    if x.device.type == "cpu":
        return dw3x3_wgrad_plain(x, dy)
    name = "dw3x3_wgrad"
    _kernel.require_cuda(name, x, dy)
    _kernel.require(name, x.dim() == 4 and x.shape == dy.shape,
                    "x and dy must share one [N, C, H, W] shape")
    _kernel.require(name, x.dtype == dy.dtype, "x and dy must share a dtype")
    n, c, h, w = x.shape
    code = _kernel.dtype_code(name, x)
    _kernel.require(name, n <= 65535 and 2 * h * w * x.element_size()
                    <= 200 * 1024,
                    f"takes N <= 65535 and planes of at most 100 KB, got "
                    f"{tuple(x.shape)} {x.dtype}")
    out = torch.empty((c, 9), dtype=torch.float32, device=x.device)
    if x.numel():
        part = torch.empty((n, c, 9), dtype=torch.float32, device=x.device)
        _kernel.launch("rtvc_dw3x3_wgrad", x, x.data_ptr(), dy.data_ptr(),
                       part.data_ptr(), out.data_ptr(), n, c, h, w, code)
        dw3x3_wgrad.launches += 1
    else:
        out.zero_()
    return out.reshape(c, 1, 3, 3)


dw3x3_wgrad.launches = 0


def _dw_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, weight.to(x.dtype), None, 1, 1, 1, x.shape[1])


class _DepthwiseConv3x3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _dw_conv(x, weight)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dw_conv(dy, weight.flip(2, 3)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = dw3x3_wgrad(x.contiguous(), dy.to(x.dtype)).to(weight.dtype)
        return dx, dw


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Zero-padded stride-1 depthwise conv of ``x [N, C, H, W]`` with
    ``weight [C, 1, 3, 3]``, differentiable in both (weight gradient by
    :func:`dw3x3_wgrad`)."""
    return _DepthwiseConv3x3.apply(x, weight)
