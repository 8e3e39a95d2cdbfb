"""LayerNorm over the last axis: kernels K2 and K6 and their plain
versions.

Counterpart of ``rtvc_tpu/ops/layernorm.py``: ``_pallas_ln``,
``fused_layer_norm`` and ``FusedLayerNorm`` (K2), ``_pallas_add_ln``,
``fused_add_layer_norm`` and ``FusedAddLayerNorm`` (K6). Both kernels are
in ``csrc/layer_norm.cu``. K2 serves every plain LayerNorm of the caption
step, the teacher and the train step; K6 the residual add + norm at the
CLIP blocks' ln_2.

:func:`layer_norm` is a ``torch.autograd.Function``: its forward calls the
``torch.library`` operator ``rtvc::layer_norm``, whose CPU kernel is the
plain version and whose CUDA kernel launches K2 (an exported or compiled
program, ``export.py``, keeps each call as a node), and its backward is
``_fused_ln_bwd``'s closed form in PyTorch ops on both.
:func:`fused_add_layer_norm` (K6) is an autograd Function too (its
forward the plain version or K6 directly), whose backward is
``_fused_add_ln_bwd``'s: the LayerNorm closed form of the rounded sum plus
the sum's own gradient, the same for x and delta.
"""

from __future__ import annotations

import torch
from torch import nn

from . import _kernel


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """float32 mean, then the variance of the centred row, as
    ``_pallas_ln`` computes them; output in ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    cent = x32 - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    y = cent * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                         g: torch.Tensor, eps: float = 1e-5):
    """(dx, dweight, dbias): ``_fused_ln_bwd`` in PyTorch ops, float32
    statistics recomputed from x, cast to the input dtypes."""
    width = x.shape[-1]
    x32 = x.reshape(-1, width).float()
    g32 = g.reshape(-1, width).float()
    mean = x32.mean(dim=-1, keepdim=True)
    cent = x32 - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = cent * rstd
    gy = g32 * weight.float()
    dx = rstd * (gy - gy.mean(dim=-1, keepdim=True)
                 - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
    dweight = (g32 * xhat).sum(dim=0)
    dbias = g32.sum(dim=0)
    return (dx.reshape(x.shape).to(x.dtype), dweight.to(weight.dtype),
            dbias.to(weight.dtype))


def _layer_norm_kernel(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> torch.Tensor:
    """K2 on CUDA tensors: ``rtvc::layer_norm``'s CUDA kernel. The checks
    run here, where the tensors are real."""
    name = "layer_norm"
    width = x.shape[-1]
    _kernel.require_cuda(name, x, weight, bias)
    _kernel.require(name, weight.shape == bias.shape == (width,),
                    f"weight/bias must be [{width}]")
    _kernel.require(name, weight.dtype == bias.dtype == x.dtype,
                    "x, weight and bias must share a dtype")
    code = _kernel.dtype_code(name, x)
    out = torch.empty_like(x)
    rows = x.numel() // width
    if rows:
        _kernel.launch("rtvc_layer_norm", x, x.data_ptr(), weight.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), rows, width,
                       float(eps), code)
        layer_norm.launches += 1
    return out


@torch.library.custom_op("rtvc::layer_norm", mutates_args=(),
                         device_types="cpu")
def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """K2 as an operator: the plain version on the CPU, the kernel on CUDA
    (:func:`_layer_norm_kernel`). An exported or compiled program keeps
    each call as an ``rtvc.layer_norm`` node."""
    return layer_norm_plain(x, weight, bias, eps)


_layer_norm_op.register_kernel("cuda")(_layer_norm_kernel)


@_layer_norm_op.register_fake
def _(x, weight, bias, eps):
    return torch.empty_like(x)


def _layer_norm_forward(x, weight, bias, eps: float):
    """``rtvc::layer_norm``: the plain version for CPU tensors, K2 for
    CUDA tensors."""
    return torch.ops.rtvc.layer_norm(x, weight, bias, eps)


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _layer_norm_forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*layer_norm_bwd_plain(x, weight, g, ctx.eps), None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``x [..., W]``. CPU tensors take the plain version; CUDA
    tensors launch K2 (x, weight and bias contiguous, of one dtype, float32
    or bfloat16) or raise. Differentiable in x, weight and bias
    (:func:`layer_norm_bwd_plain`)."""
    return _LayerNorm.apply(x, weight, bias, float(eps))


layer_norm.launches = 0


class FusedLayerNorm(nn.Module):
    """``nn.LayerNorm``'s parameters (``weight``, ``bias``) over K2."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def fused_add_layer_norm_plain(x: torch.Tensor, delta: torch.Tensor,
                               weight: torch.Tensor, bias: torch.Tensor,
                               eps: float = 1e-5):
    """``(y, h)``: the float32 sum ``x + delta`` rounded to ``x.dtype``, and
    the LayerNorm of the unrounded float32 sum in ``x.dtype``, as
    ``_pallas_add_ln`` computes them."""
    s = x.float() + delta.float()
    return s.to(x.dtype), layer_norm_plain(s, weight, bias, eps).to(x.dtype)


def _fused_add_layer_norm_forward(x, delta, weight, bias, eps: float):
    """The plain version for CPU tensors, K6 for CUDA tensors."""
    if x.device.type == "cpu":
        return fused_add_layer_norm_plain(x, delta, weight, bias, eps)
    name = "fused_add_layer_norm"
    width = x.shape[-1]
    _kernel.require_cuda(name, x, delta, weight, bias)
    _kernel.require(name, delta.shape == x.shape,
                    "x and delta must share a shape")
    _kernel.require(name, weight.shape == bias.shape == (width,),
                    f"weight/bias must be [{width}]")
    _kernel.require(name, x.dtype == delta.dtype == weight.dtype == bias.dtype,
                    "x, delta, weight and bias must share a dtype")
    code = _kernel.dtype_code(name, x)
    y, h = torch.empty_like(x), torch.empty_like(x)
    rows = x.numel() // width
    if rows:
        _kernel.launch("rtvc_add_layer_norm", x, x.data_ptr(),
                       delta.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                       y.data_ptr(), h.data_ptr(), rows, width, float(eps),
                       code)
        fused_add_layer_norm.launches += 1
    return y, h


def fused_add_layer_norm_bwd_plain(y: torch.Tensor, weight: torch.Tensor,
                                   gy: torch.Tensor, gh: torch.Tensor,
                                   eps: float = 1e-5):
    """(dx, ddelta, dweight, dbias): ``_fused_add_ln_bwd`` in PyTorch ops.
    The LayerNorm closed form (:func:`layer_norm_bwd_plain`) of the ROUNDED
    sum ``y``, not of the float32 sum the forward normalised; its dx in
    ``y``'s dtype plus ``gy`` in float32, rounded to ``y``'s dtype; x and
    delta get that same gradient."""
    dy_ln, dweight, dbias = layer_norm_bwd_plain(y, weight, gh, eps)
    dy = (dy_ln.float() + gy.float()).to(y.dtype)
    return dy, dy, dweight, dbias


class _FusedAddLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, delta, weight, bias, eps):
        y, h = _fused_add_layer_norm_forward(x, delta, weight, bias, eps)
        ctx.save_for_backward(y, weight)
        ctx.eps = eps
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        y, weight = ctx.saved_tensors
        return (*fused_add_layer_norm_bwd_plain(y, weight, gy, gh, ctx.eps),
                None)


def fused_add_layer_norm(x: torch.Tensor, delta: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5):
    """``(y, h) = (x + delta, LayerNorm(x + delta))`` over ``[..., W]``. CPU
    tensors take the plain version; CUDA tensors launch K6 (all contiguous,
    of one dtype, float32 or bfloat16) or raise. Differentiable in x,
    delta, weight and bias (:func:`fused_add_layer_norm_bwd_plain`)."""
    return _FusedAddLayerNorm.apply(x, delta, weight, bias, float(eps))


fused_add_layer_norm.launches = 0


class FusedAddLayerNorm(FusedLayerNorm):
    """The same parameters as :class:`FusedLayerNorm`, called as
    ``(y, h) = norm(x, delta)`` over K6."""

    def forward(self, x: torch.Tensor, delta: torch.Tensor):
        return fused_add_layer_norm(x, delta, self.weight, self.bias,
                                    self.eps)
