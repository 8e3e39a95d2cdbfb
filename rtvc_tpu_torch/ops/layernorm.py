"""LayerNorm over the last axis: kernel K2 and its plain version.

Counterpart of ``rtvc_tpu/ops/layernorm.py`` (``_pallas_ln``,
``fused_layer_norm``, ``FusedLayerNorm``). The CUDA kernel is
``csrc/layer_norm.cu``; it serves every LayerNorm of the caption step (the
student decoder's three norms per layer and TinyViT's attention and MLP
input norms).
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``x [..., W]``. CPU tensors take the plain version; CUDA
    tensors launch K2 (x, weight and bias contiguous, of one dtype, float32
    or bfloat16) or raise."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
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
