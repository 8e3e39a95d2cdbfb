"""Plain float32 building blocks of the reference models.

Everything here is ``torch`` and ``torch.nn.functional`` on float32
tensors, with TF32 off (:func:`strict_float32`). Nothing imports the
program under test. Every matrix product (linear layers, convolutions and
the two attention products) goes through a :class:`Precision`, which in
float32 is the identity and in fp8 rounds both operands to fp8 (e4m3,
one scale per tensor), the step below bfloat16: a reading beside the
controls, the program's own int8 paths.

The random draws of the train step (dropout, DropPath) are drawn in the
program's order from the same CPU ``torch.Generator``: a host seed from the
generator, then ``torch.rand`` on the device from a device generator seeded
with it (on the CPU, ``torch.rand`` from the generator itself). The
reference therefore drops what the program drops; it does not look at the
program's masks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SEED_BOUND = 2 ** 31 - 1
NEG_INF = -1e30


def strict_float32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The arithmetic of the matrix products: ``"float32"`` (the reference)
    or ``"fp8"`` (both operands rounded to float8 e4m3 with a
    per-tensor scale, then multiplied in float32)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        amax = t.detach().abs().amax().float().clamp(min=1e-30)
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale

    def linear(self, x, w, b=None):
        return F.linear(self(x), self(w), b)

    def conv2d(self, x, w, stride=1, padding=0, groups=1):
        return F.conv2d(self(x), self(w), None, stride, padding, 1, groups)

    def matmul(self, a, b):
        return torch.matmul(self(a), self(b))


def layer_norm(x, w, b, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu(x, approximate: bool):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def draw_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, SEED_BOUND, (), generator=generator))


def uniform(shape: Sequence[int], generator: torch.Generator,
            device) -> torch.Tensor:
    if torch.device(device).type == "cpu":
        return torch.rand(tuple(shape), generator=generator)
    dev_gen = torch.Generator(device=device)
    dev_gen.manual_seed(draw_seed(generator))
    return torch.rand(tuple(shape), generator=dev_gen, device=device)


def drop(x, rate: float, generator, shape=None):
    """Dropout (``shape`` = x's) or DropPath (``shape`` = one draw a
    sample): keep where a uniform draw is below ``1 - rate``, kept values
    divided by ``1 - rate``. A rate of 0 draws nothing."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = uniform(x.shape if shape is None else shape, generator,
                   x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path(x, rate: float, generator):
    return drop(x, rate, generator, (x.shape[0],) + (1,) * (x.dim() - 1))


def attention(prec: Precision, q, k, v, *, scale: Optional[float] = None,
              allowed: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
              generator=None):
    """softmax(q kᵀ · scale + bias, masked where ``allowed`` is False) v,
    with dropout on the probabilities."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = prec.matmul(q, k.transpose(-1, -2)) * scale
    if allowed is not None:
        s = s + torch.where(allowed, 0.0, NEG_INF)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        p = drop(p, dropout_rate, generator)
    return prec.matmul(p, v)


def prefix_causal(lq: int, lkv: int, prefix_len: int, device) -> torch.Tensor:
    """Bool ``[lq, lkv]``: key j is seen from row i where j < prefix_len or
    j <= i."""
    i = torch.arange(lq, device=device)[:, None]
    j = torch.arange(lkv, device=device)[None, :]
    return (j < prefix_len) | (j <= i)


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """pe[pos, 2i] = sin(pos · 10000^(-2i/d)), pe[pos, 2i+1] = cos(...)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(frames_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """uint8 BGR ``[N, H, W, 3]`` → float32 ``[N, crop, crop, 3]``: the
    shorter edge resized to ``crop`` (bicubic, antialiased), a centre crop,
    BGR → RGB, CLIP's mean and deviation."""
    n, h, w, _ = frames_u8.shape
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    if h <= w:
        nh, nw = crop, max(int(round(w * crop / h)), crop)
    else:
        nh, nw = max(int(round(h * crop / w)), crop), crop
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bicubic",
                          align_corners=False, antialias=True)
    top, left = (nh - crop) // 2, (nw - crop) // 2
    x = x[:, :, top:top + crop, left:left + crop].flip(1)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)
