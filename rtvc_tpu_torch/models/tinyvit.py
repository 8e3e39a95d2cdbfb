"""TinyViT image encoder (the student's frame encoder).

Counterpart of ``rtvc_tpu/models/tinyvit.py``, grown from the timm-layout
replica in ``tests/tinyvit_torch_replica.py``: the module tree and the
state-dict keys are timm's ``tiny_vit_21m_224``, so a timm checkpoint loads
with ``load_state_dict`` and ``rtvc_tpu.models.convert`` reads this
module's state dict as it is. Added to the replica:

- the GELU variant (``TinyViTConfig.gelu_approximate``; the student runs
  tanh GELU, timm erf);
- window attention through :func:`ops.attention.multi_head_attention`
  (kernel K1 on CUDA) with the softmax in the input dtype, as the JAX
  model runs it;
- LayerNorms through kernel K2;
- the bias-index table built once per block, not per call;
- NHWC in and NHWC stage maps out (the JAX layout); the convolutions run
  NCHW inside;
- train mode (``.train()``), as the JAX model runs with ``train=True``:
  flax's BatchNorm (:class:`BatchNorm2d`), DropPath at the per-block rates
  ``linspace(0, drop_path_rate)``, the MLP's dropout, and every stride-1
  depthwise 3x3 (MBConv ``conv2``, each block's ``local_conv``) through
  :func:`ops.depthwise.depthwise_conv3x3`, whose weight gradient is kernel
  K9. The stride-2 depthwise conv of ``PatchMerging`` stays ``F.conv2d``,
  as it stays a plain conv in JAX.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import TinyViTConfig, tiny_vit_21m_config
from ..ops.attention import multi_head_attention
from ..ops.depthwise import depthwise_conv3x3
from ..ops.layernorm import FusedLayerNorm
from .layers import DropPath, Mlp, gelu

BN_STATS = ("running_mean", "running_var")


class BatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW, with
    ``nn.BatchNorm2d``'s state-dict keys.

    Train mode normalises with the batch statistics (``F.batch_norm``
    computes them in float32 for a bfloat16 input, with the biased
    variance, as flax does) and updates ``running = 0.9 · running + 0.1 ·
    batch`` with the biased variance of the float32 input, where
    ``nn.BatchNorm2d`` would take the unbiased one. Eval mode is
    ``F.batch_norm`` on the running statistics cast to the input dtype.
    The running statistics stay float32 buffers whatever dtype the module
    is cast to. ``update_running_stats = False`` (set by the student's
    activation checkpointing for its recompute) normalises as train mode
    does but leaves the statistics as they are.

    ``dp_group`` (set by ``parallel.place_params`` on a mesh with dp > 1)
    makes train mode take the global batch's statistics, as flax's
    BatchNorm does under a dp-sharded jit: the float32 per-channel sum,
    sum of squares and count are summed over the group (their gradients
    too), the variance is flax's E[x²] - E[x]², and the running
    statistics update from the global values, the same on every rank.
    ``nn.SyncBatchNorm`` would update them with the unbiased variance."""

    dp_group = None

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.update_running_stats = True

    def _apply(self, fn, recurse=True):
        stats = {name: self._buffers[name] for name in BN_STATS}
        super()._apply(fn, recurse)
        for name, t in stats.items():  # follow the device, not the dtype
            self._buffers[name] = t.to(self._buffers[name].device,
                                       torch.float32)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(x.dtype),
                                self.running_var.to(x.dtype), self.weight,
                                self.bias, False, 0.0, self.eps)
        if self.dp_group is not None:
            return self._global_batch_norm(x)
        if self.update_running_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self.num_batches_tracked += 1

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import all_reduce_sum

        xf = x.float()
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c, dtype=torch.float32)
        local = torch.cat([xf.sum(dim=(0, 2, 3)),
                           (xf * xf).sum(dim=(0, 2, 3)), count])
        total = all_reduce_sum(local, self.dp_group)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        if self.update_running_stats:
            with torch.no_grad():
                self._update_running(mean.detach(), var.detach())
        shape = (1, c, 1, 1)
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * scale.view(shape) \
            + self.bias.float().view(shape)
        return y.to(x.dtype)


class Conv2dBN(nn.Module):
    """Conv2d without bias, then :class:`BatchNorm2d`. A stride-1
    depthwise 3x3 runs through :func:`depthwise_conv3x3`."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                              bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-5)
        self.depthwise3x3 = k == 3 and stride == 1 and groups == cin == cout

    def forward(self, x):
        if self.depthwise3x3:
            return self.bn(depthwise_conv3x3(x, self.conv.weight))
        return self.bn(self.conv(x))


class PatchEmbed(nn.Module):
    """Two stride-2 Conv2dBN stems with a GELU between: 224 → 56."""

    def __init__(self, dim: int, gelu_approximate: bool):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.conv1 = Conv2dBN(3, dim // 2, 3, 2)
        self.conv2 = Conv2dBN(dim // 2, dim, 3, 2)

    def forward(self, x):
        return self.conv2(gelu(self.conv1(x), self.gelu_approximate))


class MBConv(nn.Module):
    """Inverted-residual block of stage 0."""

    def __init__(self, dim: int, expand_ratio: float, gelu_approximate: bool,
                 drop_path: float = 0.0):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        hidden = int(dim * expand_ratio)
        self.conv1 = Conv2dBN(dim, hidden, 1)
        self.conv2 = Conv2dBN(hidden, hidden, 3, groups=hidden)
        self.conv3 = Conv2dBN(hidden, dim, 1)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        g = self.gelu_approximate
        shortcut = x
        x = gelu(self.conv1(x), g)
        x = gelu(self.conv2(x), g)
        x = self.drop_path(self.conv3(x), generator)
        return gelu(shortcut + x, g)


class PatchMerging(nn.Module):
    """Stage transition: 1x1 expand → 3x3 stride-2 depthwise → 1x1."""

    def __init__(self, cin: int, cout: int, gelu_approximate: bool):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.conv1 = Conv2dBN(cin, cout, 1)
        self.conv2 = Conv2dBN(cout, cout, 3, 2, groups=cout)
        self.conv3 = Conv2dBN(cout, cout, 1)

    def forward(self, x):
        g = self.gelu_approximate
        x = gelu(self.conv1(x), g)
        x = gelu(self.conv2(x), g)
        return self.conv3(x)


def attention_bias_idxs(window: int) -> torch.Tensor:
    """(query, key) → per-|offset| bias slot, in first-seen order (the
    layout of timm and of the JAX model for a square window)."""
    points = [(i, j) for i in range(window) for j in range(window)]
    offsets = {}
    idxs = torch.zeros(len(points), len(points), dtype=torch.long)
    for qi, (qx, qy) in enumerate(points):
        for ki, (kx, ky) in enumerate(points):
            off = (abs(qx - kx), abs(qy - ky))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs[qi, ki] = offsets[off]
    return idxs


class Attention(nn.Module):
    """LeViT-style window attention with learned per-offset biases, on
    ``[B·nW, N, C]`` windows."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = dim // num_heads
        self.norm = FusedLayerNorm(dim)
        self.qkv = nn.Linear(dim, num_heads * self.key_dim * 3)
        self.proj = nn.Linear(num_heads * self.key_dim, dim)
        idxs = attention_bias_idxs(window)
        self.register_buffer("attention_bias_idxs", idxs, persistent=False)
        self.attention_biases = nn.Parameter(
            torch.zeros(num_heads, int(idxs.max()) + 1))

    def forward(self, x):
        bw, n, _ = x.shape
        qkv = self.qkv(self.norm(x)).view(bw, n, self.num_heads, 3,
                                          self.key_dim)
        # one copy into [3, B·nW, H, N, kd]: q, k and v each contiguous
        q, k, v = qkv.permute(3, 0, 2, 1, 4).contiguous().unbind(0)
        bias = self.attention_biases.float()[:, self.attention_bias_idxs]
        out = multi_head_attention(q, k, v, bias=bias,
                                   scale=self.key_dim ** -0.5,
                                   softmax_in_input_dtype=True)
        return self.proj(out.permute(0, 2, 1, 3).reshape(bw, n, -1))


class TinyVitBlock(nn.Module):
    """Window attention + depthwise local conv + MLP, NCHW in and out."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 mlp_ratio: float, fmap: int, gelu_approximate: bool,
                 drop_path: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.window = min(window, fmap)
        self.attn = Attention(dim, num_heads, self.window)
        self.local_conv = Conv2dBN(dim, dim, 3, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approximate, dropout)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, c, h, w = x.shape
        win = self.window
        shortcut = x
        ph, pw = (win - h % win) % win, (win - w % win) % win
        xp = nn.functional.pad(x, (0, pw, 0, ph))
        hh, ww = h + ph, w + pw
        # NCHW → [B·nW, win·win, C], windows in the JAX model's scan order
        xw = xp.view(b, c, hh // win, win, ww // win, win)
        xw = xw.permute(0, 2, 4, 3, 5, 1).reshape(-1, win * win, c)
        aw = self.attn(xw)
        aw = aw.view(b, hh // win, ww // win, win, win, c)
        aw = aw.permute(0, 5, 1, 3, 2, 4).reshape(b, c, hh, ww)
        x = shortcut + self.drop_path(aw[:, :, :h, :w], generator)
        x = self.local_conv(x)
        xt = x.flatten(2).transpose(1, 2).contiguous()  # [B, HW, C]
        xt = xt + self.drop_path(self.mlp(xt, generator), generator)
        return xt.transpose(1, 2).reshape(b, c, h, w)


class TinyViT(nn.Module):
    """Four-stage TinyViT feature extractor (timm ``features_only``).

    ``input_size`` fixes each stage's map size, and with it the effective
    window (``min(window, map)``) and the size of each bias table. Block
    ``i`` of all blocks drops its paths at ``linspace(0, drop_path_rate)
    [i]`` in train mode."""

    def __init__(self, config: TinyViTConfig = tiny_vit_21m_config(),
                 input_size: int = 224):
        super().__init__()
        cfg = config
        g = cfg.gelu_approximate
        self.config = cfg
        self.patch_embed = PatchEmbed(cfg.embed_dims[0], g)
        fmaps = [input_size // 4 // (2 ** s) for s in range(4)]
        rates = iter(float(r) for r in np.linspace(0, cfg.drop_path_rate,
                                                   sum(cfg.depths)))
        stages = [nn.ModuleDict({"blocks": nn.ModuleList(
            [MBConv(cfg.embed_dims[0], cfg.mbconv_expand_ratio, g,
                    next(rates))
             for _ in range(cfg.depths[0])])})]
        for s in range(1, 4):
            stages.append(nn.ModuleDict({
                "downsample": PatchMerging(cfg.embed_dims[s - 1],
                                           cfg.embed_dims[s], g),
                "blocks": nn.ModuleList(
                    [TinyVitBlock(cfg.embed_dims[s], cfg.num_heads[s],
                                  cfg.window_sizes[s], cfg.mlp_ratio,
                                  fmaps[s], g, next(rates), cfg.dropout)
                     for _ in range(cfg.depths[s])]),
            }))
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``x [B, H, W, 3]`` → four stage maps ``[B, H_s, W_s, C_s]``.
        ``generator`` (CPU) feeds DropPath and dropout in train mode."""
        x = x.permute(0, 3, 1, 2).to(self.patch_embed.conv1.conv.weight.dtype)
        x = self.patch_embed(x)
        maps = []
        for s, stage in enumerate(self.stages):
            if s > 0:
                x = stage["downsample"](x)
            for blk in stage["blocks"]:
                x = blk(x, generator)
            maps.append(x.permute(0, 2, 3, 1))
        return maps


def stage_means(feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
    """Spatial mean of each NHWC stage map: ``[B, H, W, C]`` → ``[B, C]``."""
    return [f.mean(dim=(1, 2)) for f in feature_maps]
