"""Plain float32 reference of the caption student: TinyViT-21M over each
frame, the mean of its last stage map as one memory token a frame, and
the post-norm caption decoder (self-attention, cross-attention over the
frames, ReLU FFN, tied to nothing) with its vocabulary projection.

Written from the published model (timm ``tiny_vit_21m_224``; the
reference repository's ``StudentCandidateV1``), with the parameter names
and layouts of the checkpoint the program loads, so that one set of
seeded weights serves both. Where it departs from the program:

- every product, softmax and norm is float32 (the program runs bfloat16
  and, in TinyViT's window attention, a bfloat16 softmax);
- the decoder is run teacher-forced over the whole row at once (causal
  mask, keys at id 0 masked), where the program decodes one token at a
  time against a key/value cache; :meth:`Student.greedy` decodes by
  recomputing the row;
- the BatchNorm running statistics are not updated in train mode (no
  comparison reads them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import (Precision, attention, clip_preprocess, drop,
                     drop_path, gelu, layer_norm, sinusoid_table)

Params = Dict[str, torch.Tensor]


def bias_index(window: int) -> torch.Tensor:
    """(query, key) → the slot of their |offset| in first-seen order."""
    points = [(i, j) for i in range(window) for j in range(window)]
    slots: Dict[Tuple[int, int], int] = {}
    out = np.zeros((len(points), len(points)), np.int64)
    for qi, (qx, qy) in enumerate(points):
        for ki, (kx, ky) in enumerate(points):
            off = (abs(qx - kx), abs(qy - ky))
            out[qi, ki] = slots.setdefault(off, len(slots))
    return torch.from_numpy(out)


def _conv_bn(spec, name, cin, cout, k, groups=1):
    spec.append((f"{name}.conv.weight", (cout, cin // groups, k, k)))
    spec.append((f"{name}.bn.weight", (cout,)))
    spec.append((f"{name}.bn.bias", (cout,)))


def _linear(spec, name, cin, cout):
    spec.append((f"{name}.weight", (cout, cin)))
    spec.append((f"{name}.bias", (cout,)))


def _norm(spec, name, width):
    spec.append((f"{name}.weight", (width,)))
    spec.append((f"{name}.bias", (width,)))


def stage_maps(enc: dict) -> List[int]:
    return [enc["input_size"] // 4 // (2 ** s) for s in range(4)]


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the student described by
    ``cfg`` (the benchmark's configuration file), in a fixed order."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    dims, depths = enc["embed_dims"], enc["depths"]
    heads, windows = enc["num_heads"], enc["window_sizes"]
    maps = stage_maps(enc)
    p = "image_encoder.model"
    spec: List[Tuple[str, Tuple[int, ...]]] = []
    _conv_bn(spec, f"{p}.patch_embed.conv1", 3, dims[0] // 2, 3)
    _conv_bn(spec, f"{p}.patch_embed.conv2", dims[0] // 2, dims[0], 3)
    hid = int(dims[0] * enc["mbconv_expand_ratio"])
    for b in range(depths[0]):
        n = f"{p}.stages.0.blocks.{b}"
        _conv_bn(spec, f"{n}.conv1", dims[0], hid, 1)
        _conv_bn(spec, f"{n}.conv2", hid, hid, 3, groups=hid)
        _conv_bn(spec, f"{n}.conv3", hid, dims[0], 1)
    for s in range(1, 4):
        c, cin = dims[s], dims[s - 1]
        n = f"{p}.stages.{s}.downsample"
        _conv_bn(spec, f"{n}.conv1", cin, c, 1)
        _conv_bn(spec, f"{n}.conv2", c, c, 3, groups=c)
        _conv_bn(spec, f"{n}.conv3", c, c, 1)
        win = min(windows[s], maps[s])
        slots = int(bias_index(win).max()) + 1
        for b in range(depths[s]):
            n = f"{p}.stages.{s}.blocks.{b}"
            spec.append((f"{n}.attn.attention_biases", (heads[s], slots)))
            _norm(spec, f"{n}.attn.norm", c)
            _linear(spec, f"{n}.attn.qkv", c, 3 * c)
            _linear(spec, f"{n}.attn.proj", c, c)
            _conv_bn(spec, f"{n}.local_conv", c, c, 3, groups=c)
            _norm(spec, f"{n}.mlp.norm", c)
            _linear(spec, f"{n}.mlp.fc1", c, int(c * enc["mlp_ratio"]))
            _linear(spec, f"{n}.mlp.fc2", int(c * enc["mlp_ratio"]), c)
    d, ffn = dec["d_model"], dec["d_ffn"]
    for i in range(dec["num_decoder_layers"]):
        n = f"decoder.layers.{i}"
        for att in ("self_attn", "multihead_attn"):
            spec.append((f"{n}.{att}.in_proj_weight", (3 * d, d)))
            spec.append((f"{n}.{att}.in_proj_bias", (3 * d,)))
            _linear(spec, f"{n}.{att}.out_proj", d, d)
        _linear(spec, f"{n}.linear1", d, ffn)
        _linear(spec, f"{n}.linear2", ffn, d)
        for k in (1, 2, 3):
            _norm(spec, f"{n}.norm{k}", d)
    spec.append(("embed.weight", (dec["vocab_size"], d)))
    _linear(spec, "linear", d, dec["vocab_size"])
    heads_cfg = cfg["distill_heads"]
    for s, c in enumerate(dims):
        _linear(spec, f"projectors.{s}", c, heads_cfg["teacher_visual_dim"])
    _linear(spec, "upsample", cfg["num_frames"],
            heads_cfg["teacher_num_tokens"])
    _linear(spec, "project", d, heads_cfg["teacher_visual_dim"])
    _linear(spec, "project_decoder", d, heads_cfg["teacher_hidden"])
    return spec


class Student:
    """The student's arithmetic over a dict of float32 parameters (which
    may require grad) and BatchNorm running statistics. ``train`` switches BatchNorm to batch statistics
    and turns on DropPath and dropout, drawn from the CPU generator passed
    to :meth:`encode` and :meth:`decoder_logits`."""

    def __init__(self, cfg: dict, params: Params,
                 precision: Precision = Precision()):
        self.cfg = cfg
        self.p = params
        self.prec = precision
        self.train = False
        enc = cfg["encoder"]
        dev = next(iter(params.values())).device
        maps = stage_maps(enc)
        self.windows = [min(w, m) for w, m in zip(enc["window_sizes"], maps)]
        self.index = {w: bias_index(w).to(dev) for w in set(self.windows)}
        total = sum(enc["depths"])
        self.rates = [float(r) for r in
                      np.linspace(0, enc["drop_path_rate"], total)]
        dec = cfg["decoder"]
        self.pe = torch.from_numpy(sinusoid_table(dec["max_pos_len"],
                                                  dec["d_model"])).to(dev)

    # ---- TinyViT ----------------------------------------------------------
    def _bn(self, name, x):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.train:
            return F.batch_norm(x, None, None, w, b, True, 0.0, 1e-5)
        return F.batch_norm(x, self.p[f"{name}.running_mean"],
                            self.p[f"{name}.running_var"], w, b, False, 0.0,
                            1e-5)

    def _conv_bn(self, name, x, stride=1, groups=1):
        w = self.p[f"{name}.conv.weight"]
        k = w.shape[-1]
        y = self.prec.conv2d(x, w, stride, k // 2, groups)
        return self._bn(f"{name}.bn", y)

    def _gelu(self, x):
        return gelu(x, self.cfg["encoder"]["gelu_approximate"])

    def _linear(self, name, x):
        return self.prec.linear(x, self.p[f"{name}.weight"],
                                self.p[f"{name}.bias"])

    def _norm(self, name, x, eps=1e-5):
        return layer_norm(x, self.p[f"{name}.weight"],
                          self.p[f"{name}.bias"], eps)

    def _mbconv(self, n, x, rate, gen):
        short = x
        hid = self.p[f"{n}.conv2.conv.weight"].shape[0]
        x = self._gelu(self._conv_bn(f"{n}.conv1", x))
        x = self._gelu(self._conv_bn(f"{n}.conv2", x, groups=hid))
        x = self._conv_bn(f"{n}.conv3", x)
        if self.train:
            x = drop_path(x, rate, gen)
        return self._gelu(short + x)

    def _merge(self, n, x):
        c = self.p[f"{n}.conv2.conv.weight"].shape[0]
        x = self._gelu(self._conv_bn(f"{n}.conv1", x))
        x = self._gelu(self._conv_bn(f"{n}.conv2", x, stride=2, groups=c))
        return self._conv_bn(f"{n}.conv3", x)

    def _window_attention(self, n, xw, heads, win):
        bw, t, c = xw.shape
        kd = c // heads
        qkv = self._linear(f"{n}.qkv", self._norm(f"{n}.norm", xw))
        q, k, v = qkv.view(bw, t, heads, 3, kd).permute(3, 0, 2, 1, 4)
        bias = self.p[f"{n}.attention_biases"][:, self.index[win]]
        out = attention(self.prec, q, k, v, scale=kd ** -0.5, bias=bias)
        return self._linear(f"{n}.proj", out.permute(0, 2, 1, 3)
                            .reshape(bw, t, c))

    def _block(self, n, x, heads, win, rate, gen):
        b, c, h, w = x.shape
        short = x
        ph, pw = (win - h % win) % win, (win - w % win) % win
        xp = F.pad(x, (0, pw, 0, ph))
        hh, ww = h + ph, w + pw
        xw = xp.view(b, c, hh // win, win, ww // win, win)
        xw = xw.permute(0, 2, 4, 3, 5, 1).reshape(-1, win * win, c)
        aw = self._window_attention(f"{n}.attn", xw, heads, win)
        aw = aw.view(b, hh // win, ww // win, win, win, c)
        aw = aw.permute(0, 5, 1, 3, 2, 4).reshape(b, c, hh, ww)
        aw = aw[:, :, :h, :w]
        if self.train:
            aw = drop_path(aw, rate, gen)
        x = self._conv_bn(f"{n}.local_conv", short + aw, groups=c)
        xt = x.flatten(2).transpose(1, 2)
        mlp_rate = self.cfg["encoder"]["dropout"] if self.train else 0.0
        m = self._gelu(self._linear(f"{n}.mlp.fc1",
                                    self._norm(f"{n}.mlp.norm", xt)))
        m = drop(self._linear(f"{n}.mlp.fc2", drop(m, mlp_rate, gen)),
                 mlp_rate, gen)
        if self.train:
            m = drop_path(m, rate, gen)
        xt = xt + m
        return xt.transpose(1, 2).reshape(b, c, h, w)

    def encoder_maps(self, images: torch.Tensor,
                     gen: Optional[torch.Generator] = None
                     ) -> List[torch.Tensor]:
        """Preprocessed ``[N, H, W, 3]`` → the four NCHW stage maps."""
        enc = self.cfg["encoder"]
        p = "image_encoder.model"
        x = images.permute(0, 3, 1, 2)
        x = self._conv_bn(f"{p}.patch_embed.conv1", x, stride=2)
        x = self._conv_bn(f"{p}.patch_embed.conv2", self._gelu(x), stride=2)
        rates = iter(self.rates)
        maps = []
        for b in range(enc["depths"][0]):
            x = self._mbconv(f"{p}.stages.0.blocks.{b}", x, next(rates), gen)
        maps.append(x)
        for s in range(1, 4):
            x = self._merge(f"{p}.stages.{s}.downsample", x)
            for b in range(enc["depths"][s]):
                x = self._block(f"{p}.stages.{s}.blocks.{b}", x,
                                enc["num_heads"][s], self.windows[s],
                                next(rates), gen)
            maps.append(x)
        return maps

    def encode(self, frames: torch.Tensor,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Preprocessed ``[B, F, H, W, 3]`` → memory ``[B, F, C]``."""
        b, f = frames.shape[:2]
        last = self.encoder_maps(frames.reshape((b * f,) + frames.shape[2:]),
                                 gen)[-1]
        return last.mean(dim=(2, 3)).reshape(b, f, -1)

    def encode_u8(self, windows_u8: torch.Tensor) -> torch.Tensor:
        """uint8 BGR windows ``[B, F, H, W, 3]`` → memory."""
        b, f = windows_u8.shape[:2]
        flat = windows_u8.reshape((b * f,) + windows_u8.shape[2:])
        crop = self.cfg["encoder"]["input_size"]
        pre = clip_preprocess(flat, crop)
        return self.encode(pre.reshape((b, f) + pre.shape[1:]))

    # ---- decoder ----------------------------------------------------------
    def _mha(self, n, xq, xkv, allowed, rate, gen):
        d = xq.shape[-1]
        heads = self.cfg["decoder"]["n_head"]
        w, bias = self.p[f"{n}.in_proj_weight"], self.p[f"{n}.in_proj_bias"]

        def proj(x, part):
            y = self.prec.linear(x, w[part * d:(part + 1) * d],
                                 bias[part * d:(part + 1) * d])
            return y.view(x.shape[0], x.shape[1], heads, -1).transpose(1, 2)

        out = attention(self.prec, proj(xq, 0), proj(xkv, 1), proj(xkv, 2),
                        allowed=allowed, dropout_rate=rate, generator=gen)
        out = out.transpose(1, 2).reshape(xq.shape)
        return self._linear(f"{n}.out_proj", out)

    def decoder_logits(self, tokens: torch.Tensor, memory: torch.Tensor,
                       gen: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """Teacher-forced ``tokens [B, L]`` → logits ``[B, L, V]``."""
        dec = self.cfg["decoder"]
        d = dec["d_model"]
        rate = dec["dropout"] if self.train else 0.0
        L = tokens.shape[1]
        x = (self.p["embed.weight"][tokens.long()] + self.pe[:L]) / math.sqrt(d)
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=x.device).tril()[None, None]
        allowed = causal & (tokens != 0)[:, None, None, :]
        for i in range(dec["num_decoder_layers"]):
            n = f"decoder.layers.{i}"
            sa = self._mha(f"{n}.self_attn", x, x, allowed, rate, gen)
            x = self._norm(f"{n}.norm1", x + drop(sa, rate, gen))
            ca = self._mha(f"{n}.multihead_attn", x, memory, None, rate, gen)
            x = self._norm(f"{n}.norm2", x + drop(ca, rate, gen))
            h = drop(F.relu(self._linear(f"{n}.linear1", x)), rate, gen)
            x = self._norm(f"{n}.norm3", x + drop(
                self._linear(f"{n}.linear2", h), rate, gen))
        return self._linear("linear", x)

    def greedy(self, memory: torch.Tensor, max_len: int) -> torch.Tensor:
        """Greedy rows ``[B, 1 + max_len]`` (CLS first) by recomputing
        the row at every step; stops when every row emits SEP at one step,
        zeros after."""
        dec = self.cfg["decoder"]
        b = memory.shape[0]
        rows = torch.zeros((b, 1 + max_len), dtype=torch.long,
                           device=memory.device)
        rows[:, 0] = dec["cls_token_id"]
        for i in range(max_len):
            logits = self.decoder_logits(rows[:, :i + 1], memory)[:, -1]
            rows[:, i + 1] = logits.argmax(-1)
            if bool((rows[:, i + 1] == dec["sep_token_id"]).all()):
                break
        return rows
