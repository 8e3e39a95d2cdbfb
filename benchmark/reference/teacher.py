"""Plain float32 reference of the frozen GIT-Large teacher: CLIP ViT-L/14
over every frame (patch convolution, class token, learned positions,
ln_pre, pre-norm blocks with QuickGELU, ln_post), a learned temporal
embedding added to each frame's tokens, and GIT's textual head (visual
projection and LayerNorm, BERT word and position embeddings, post-norm
BERT layers over [visual; text] with the prefix-causal mask, exact GELU,
the vocabulary projection of the text positions).

Written from the published models (OpenAI CLIP, microsoft
GenerativeImage2Text), with the parameter names and layouts of the
checkpoint the program loads (q|k|v packed in one matrix a layer). Where
it departs from the program: every product, softmax and norm is float32
(the program runs bfloat16, with the flash attention kernels); the
frames run in chunks, which changes no result.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Precision, attention, layer_norm, prefix_causal, quick_gelu

Params = Dict[str, torch.Tensor]


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the teacher in ``cfg``."""
    t = cfg["teacher"]
    c = t["clip"]
    w, grid = c["width"], c["image_size"] // c["patch_size"]
    h, ffn = t["hidden_size"], t["feedforward_size"]
    spec: List[Tuple[str, Tuple[int, ...]]] = [
        ("image_encoder.class_embedding", (w,)),
        ("image_encoder.positional_embedding", (grid * grid + 1, w)),
        ("image_encoder.conv1.weight", (w, 3, c["patch_size"],
                                        c["patch_size"])),
        ("image_encoder.ln_pre.weight", (w,)),
        ("image_encoder.ln_pre.bias", (w,)),
    ]
    for i in range(c["layers"]):
        n = f"image_encoder.transformer.resblocks.{i}"
        spec += [(f"{n}.ln_1.weight", (w,)), (f"{n}.ln_1.bias", (w,)),
                 (f"{n}.attn.qkv.weight", (3 * w, w)),
                 (f"{n}.attn.qkv.bias", (3 * w,)),
                 (f"{n}.attn.out_proj.weight", (w, w)),
                 (f"{n}.attn.out_proj.bias", (w,)),
                 (f"{n}.ln_2.weight", (w,)), (f"{n}.ln_2.bias", (w,)),
                 (f"{n}.mlp.c_fc.weight", (4 * w, w)),
                 (f"{n}.mlp.c_fc.bias", (4 * w,)),
                 (f"{n}.mlp.c_proj.weight", (w, 4 * w)),
                 (f"{n}.mlp.c_proj.bias", (w,))]
    spec += [("image_encoder.ln_post.weight", (w,)),
             ("image_encoder.ln_post.bias", (w,))]
    vf = t["visual_feature_size"]
    spec += [(f"img_temperal_embedding.{i}", (1, 1, vf))
             for i in range(t["num_image_with_embedding"])]
    spec += [("textual.visual_projection.0.weight", (h, vf)),
             ("textual.visual_projection.0.bias", (h,)),
             ("textual.visual_projection.1.weight", (h,)),
             ("textual.visual_projection.1.bias", (h,)),
             ("textual.embedding.words.weight", (t["vocab_size"], h)),
             ("textual.embedding.positions.weight",
              (t["max_caption_length"], h)),
             ("textual.embedding.layer_norm.weight", (h,)),
             ("textual.embedding.layer_norm.bias", (h,))]
    for i in range(t["num_layers"]):
        n = f"textual.transformer.encoder.layer.{i}"
        spec += [(f"{n}.qkv.weight", (3 * h, h)), (f"{n}.qkv.bias", (3 * h,)),
                 (f"{n}.attention.output.dense.weight", (h, h)),
                 (f"{n}.attention.output.dense.bias", (h,)),
                 (f"{n}.attention.output.LayerNorm.weight", (h,)),
                 (f"{n}.attention.output.LayerNorm.bias", (h,)),
                 (f"{n}.intermediate.dense.weight", (ffn, h)),
                 (f"{n}.intermediate.dense.bias", (ffn,)),
                 (f"{n}.output.dense.weight", (h, ffn)),
                 (f"{n}.output.dense.bias", (h,)),
                 (f"{n}.output.LayerNorm.weight", (h,)),
                 (f"{n}.output.LayerNorm.bias", (h,))]
    spec += [("textual.output.weight", (t["vocab_size"], h)),
             ("textual.output.bias", (t["vocab_size"],))]
    return spec


class Teacher:
    """The teacher's forward over a dict of float32 parameters."""

    def __init__(self, cfg: dict, params: Params,
                 precision: Precision = Precision(), frame_chunk: int = 16):
        self.cfg = cfg
        self.p = params
        self.prec = precision
        self.frame_chunk = frame_chunk

    def _linear(self, name, x):
        return self.prec.linear(x, self.p[f"{name}.weight"],
                                self.p[f"{name}.bias"])

    def _norm(self, name, x, eps):
        return layer_norm(x, self.p[f"{name}.weight"],
                          self.p[f"{name}.bias"], eps)

    def _clip(self, images: torch.Tensor) -> torch.Tensor:
        """Preprocessed ``[N, H, W, 3]`` → tokens ``[N, 1 + grid², W]``."""
        c = self.cfg["teacher"]["clip"]
        heads = c["heads"]
        x = self.prec.conv2d(images.permute(0, 3, 1, 2),
                             self.p["image_encoder.conv1.weight"],
                             stride=c["patch_size"])
        x = x.flatten(2).transpose(1, 2)
        cls = self.p["image_encoder.class_embedding"].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.p[
            "image_encoder.positional_embedding"]
        x = self._norm("image_encoder.ln_pre", x, 1e-5)
        n, length, w = x.shape
        for i in range(c["layers"]):
            pre = f"image_encoder.transformer.resblocks.{i}"
            h = self._norm(f"{pre}.ln_1", x, 1e-5)
            q, k, v = self._linear(f"{pre}.attn.qkv", h).view(
                n, length, 3, heads, -1).permute(2, 0, 3, 1, 4)
            a = attention(self.prec, q, k, v)
            a = a.transpose(1, 2).reshape(n, length, w)
            x = x + self._linear(f"{pre}.attn.out_proj", a)
            h = self._norm(f"{pre}.ln_2", x, 1e-5)
            x = x + self._linear(f"{pre}.mlp.c_proj", quick_gelu(
                self._linear(f"{pre}.mlp.c_fc", h)))
        return self._norm("image_encoder.ln_post", x, 1e-5)

    def visual(self, frames: torch.Tensor) -> torch.Tensor:
        """Preprocessed ``[B, F, H, W, 3]`` → ``[B, F·tokens, W]``."""
        b, f = frames.shape[:2]
        flat = frames.reshape((b * f,) + frames.shape[2:])
        tokens = torch.cat([self._clip(flat[i:i + self.frame_chunk])
                            for i in range(0, b * f, self.frame_chunk)])
        tokens = tokens.view(b, f, tokens.shape[1], -1)
        return torch.cat([tokens[:, i] + self.p[f"img_temperal_embedding.{i}"]
                          for i in range(f)], dim=1)

    def logits(self, frames: torch.Tensor,
               captions: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits ``[B, T, V]`` over ``captions [B, T]``."""
        t = self.cfg["teacher"]
        heads = t["attention_heads"]
        vis = self._norm("textual.visual_projection.1", self._linear(
            "textual.visual_projection.0", self.visual(frames)), 1e-5)
        tlen = captions.shape[1]
        pos = torch.arange(tlen, device=captions.device)
        emb = (self.p["textual.embedding.words.weight"][captions.long()]
               + self.p["textual.embedding.positions.weight"][pos])
        text = self._norm("textual.embedding.layer_norm", emb, 1e-12)
        x = torch.cat([vis, text], dim=1)
        b, length, hid = x.shape
        prefix = vis.shape[1]
        allowed = prefix_causal(length, length, prefix, x.device)
        for i in range(t["num_layers"]):
            pre = f"textual.transformer.encoder.layer.{i}"
            q, k, v = (y.view(b, length, heads, -1).transpose(1, 2) for y in
                       self._linear(f"{pre}.qkv", x).chunk(3, dim=-1))
            ctx = attention(self.prec, q, k, v, allowed=allowed)
            ctx = ctx.transpose(1, 2).reshape(b, length, hid)
            x = self._norm(f"{pre}.attention.output.LayerNorm",
                           x + self._linear(f"{pre}.attention.output.dense",
                                            ctx), 1e-12)
            f = self._linear(f"{pre}.output.dense", F.gelu(self._linear(
                f"{pre}.intermediate.dense", x)))
            x = self._norm(f"{pre}.output.LayerNorm", x + f, 1e-12)
        return self._linear("textual.output", x[:, prefix:])
