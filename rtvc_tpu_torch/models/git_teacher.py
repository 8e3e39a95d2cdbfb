"""GIT-Large teacher: CLIP ViT-L/14 frames + BERT-style joint text decoder,
frozen, inference only.

Counterpart of ``rtvc_tpu/models/git_teacher.py``:

- the frames of a window run through the CLIP tower as one batch, each
  frame's tokens get a learned temporal embedding, and the frames are
  concatenated into the visual prefix (6 × 257 = 1542 tokens);
- :class:`TextualHead`: visual projection (Linear + LayerNorm at ε 1e-5),
  BERT text embeddings, post-norm BERT layers (ε 1e-12, exact GELU) over
  the joint [visual; text] sequence with the prefix-causal mask, and the
  vocab projection of the text positions;
- :meth:`GITTeacher.forward_output_logits`: the teacher-forced logits, the
  visual features, every layer's hidden states and the encoder's CLS taps;
- ``init_cache`` / ``decode_step``: the visual-prefix KV cache of the beam
  search. Unlike JAX, ``decode_step`` writes the new key and value into the
  cache in place.

The module tree has the reference ``model.pt`` keys
(``image_encoder.*``, ``img_temperal_embedding.{i}`` in GIT's spelling,
``textual.visual_projection.{0,1}``, ``textual.embedding.{words,
positions, layer_norm}``, ``textual.transformer.encoder.layer.{i}.*`` with
separate ``attention.self.{query,key,value}``, ``textual.output``), so
``rtvc_tpu.models.convert.git_teacher_params_from_torch`` reads its state
dict as it is; each layer holds q|k|v packed in one Linear and saves it
under the three reference names. Kernels on a card: K4 for the joint
attention and the beam's visual prefill (the decode step's one-row
attention stays plain, as JAX asks with ``use_pallas=False``), K2 for every
norm, the CLIP tower's K5 and K6, and K7 for every Linear of a quantized
teacher.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, GITConfig, clip_vit_l14_config
from ..ops.attention import multi_head_attention
from ..ops.layernorm import FusedLayerNorm
from ..ops.quantization import quantize_teacher_
from .clip_vit import IMAGE_ENCODERS, CLIPViT
from .layers import save_under_reference_keys
from .student import random_init_ as _random_init_modules

Cache = Dict[str, torch.Tensor]


class BertLayer(nn.Module):
    """Post-norm BERT layer with joint prefix-causal self-attention."""

    def __init__(self, hidden: int, heads: int, ffn: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        save_under_reference_keys(self, "qkv", {
            leaf: [f"attention.self.{p}.{leaf}"
                   for p in ("query", "key", "value")]
            for leaf in ("weight", "bias")})
        self.attention = nn.ModuleDict({"output": nn.ModuleDict({
            "dense": nn.Linear(hidden, hidden),
            "LayerNorm": FusedLayerNorm(hidden, eps=1e-12)})})
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(hidden, ffn)})
        self.output = nn.ModuleDict({
            "dense": nn.Linear(ffn, hidden),
            "LayerNorm": FusedLayerNorm(hidden, eps=1e-12)})

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, l, _ = t.shape
        return t.view(b, l, self.heads, -1).transpose(1, 2)

    def _qkv(self, x: torch.Tensor):
        return map(self._heads, self.qkv(x).chunk(3, dim=-1))

    def _finish(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """Attention output ``ctx [B, H, L, hd]`` → the rest of the layer."""
        b, _, l, _ = ctx.shape
        att = self.attention["output"]
        h = att["dense"](ctx.transpose(1, 2).reshape(b, l, -1))
        x = att["LayerNorm"](x + h)
        out = self.output
        f = out["dense"](F.gelu(self.intermediate["dense"](x)))
        return out["LayerNorm"](x + f)

    def forward(self, x: torch.Tensor, *, prefix_len: int,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self._qkv(x)
        ctx = multi_head_attention(q, k, v, causal=True,
                                   prefix_len=prefix_len, kv_mask=kv_mask)
        return self._finish(x, ctx)

    def init_cache(self, visual: torch.Tensor, max_text: int) -> Cache:
        """The visual keys and values (length P), then ``max_text`` zero
        slots for text tokens."""
        _, k, v = self._qkv(visual)
        pad = torch.zeros(k.shape[:2] + (max_text, k.shape[3]),
                          dtype=k.dtype, device=k.device)
        return {"k": torch.cat([k, pad], dim=2),
                "v": torch.cat([v, pad], dim=2)}

    def decode_step(self, x: torch.Tensor, cache: Cache, text_index: int,
                    prefix_len: int) -> Tuple[torch.Tensor, Cache]:
        """``x [B, 1, hidden]``, the text token at ``text_index``; writes its
        key and value into ``cache`` in place."""
        q, k_new, v_new = self._qkv(x)
        slot = prefix_len + text_index
        cache["k"][:, :, slot] = k_new[:, :, 0]
        cache["v"][:, :, slot] = v_new[:, :, 0]
        valid = (torch.arange(cache["k"].shape[2], device=x.device)
                 <= slot)[None]
        ctx = multi_head_attention(q, cache["k"], cache["v"], kv_mask=valid,
                                   use_pallas=False)
        return self._finish(x, ctx), cache


class TextualHead(nn.Module):
    """GIT's TransformerDecoderTextualHead."""

    def __init__(self, cfg: GITConfig):
        super().__init__()
        hidden = cfg.hidden_size
        # visual_ln at torch's default ε 1e-5, unlike the BERT norms
        self.visual_projection = nn.ModuleList(
            [nn.Linear(cfg.visual_feature_size, hidden),
             FusedLayerNorm(hidden, eps=1e-5)])
        self.embedding = nn.ModuleDict({
            "words": nn.Embedding(cfg.vocab_size, hidden),
            "positions": nn.Embedding(cfg.max_caption_length, hidden),
            "layer_norm": FusedLayerNorm(hidden, eps=1e-12)})
        self.transformer = nn.ModuleDict({"encoder": nn.ModuleDict({
            "layer": nn.ModuleList(
                [BertLayer(hidden, cfg.attention_heads, cfg.feedforward_size)
                 for _ in range(cfg.num_layers)])})})
        self.output = nn.Linear(hidden, cfg.vocab_size)

    @property
    def layers(self) -> nn.ModuleList:
        return self.transformer["encoder"]["layer"]

    def project_visual(self, visual: torch.Tensor) -> torch.Tensor:
        proj, norm = self.visual_projection
        return norm(proj(visual))

    def embed_text(self, tokens: torch.Tensor, offset: int = 0
                   ) -> torch.Tensor:
        emb = self.embedding
        pos = torch.arange(tokens.shape[1], device=tokens.device) + offset
        x = emb["words"](tokens) + emb["positions"](pos)
        return emb["layer_norm"](x)

    def forward(self, visual: torch.Tensor, caption_tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Teacher-forced: ``visual [B, P, visual_feature_size]``,
        ``caption_tokens [B, T]`` → (logits ``[B, T, V]``, the hidden
        states ``[B, P + T, hidden]`` after each layer)."""
        vis = self.project_visual(visual)
        x = torch.cat([vis, self.embed_text(caption_tokens)], dim=1)
        p = vis.shape[1]
        hidden: List[torch.Tensor] = []
        for layer in self.layers:
            x = layer(x, prefix_len=p)
            hidden.append(x)
        return self.output(x[:, p:]), hidden

    def init_cache(self, visual: torch.Tensor, max_text: int) -> List[Cache]:
        """Per-layer visual keys and values: the visual prefix runs through
        the stack once (bidirectional within the prefix), so layer i's
        cache comes from layer i-1's hidden states."""
        x = self.project_visual(visual)
        caches: List[Cache] = []
        for layer in self.layers:
            caches.append(layer.init_cache(x, max_text))
            x = layer(x, prefix_len=x.shape[1])
        return caches

    def decode_step(self, token: torch.Tensor, text_index: int,
                    caches: List[Cache], prefix_len: int
                    ) -> Tuple[torch.Tensor, List[Cache]]:
        x = self.embed_text(token[:, None], offset=text_index)
        for layer, cache in zip(self.layers, caches):
            x, _ = layer.decode_step(x, cache, text_index, prefix_len)
        return self.output(x)[:, 0], caches


class GITTeacher(nn.Module):
    """The full teacher: CLIP image tower, temporal embeddings, textual
    head."""

    def __init__(self, config: GITConfig = GITConfig()):
        super().__init__()
        self.config = cfg = config
        self.image_encoder = CLIPViT(cfg.clip)
        self.img_temperal_embedding = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, 1, cfg.visual_feature_size))
             for _ in range(cfg.num_image_with_embedding)])
        self.textual = TextualHead(cfg)

    def encode_frames(self, frames: torch.Tensor,
                      block_indices: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``frames [B, F, H, W, 3]`` (or ``[B, F, 3, H, W]``) → (visual
        features ``[B, F·tokens, visual_feature_size]``, the CLS token
        ``[B, F, width]`` of each requested encoder block)."""
        if frames.shape[2] == 3 and frames.shape[-1] != 3:
            frames = frames.permute(0, 1, 3, 4, 2)
        b, f = frames.shape[:2]
        tokens, taps = self.image_encoder(
            frames.reshape((b * f,) + frames.shape[2:]), block_indices)
        tokens = tokens.view(b, f, tokens.shape[1], -1)
        visual = torch.cat([tokens[:, i] + self.img_temperal_embedding[i]
                            for i in range(f)], dim=1)
        cls_taps = [t.view(b, f, t.shape[1], -1)[:, :, 0] for t in taps]
        return visual, cls_taps

    def forward_output_logits(self, frames: torch.Tensor,
                              captions: torch.Tensor,
                              block_indices: Optional[Sequence[int]] = None):
        """Teacher-forced pass over the whole batch: (logits ``[B, T, V]``,
        visual ``[B, 1542, 1024]``, the decoder's hidden states, the
        encoder's CLS taps)."""
        visual, cls_taps = self.encode_frames(frames, block_indices)
        logits, hidden = self.textual(visual, captions)
        return logits, visual, hidden, cls_taps

    def forward(self, frames: torch.Tensor,
                captions: torch.Tensor) -> torch.Tensor:
        return self.forward_output_logits(frames, captions)[0]

    def encode_only(self, frames: torch.Tensor) -> torch.Tensor:
        return self.encode_frames(frames)[0]

    def init_cache(self, visual: torch.Tensor, max_text: int) -> List[Cache]:
        return self.textual.init_cache(visual, max_text)

    def decode_step(self, token: torch.Tensor, text_index: int,
                    caches: List[Cache], prefix_len: int
                    ) -> Tuple[torch.Tensor, List[Cache]]:
        return self.textual.decode_step(token, text_index, caches, prefix_len)


def _built(git: GITConfig) -> GITTeacher:
    """The teacher of ``git`` in its dtype, with the CLIP tower's Linears
    packed for K7 when ``git.clip.quantized`` and the textual head's when
    ``git.quantized``, as the two flags pick ``QuantDense`` in JAX (from
    the random initial weights: load a float checkpoint first and call
    :func:`quantize_teacher_variables` to pack real ones)."""
    model = GITTeacher(git).to(git.dtype)
    if git.clip.quantized:
        quantize_teacher_(model.image_encoder)
    if git.quantized:
        quantize_teacher_(model.textual)
    return model


def get_git_model(param: Dict[str, Any], dtype: torch.dtype = torch.float32,
                  quantized: bool = False) -> GITTeacher:
    """The reference's ``get_git_model`` factory: the image encoder from
    ``param['image_encoder_type']`` (CLIPViT_B_16 by default, as there) and
    the 768-wide, 6-layer, 12-head textual head; ``param`` is the teacher's
    parameter.yaml content."""
    encoder_type = param.get("image_encoder_type", "CLIPViT_B_16")
    clip = IMAGE_ENCODERS[encoder_type](
        image_size=param.get("test_crop_size", 224), dtype=dtype,
        quantized=quantized)
    return _built(GITConfig(
        visual_feature_size=param.get("visual_feature_size", 768),
        num_image_with_embedding=param.get("num_image_with_embedding", 6),
        clip=clip, dtype=dtype, quantized=quantized))


def quantize_teacher_variables(model: GITTeacher) -> GITTeacher:
    """A float teacher → its W8A8 form, in place (JAX's
    ``quantize_teacher_variables`` on the module instead of a param
    tree)."""
    return quantize_teacher_(model)


def teacher_from_config(cfg: Config) -> GITTeacher:
    """The teacher of a :class:`~rtvc_tpu_torch.config.Config`: CLIP
    ViT-L/14 and the configured textual head in ``cfg.dtype``, W8A8 with
    ``cfg.quantize_teacher``."""
    t = cfg.teacher
    return _built(GITConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        num_layers=t.num_layers, attention_heads=t.attention_heads,
        feedforward_size=t.feedforward_size,
        visual_feature_size=t.visual_feature_size,
        max_caption_length=t.max_caption_length,
        num_image_with_embedding=t.num_image_with_embedding,
        clip=clip_vit_l14_config(dtype=cfg.dtype,
                                 quantized=cfg.quantize_teacher),
        dtype=cfg.dtype, quantized=cfg.quantize_teacher))


@torch.no_grad()
def random_init_(model: GITTeacher, generator: torch.Generator
                 ) -> GITTeacher:
    """Fill a float teacher from ``generator``: the student's
    ``random_init_`` for every Linear, conv, embedding and norm (LeCun
    normal weights keep the 24-block residual stream within a few units),
    then the CLS, positional and temporal embeddings at N(0, width^-1/2)."""
    _random_init_modules(model, generator)
    for name, p in model.named_parameters():
        if name.endswith(("class_embedding", "positional_embedding")) or (
                name.startswith("img_temperal_embedding")):
            p.copy_(torch.randn(p.shape, generator=generator)
                    * p.shape[-1] ** -0.5)
    return model
