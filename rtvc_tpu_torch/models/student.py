"""StudentCandidateV1: TinyViT frame encoder + Transformer caption decoder.

Counterpart of ``rtvc_tpu/models/student.py``. The module
tree has the reference's state-dict keys (``image_encoder.model.*`` in
timm's layout, ``decoder.layers.{i}.{self_attn, multihead_attn, linear1,
linear2, norm1, norm2, norm3}``, ``embed``, ``linear``, ``projectors.{i}``,
``upsample``, ``project``, ``project_decoder``), so
``rtvc_tpu.models.convert.student_params_from_torch`` reads its state dict
as it is and :mod:`.convert` goes the other way.

Kept from the reference and the JAX model:

- the embedded sequence is divided by √d_model after the positional
  encoding is added;
- the decoder layer is post-norm (``nn.TransformerDecoderLayer``
  semantics: self-attn → add+LN → cross-attn → add+LN → ReLU FFN →
  add+LN), its norms on kernel K2;
- :meth:`StudentCandidateV1.forward_image_enc` on the card in eval mode
  with grad off replays one CUDA graph of the encoder per input shape
  (:mod:`.encode_graph`);
- :meth:`StudentCandidateV1.decode_step` runs one token against a KV cache
  preallocated by :meth:`~StudentCandidateV1.init_cache`; unlike JAX it
  writes the new key and value into the cache in place. With ``vocab_w8``
  the vocab projection runs on kernel K3. :meth:`~StudentCandidateV1.
  decode_caches` gives a caption its caches; on the card in eval mode
  they belong to a workspace whose steps replay one CUDA graph a
  position (:mod:`.decode_graph`).

The distillation heads are built (their weights travel with a checkpoint)
but the caption step never calls them; ``distill_forward`` returns what
the train step's losses need. In train mode
(``.train()``) the decoder applies dropout as the reference's
``nn.TransformerDecoderLayer`` does (attention probabilities, the three
residual branches, the FFN's hidden layer) and the encoder its DropPath and
flax BatchNorm, all drawing from the CPU ``torch.Generator`` passed in.

``remat_encoder`` (JAX's ``nn.remat`` of TinyViT) runs the train-mode
encoder under ``torch.utils.checkpoint``: its activations are recomputed in
the backward instead of kept (:func:`checkpointed_encoder`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..config import Config, TinyViTConfig, tiny_vit_21m_config
from ..ops.attention import multi_head_attention
from ..ops.dropout import dropout
from ..ops.int8_gemm import w8_dense
from ..ops.layernorm import FusedLayerNorm
from .decode_graph import DecodeGraphs
from .encode_graph import EncodeGraphs
from .layers import PositionalEncoding
from .tinyvit import BatchNorm2d, TinyViT, stage_means

Cache = Dict[str, torch.Tensor]


@contextlib.contextmanager
def _running_stat_updates(module: nn.Module, on: bool):
    """Let (or keep) ``module``'s BatchNorms update their running
    statistics inside the block."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_running_stats = on
    try:
        yield
    finally:
        for m in norms:
            m.update_running_stats = True


def checkpointed_encoder(encoder: TinyViT, x: torch.Tensor,
                         generator: Optional[torch.Generator]
                         ) -> List[torch.Tensor]:
    """``encoder(x, generator)`` under ``torch.utils.checkpoint``, with the
    results, gradients and side effects of the plain call. The backward's
    recompute must see the forward's random bits and must not count the
    batch twice: every run starts from a copy of ``generator``'s state at
    the call (``torch.utils.checkpoint`` stashes only the global RNGs), and
    only the first run updates the BatchNorm running statistics. After the
    call ``generator`` stands where the plain call leaves it."""
    start = generator.get_state() if generator is not None else None
    end: List[Optional[torch.Tensor]] = []

    def run(inp: torch.Tensor):
        gen = None
        if start is not None:
            gen = torch.Generator()
            gen.set_state(start)
        first = not end
        with _running_stat_updates(encoder, first):
            out = encoder(inp, gen)
        if first:
            end.append(gen.get_state() if gen is not None else None)
        return tuple(out)

    out = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                            preserve_rng_state=False)
    if generator is not None:
        generator.set_state(end[0])
    return list(out)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj_weight``
    [3D, D] in q|k|v order, ``in_proj_bias``, ``out_proj``) around
    :func:`ops.attention.multi_head_attention`."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.d_model = d_model
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.view(b, l, self.n_head, -1).transpose(1, 2)

    def _merge_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        d = self.d_model
        w = self.in_proj_weight[part * d:(part + 1) * d]
        b = self.in_proj_bias[part * d:(part + 1) * d]
        return self._split_heads(F.linear(x, w, b))

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self._proj(x, 0)

    def project_kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._proj(x, 1), self._proj(x, 2)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = False,
               kv_mask: Optional[torch.Tensor] = None,
               dropout_rate: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Heads ``q/k/v [B, H, L, hd]`` → ``out_proj`` of the merged output."""
        out = multi_head_attention(q, k, v, causal=causal, kv_mask=kv_mask,
                                   dropout_rate=dropout_rate,
                                   generator=generator)
        return self.out_proj(self._merge_heads(out))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, *,
                causal: bool = False,
                kv_mask: Optional[torch.Tensor] = None,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        k, v = self.project_kv(kv_in)
        return self.attend(self.project_q(q_in), k, v, causal=causal,
                           kv_mask=kv_mask, dropout_rate=dropout_rate,
                           generator=generator)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer, ``nn.TransformerDecoderLayer`` semantics
    (batch-first, ReLU, eps 1e-5, ``dropout`` in train mode) and parameter
    names."""

    def __init__(self, d_model: int, n_head: int, d_ffn: int,
                 dropout: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, n_head)
        self.multihead_attn = MultiheadAttention(d_model, n_head)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm1 = FusedLayerNorm(d_model)
        self.norm2 = FusedLayerNorm(d_model)
        self.norm3 = FusedLayerNorm(d_model)

    def _ffn(self, x: torch.Tensor, rate: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.relu(self.linear1(x)), rate, generator)
        return self.linear2(h)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, *,
                tgt_kv_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        kw = dict(dropout_rate=rate, generator=generator)
        sa = self.self_attn(x, x, causal=True, kv_mask=tgt_kv_mask, **kw)
        x = self.norm1(x + dropout(sa, rate, generator))
        ca = self.multihead_attn(x, memory, **kw)
        x = self.norm2(x + dropout(ca, rate, generator))
        return self.norm3(x + dropout(self._ffn(x, rate, generator), rate,
                                      generator))

    def init_cache(self, batch: int, max_len: int,
                   memory: torch.Tensor) -> Cache:
        mem_k, mem_v = self.multihead_attn.project_kv(memory)
        head_dim = memory.shape[-1] // self.n_head
        zeros = torch.zeros((batch, self.n_head, max_len, head_dim),
                            dtype=memory.dtype, device=memory.device)
        return {"k": zeros, "v": torch.zeros_like(zeros),
                "mem_k": mem_k, "mem_v": mem_v}

    def decode_step(self, x: torch.Tensor, cache: Cache, index: int,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [B, 1, D]`` at position ``index``; writes this token's key and
        value into ``cache`` in place. ``kv_mask [B, max_len]`` marks the
        cache slots to attend (default: slots ``<= index``)."""
        sa = self.self_attn
        q = sa.project_q(x)
        k_new, v_new = sa.project_kv(x)
        cache["k"][:, :, index] = k_new[:, :, 0]
        cache["v"][:, :, index] = v_new[:, :, 0]
        if kv_mask is None:
            max_len = cache["k"].shape[2]
            kv_mask = (torch.arange(max_len, device=x.device) <= index)[None]
        x = self.norm1(x + sa.attend(q, cache["k"], cache["v"],
                                     kv_mask=kv_mask))
        ca = self.multihead_attn
        x = self.norm2(x + ca.attend(ca.project_q(x), cache["mem_k"],
                                     cache["mem_v"]))
        return self.norm3(x + self._ffn(x))


class StudentCandidateV1(nn.Module):
    """TinyViT-21M frame encoder + N-layer caption decoder."""

    def __init__(self, d_model: int = 576, n_head: int = 8,
                 d_ffn: int = 1024, dropout: float = 0.3,
                 num_decoder_layers: int = 2,
                 vocab_size: int = 30522, cls_token_id: int = 101,
                 sep_token_id: int = 102, max_pos_len: int = 500,
                 encoder_config: TinyViTConfig = tiny_vit_21m_config(),
                 input_size: int = 224, num_frames: int = 6,
                 teacher_visual_dim: int = 1024,
                 teacher_num_tokens: int = 1542, teacher_hidden: int = 768,
                 remat_encoder: bool = False):
        super().__init__()
        self.remat_encoder = remat_encoder
        self.d_model = d_model
        self.vocab_size = vocab_size
        self.cls_token_id = cls_token_id
        self.sep_token_id = sep_token_id
        # the reference's prefixes: image_encoder.model.*, decoder.layers.*
        self.image_encoder = nn.ModuleDict(
            {"model": TinyViT(encoder_config, input_size)})
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            [TransformerDecoderLayer(d_model, n_head, d_ffn, dropout)
             for _ in range(num_decoder_layers)])})
        self.embed = nn.Embedding(vocab_size, d_model)
        self.linear = nn.Linear(d_model, vocab_size)
        self.pos_enc = PositionalEncoding(d_model, max_pos_len)
        # distillation heads (reference model.py:87-94)
        self.projectors = nn.ModuleList(
            [nn.Linear(c, teacher_visual_dim)
             for c in encoder_config.embed_dims])
        self.upsample = nn.Linear(num_frames, teacher_num_tokens)
        self.project = nn.Linear(d_model, teacher_visual_dim)
        self.project_decoder = nn.Linear(d_model, teacher_hidden)
        self.decode_graphs = DecodeGraphs()
        self.encode_graphs = EncodeGraphs()

    # ---- encoder ----------------------------------------------------------
    def forward_image_enc(self, x: torch.Tensor,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """``x [B, F, H, W, 3]`` (or ``[B, F, 3, H, W]``) → (four NHWC stage
        maps of the B·F frames, memory ``[B, F, C]``: the last map's
        spatial mean). On the card in eval mode with grad off the body
        replays one CUDA graph of the input's shape (:mod:`.encode_graph`);
        the outputs are the caller's either way."""
        if x.shape[2] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 1, 3, 4, 2)
        out = self.encode_graphs.run(self, x)
        if out is not None:
            return out
        self.encode_graphs.eager += 1
        return self.encode_body(x, generator)

    def encode_body(self, x: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """:meth:`forward_image_enc`'s arithmetic on NHWC frames ``x [B, F,
        H, W, 3]``, run eagerly or captured."""
        b, f = x.shape[:2]
        enc, flat = self.image_encoder["model"], x.reshape((b * f,)
                                                           + x.shape[2:])
        if self.remat_encoder and self.training and torch.is_grad_enabled():
            fmaps = checkpointed_encoder(enc, flat, generator)
        else:
            fmaps = enc(flat, generator)
        memory = stage_means(fmaps[-1:])[0].reshape(b, f, -1)
        return fmaps, memory

    # ---- decoder ----------------------------------------------------------
    def _embed_tokens(self, y: torch.Tensor, offset: int = 0) -> torch.Tensor:
        emb = self.pos_enc(self.embed(y), offset=offset)
        return emb / math.sqrt(self.d_model)  # after the PE add (reference)

    def forward_decoder(self, y: torch.Tensor, memory: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        return_hidden: bool = False):
        """Teacher-forced decode of ``y [B, L]`` → logits ``[B, L, V]``
        (and each layer's output with ``return_hidden``); keys at pad id 0
        are masked."""
        x = self._embed_tokens(y)
        hidden: List[torch.Tensor] = []
        for layer in self.decoder["layers"]:
            x = layer(x, memory, tgt_kv_mask=y != 0, generator=generator)
            hidden.append(x)
        logits = self.linear(x)
        return (logits, hidden) if return_hidden else logits

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        fmaps, memory = self.forward_image_enc(x, generator)
        return fmaps + [self.forward_decoder(y, memory, generator)]

    def distill_forward(self, x: torch.Tensor, y: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None,
                        need_fmap: bool = False, need_visual: bool = False,
                        need_decoder: bool = False) -> Dict[str, Any]:
        """The train step's forward: ``logits`` and ``memory``, plus the
        projected stage means (``proj_means``), the upsampled memory
        (``student_visual``) and the projected decoder states
        (``hidden_proj``) where the losses ask for them. Train or eval as
        the module is set; ``generator`` feeds dropout in train mode."""
        fmaps, memory = self.forward_image_enc(x, generator)
        logits, hidden = self.forward_decoder(y, memory, generator,
                                              return_hidden=True)
        out: Dict[str, Any] = {"logits": logits, "memory": memory}
        if need_fmap:
            out["proj_means"] = self.project_stage_means(fmaps)
        if need_visual:
            up = self.upsample(memory.transpose(1, 2))
            out["student_visual"] = self.project(up.transpose(1, 2))
        if need_decoder:
            out["hidden_proj"] = [self.project_decoder(h) for h in hidden]
        return out

    def project_stage_means(self, fmaps: List[torch.Tensor]
                            ) -> List[torch.Tensor]:
        """The four stage means projected to the teacher's width."""
        return [proj(m) for proj, m in zip(self.projectors,
                                           stage_means(fmaps))]

    # ---- incremental decode -------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   memory: torch.Tensor) -> List[Cache]:
        return [layer.init_cache(batch, max_len, memory)
                for layer in self.decoder["layers"]]

    def decode_caches(self, batch: int, max_len: int, memory: torch.Tensor,
                      vocab_w8: Optional[Dict[str, torch.Tensor]] = None):
        """Context manager: the caches of one caption, held until the block
        ends. On the card in eval mode they are a decode workspace's, whose
        positions :meth:`decode_step` replays as CUDA graphs; elsewhere
        ``init_cache``'s (:mod:`.decode_graph`)."""
        return self.decode_graphs.caches(self, batch, max_len, memory,
                                         vocab_w8)

    def decode_step(self, token: torch.Tensor, index: int,
                    caches: List[Cache],
                    kv_mask: Optional[torch.Tensor] = None,
                    vocab_w8: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, List[Cache]]:
        """``token [B]`` at position ``index`` → (logits ``[B, V]``, the
        caches, updated in place). ``vocab_w8`` (from
        :func:`ops.quantization.quantize_vocab_head`) sends the vocab
        projection through K3. On a decode workspace's caches the step
        replays the position's CUDA graph; the logits are the caller's
        either way, never overwritten by a later step."""
        ws = getattr(caches, "workspace", None)
        if ws is not None:
            logits = ws.replay(token, index, kv_mask, vocab_w8)
            if logits is not None:
                self.decode_graphs.replays += 1
                return logits, caches
        self.decode_graphs.eager += 1
        return self.decode_body(token, index, caches, kv_mask,
                                vocab_w8), caches

    def decode_body(self, token: torch.Tensor, index: int,
                    caches: List[Cache], kv_mask: Optional[torch.Tensor],
                    vocab_w8: Optional[Dict[str, torch.Tensor]]
                    ) -> torch.Tensor:
        """:meth:`decode_step`'s arithmetic, run eagerly or captured."""
        x = self._embed_tokens(token[:, None], offset=index)
        for layer, cache in zip(self.decoder["layers"], caches):
            x = layer.decode_step(x, cache, index, kv_mask=kv_mask)
        if vocab_w8 is not None:
            logits = w8_dense(x[:, 0], vocab_w8["wq"], vocab_w8["sw"],
                              vocab_w8["bias"])
            return logits[:, :self.vocab_size]
        return self.linear(x)[:, 0]


def student_from_config(cfg: Config, input_size: int = 224,
                        device="cuda") -> StudentCandidateV1:
    """Build the student of a :class:`~rtvc_tpu_torch.config.Config` on
    ``device`` (the card unless the caller asks for ``"cpu"``; float32
    parameters; cast with ``.to(cfg.dtype)``)."""
    s = cfg.student
    enc = tiny_vit_21m_config(gelu_approximate=s.gelu_approximate)
    return StudentCandidateV1(
        d_model=s.d_model, n_head=s.n_head, d_ffn=s.d_ffn, dropout=s.dropout,
        num_decoder_layers=s.num_decoder_layers, vocab_size=s.vocab_size,
        cls_token_id=s.cls_token_id, sep_token_id=s.sep_token_id,
        max_pos_len=s.max_pos_len, encoder_config=enc, input_size=input_size,
        num_frames=cfg.data.num_frames,
        teacher_visual_dim=cfg.teacher.visual_feature_size,
        teacher_num_tokens=cfg.teacher.num_image_with_embedding * 257,
        teacher_hidden=cfg.teacher.hidden_size,
        remat_encoder=cfg.remat_encoder).to(device)


def student_matching_checkpoint(cfg: Config, ckpt_path: str,
                                input_size: int = 224,
                                device="cuda") -> StudentCandidateV1:
    """:func:`student_from_config`, but the GELU variant recorded at save
    time (the checkpoint's ``.meta.json`` sidecar, ``data.io``) overrides
    the config: weights trained with the exact erf GELU must not run under
    the tanh default. Without a sidecar the config wins."""
    import dataclasses

    from ..data.io import checkpoint_meta

    g = checkpoint_meta(ckpt_path).get("gelu_approximate")
    if g is not None and bool(g) != cfg.student.gelu_approximate:
        cfg = dataclasses.replace(cfg, student=dataclasses.replace(
            cfg.student, gelu_approximate=bool(g)))
    return student_from_config(cfg, input_size=input_size, device=device)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BatchNorm statistic from ``generator``:
    LeCun-normal weights, zero biases, unit norms, small relative-position
    biases, unit-variance embeddings. Deterministic for a seeded CPU
    generator, whatever the module's device."""
    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            normal(mod.weight, fan_in ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 1.0)
        elif isinstance(mod, MultiheadAttention):
            normal(mod.in_proj_weight, mod.d_model ** -0.5)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (FusedLayerNorm, BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm2d):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        if hasattr(mod, "attention_biases"):
            normal(mod.attention_biases, 0.1)
    return model
