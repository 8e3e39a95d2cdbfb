"""Kimi-VL's language model: a DeepSeek-V3-style decoder with latent
attention (MLA) and sigmoid-routed experts.

Each layer is ``x + attn(rms(x))`` then ``x + mlp(rms(x))``; the first
``first_k_dense_replace`` layers have a dense SwiGLU MLP, the rest an
:class:`MoE`. RMSNorms are float32 over the row, scaled, then cast back.

**MLA** (:class:`LatentAttention`, no q latent). ``q = W_q x`` gives each
head a ``qk_nope`` part and a ``qk_rope`` part; ``kv_a_proj_with_mqa``
gives a ``kv_lora_rank``-wide latent ``c`` (then ``kv_a_layernorm``) and a
``qk_rope``-wide ``k_pe`` that every head shares; RoPE (θ =
``rope_theta``, adjacent pairs) turns ``k_pe`` and the queries' rope part
by the position; ``kv_b_proj`` expands ``c`` to each head's ``k_nope``
and ``v``. Scores are ``(q_nope·k_nope + q_pe·k_pe) / √(nope + rope)``,
causal. The **latent cache** of a layer holds ``[c, k_pe]`` a position,
``kv_lora_rank + qk_rope`` values (576).

- Prefill (:meth:`LatentAttention.prefill`) expands the cache to per-head
  keys and values and runs ``F.scaled_dot_product_attention`` causally,
  ``v`` zero-padded to the query width (192) so that the flash backend
  takes it; the output's pad is dropped.
- Decode (:meth:`LatentAttention.decode`) is the absorbed form: ``q_nope``
  through ``W_UK`` into the latent space, one product of ``[q_lat, q_pe]``
  with the cache's ``[c, k_pe]`` rows for the scores, ``P·c``, then
  ``W_UV``; it reads the cache and never expands it. The position is a
  device tensor and the scores span the whole cache, the slots past the
  position masked, so one CUDA graph of a layer serves every position
  (:class:`DecodeGraphs`).

**MoE** (:class:`MoE`): ``s = sigmoid(W_g x)`` in float32; the top
``num_experts_per_tok`` of ``s + e_score_correction_bias`` are chosen
(``noaux_tc``, one group), weighted by their raw ``s`` normalised to sum 1
(``norm_topk_prob``) times ``routed_scaling_factor``; every token is routed
(none dropped); the shared experts (one SwiGLU of ``n_shared ·
moe_intermediate`` width) are added for every token. The routed experts
(:class:`Experts`, stacked ``[E, out, in]`` weights) run one of two
ways: grouped (``torch._grouped_mm`` over the (token, expert) pairs
sorted by expert, offsets from a count on the device) on a card, or a
loop over the experts, which reads each expert's rows back to the host
(the CPU's path). The grouped path reads nothing back. ``load`` counts the
routed tokens of each expert on the device; ``last_route`` is the last
call's choice.

**Decode graphs** (:class:`DecodeGraphs`). Eager, a decode token issues
about 3,000 launches from Python, several times its device time. On a
card, for each batch size and cache, two CUDA graphs a layer are captured
at its first decode, the attention (replayed inside
``rtvc.vlm.mla_decode``) and the MLP (inside ``rtvc.vlm.experts`` where it
routes), reading and writing one static residual row and the position;
each later token replays them in order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import KimiVLConfig
from ..utils.profiling import span
from .layers import rotate_pairs


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight.float(),
                          self.eps).to(x.dtype)


def rope_angles(length: int, dim: int, theta: float, device=None
                ) -> torch.Tensor:
    """Float32 ``[length, dim / 2]``: position · θ^(-2j/dim) for pair j."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device).float()
                          / dim)
    return torch.arange(length, device=device).float()[:, None] * inv


class SwiGLU(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.gate_proj = nn.Linear(width, hidden, bias=False)
        self.up_proj = nn.Linear(width, hidden, bias=False)
        self.down_proj = nn.Linear(hidden, width, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LatentAttention(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.nope = cfg.qk_nope_head_dim
        self.rope = cfg.qk_rope_head_dim
        self.v_dim = cfg.v_head_dim
        self.rank = cfg.kv_lora_rank
        self.scale = (self.nope + self.rope) ** -0.5
        h = cfg.hidden_size
        self.q_proj = nn.Linear(h, self.heads * (self.nope + self.rope),
                                bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(h, self.rank + self.rope,
                                            bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(self.rank,
                                   self.heads * (self.nope + self.v_dim),
                                   bias=False)
        self.o_proj = nn.Linear(self.heads * self.v_dim, h, bias=False)

    def _queries(self, x, cos, sin):
        q = self.q_proj(x).unflatten(-1, (self.heads, -1))
        return q[..., :self.nope], rotate_pairs(q[..., self.nope:], cos, sin)

    def _latent(self, x, cos, sin) -> torch.Tensor:
        """``[..., rank + rope]``: ``kv_a_layernorm(c)`` and the turned
        ``k_pe``, as the cache holds them."""
        ckv = self.kv_a_proj_with_mqa(x)
        c = self.kv_a_layernorm(ckv[..., :self.rank])
        k_pe = rotate_pairs(ckv[..., self.rank:], cos[..., 0, :],
                            sin[..., 0, :])
        return torch.cat((c, k_pe), dim=-1)

    def prefill(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: torch.Tensor) -> torch.Tensor:
        """``x [B, L, h]`` at positions 0..L-1 (``cos``/``sin`` ``[L, 1,
        rope/2]``) → ``[B, L, h]``; writes ``cache[:, :L]``."""
        b, length, _ = x.shape
        q_nope, q_pe = self._queries(x, cos, sin)
        lat = self._latent(x, cos, sin)
        cache[:, :length] = lat
        kv = self.kv_b_proj(lat[..., :self.rank]).unflatten(
            -1, (self.heads, -1))
        k = torch.cat((kv[..., :self.nope], lat[..., None, self.rank:]
                       .expand(-1, -1, self.heads, -1)), dim=-1)
        q = torch.cat((q_nope, q_pe), dim=-1)
        v = F.pad(kv[..., self.nope:], (0, q.shape[-1] - self.v_dim))
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=self.scale)
        o = o[..., :self.v_dim].transpose(1, 2).reshape(b, length, -1)
        return self.o_proj(o)

    def decode(self, x: torch.Tensor, angles: torch.Tensor,
               cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One position: ``x [B, h]`` at ``pos`` (a long tensor ``[1]``;
        ``angles`` every slot's) → ``[B, h]``; writes ``cache[:, pos]`` and
        attends, in the absorbed form, over the cache's slots up to
        ``pos``."""
        with span("rtvc.vlm.mla_decode"):
            b = x.shape[0]
            ang = angles.index_select(0, pos)
            cos, sin = ang.cos(), ang.sin()
            q_nope, q_pe = self._queries(x, cos, sin)
            cache.index_copy_(1, pos, self._latent(x, cos, sin)[:, None])
            w = self.kv_b_proj.weight.view(self.heads, self.nope + self.v_dim,
                                           self.rank)
            q_lat = torch.einsum("bhd,hdc->bhc", q_nope, w[:, :self.nope])
            s = torch.bmm(torch.cat((q_lat, q_pe), dim=-1),
                          cache.transpose(1, 2)).float() * self.scale
            later = torch.arange(cache.shape[1], device=pos.device) > pos
            p = torch.softmax(s.masked_fill(later, float("-inf")),
                              dim=-1).to(x.dtype)
            o_lat = torch.bmm(p, cache[..., :self.rank])
            o = torch.einsum("bhc,hdc->bhd", o_lat, w[:, self.nope:])
            return self.o_proj(o.reshape(b, -1))


class Router(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.top_k = cfg.num_experts_per_tok
        self.norm = cfg.norm_topk_prob
        self.scaling = cfg.routed_scaling_factor
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                               cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(
            torch.empty(cfg.n_routed_experts))

    def forward(self, x: torch.Tensor):
        """``x [N, h]`` → (experts ``[N, k]`` int64, weights ``[N, k]``
        float32)."""
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        choice = scores + self.e_score_correction_bias.float()
        idx = torch.topk(choice, self.top_k, dim=-1).indices
        w = scores.gather(1, idx)
        if self.norm:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * self.scaling


class Experts(nn.Module):
    """``E`` SwiGLU experts, stacked ``[E, out, in]``."""

    def __init__(self, experts: int, width: int, hidden: int):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(experts, hidden, width))
        self.up_proj = nn.Parameter(torch.empty(experts, hidden, width))
        self.down_proj = nn.Parameter(torch.empty(experts, width, hidden))

    def grouped(self, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
        """Every (token, expert) pair through its expert with
        ``torch._grouped_mm``: the pairs sorted by expert, ``counts`` the
        pairs an expert; nothing read back."""
        n, k = idx.shape
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        offs = counts.cumsum(0).to(torch.int32)
        xs = x.index_select(0, order // k)
        gate = torch._grouped_mm(xs, self.gate_proj.transpose(1, 2),
                                 offs=offs)
        up = torch._grouped_mm(xs, self.up_proj.transpose(1, 2), offs=offs)
        y = torch._grouped_mm(F.silu(gate) * up,
                              self.down_proj.transpose(1, 2), offs=offs)
        back = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        y = y.index_select(0, back).view(n, k, -1)
        return (y.float() * w[..., None]).sum(dim=1).to(x.dtype)

    def looped(self, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
        """The same, an expert at a time (each expert's rows read back)."""
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for e in range(self.gate_proj.shape[0]):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            h = F.silu(xe @ self.gate_proj[e].T) * (xe @ self.up_proj[e].T)
            out.index_add_(0, rows, (h @ self.down_proj[e].T).float()
                           * w[rows, slot, None])
        return out.to(x.dtype)


class MoE(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        if cfg.n_group != 1 or cfg.topk_group != 1:
            raise NotImplementedError("group-limited routing (n_group > 1)")
        h, e = cfg.hidden_size, cfg.n_routed_experts
        self.gate = Router(cfg)
        self.experts = Experts(e, h, cfg.moe_intermediate_size)
        self.shared_experts = SwiGLU(
            h, cfg.moe_intermediate_size * cfg.n_shared_experts)
        self.register_buffer("load", torch.zeros(e, dtype=torch.int64),
                             persistent=False)
        self.last_route: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [..., h]`` → ``[..., h]``."""
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        idx, w = self.gate(x)
        counts = torch.zeros_like(self.load).scatter_add_(
            0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
        self.load += counts
        self.last_route = idx
        with span("rtvc.vlm.experts"):
            routed = (self.experts.grouped(x, idx, w, counts) if x.is_cuda
                      else self.experts.looped(x, idx, w))
        return (routed + self.shared_experts(x)).reshape(shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiVLConfig, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LatentAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size)
                    if index < cfg.first_k_dense_replace else MoE(cfg))

    def prefill(self, x, cos, sin, cache):
        x = x + self.self_attn.prefill(self.input_layernorm(x), cos, sin,
                                       cache)
        return x + self.mlp(self.post_attention_layernorm(x))

    def attend(self, x, angles, cache, pos):
        return x + self.self_attn.decode(self.input_layernorm(x), angles,
                                         cache, pos)

    def feed(self, x):
        return x + self.mlp(self.post_attention_layernorm(x))


class KimiLM(nn.Module):
    """The decoder stack with its untied embedding and output head."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def moe_layers(self) -> List[MoE]:
        return [layer.mlp for layer in self.layers
                if isinstance(layer.mlp, MoE)]

    def latent_caches(self, batch: int, slots: int, device, dtype
                      ) -> List[torch.Tensor]:
        width = self.cfg.kv_lora_rank + self.cfg.qk_rope_head_dim
        # zeros: a decode's masked slots still enter P·c, with weight 0
        return [torch.zeros((batch, slots, width), device=device,
                            dtype=dtype) for _ in self.layers]

    def angles(self, length: int, device) -> torch.Tensor:
        return rope_angles(length, self.cfg.qk_rope_head_dim,
                           self.cfg.rope_theta, device)

    def prefill(self, x: torch.Tensor, caches: List[torch.Tensor],
                angles: torch.Tensor) -> torch.Tensor:
        """Embedded inputs ``[B, L, h]`` → the last position's logits
        ``[B, V]``; fills ``caches[:, :L]``."""
        ang = angles[:x.shape[1], None]
        cos, sin = ang.cos(), ang.sin()
        for layer, cache in zip(self.layers, caches):
            x = layer.prefill(x, cos, sin, cache)
        return self.lm_head(self.norm(x[:, -1]))

    def decode_step(self, token: torch.Tensor, pos: torch.Tensor,
                    caches: List[torch.Tensor], angles: torch.Tensor,
                    graphs: Optional["DecodeGraphs"] = None
                    ) -> torch.Tensor:
        """Tokens ``[B]`` at ``pos`` (a long tensor ``[1]``) → logits ``[B,
        V]``: the layers eager, or ``graphs`` replayed."""
        x = self.embed_tokens(token)
        if graphs is not None:
            x = graphs.run(x, pos)
        else:
            for layer, cache in zip(self.layers, caches):
                x = layer.feed(layer.attend(x, angles, cache, pos))
        return self.lm_head(self.norm(x))


class DecodeGraphs:
    """The decode layers of one batch size and one set of latent caches as
    CUDA graphs: per layer one of the attention and one of the MLP, in one
    private memory pool, over a static residual row ``x`` and position
    ``pos``. :meth:`run` copies a step's row and position in and replays
    them in order inside ``rtvc.decode.graph`` (the student's span of a
    graphed position, ``models/decode_graph.py``), the attention inside
    ``rtvc.vlm.mla_decode`` and a MoE layer's MLP inside
    ``rtvc.vlm.experts``, as the eager body's spans.

    The graphs read their weights, the caches and the RoPE table at the
    addresses they had at capture (the captioner drops them when a
    parameter moves). Capture is preceded by one eager pass on a
    side stream, at the cache's last slot (written again before any decode
    reads it), whose routed-token counts are taken back. ``routes`` holds
    each MoE layer's choice of the last replay."""

    def __init__(self, lm: KimiLM, caches: List[torch.Tensor],
                 angles: torch.Tensor):
        ref = caches[0]
        self.x = torch.zeros((ref.shape[0], lm.cfg.hidden_size),
                             dtype=ref.dtype, device=ref.device)
        self.pos = torch.full((1,), ref.shape[1] - 1, dtype=torch.long,
                              device=ref.device)
        moes = lm.moe_layers()
        loads = [m.load.clone() for m in moes]
        side = torch.cuda.Stream(device=ref.device)
        side.wait_stream(torch.cuda.current_stream(ref.device))
        with torch.cuda.stream(side):
            x = self.x
            for layer, cache in zip(lm.layers, caches):
                x = layer.feed(layer.attend(x, angles, cache, self.pos))
        torch.cuda.current_stream(ref.device).wait_stream(side)
        for m, load in zip(moes, loads):
            m.load.copy_(load)
        self.parts: List[Tuple[torch.cuda.CUDAGraph, Optional[str]]] = []
        self.routes: List[torch.Tensor] = []
        pool = None
        for layer, cache in zip(lm.layers, caches):
            for name, body in (
                    ("rtvc.vlm.mla_decode",
                     lambda: layer.attend(self.x, angles, cache, self.pos)),
                    ("rtvc.vlm.experts" if isinstance(layer.mlp, MoE)
                     else None, lambda: layer.feed(self.x))):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    self.x.copy_(body())
                pool = graph.pool()
                self.parts.append((graph, name))
            if isinstance(layer.mlp, MoE):
                self.routes.append(layer.mlp.last_route)

    def run(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        with span("rtvc.decode.graph"):
            self.x.copy_(x)
            self.pos.copy_(pos)
            for graph, name in self.parts:
                if name is None:
                    graph.replay()
                else:
                    with span(name):
                        graph.replay()
        return self.x


def graphs_apply(x: torch.Tensor, model: nn.Module) -> bool:
    """Whether a decode over ``x`` may replay graphs: a real CUDA tensor,
    eval mode, grad off, no compiler tracing or stream capture under way."""
    return (type(x) is torch.Tensor and x.is_cuda and not model.training
            and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())
