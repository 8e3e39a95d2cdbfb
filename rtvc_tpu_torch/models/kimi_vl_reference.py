"""Plain float32 reference of Kimi-VL-A3B-Instruct as a captioner:
MoonViT over a clip's frames, the 2×2 merge and the projector, and the
language model's full causal forward over a whole sequence. It imports
only ``torch``: no cache, no batching of requests, no kernels; every
product in float32 with TF32 off (:func:`strict_float32`).

The equations (Kimi-VL technical report, arXiv:2504.07491; the published
config.json; DeepSeek-V3's MLA and router):

- MoonViT: a 14×14 stride-14 patch convolution with bias, plus the learned
  position table resized bicubically to the patch grid; pre-LayerNorm
  blocks ``x + wo(attn(rope2d(wqkv(ln0(x)))))``, ``x + fc1(gelu_tanh(fc0(
  ln1(x))))``; a final LayerNorm; each 2×2 neighbourhood (row-major)
  concatenated; the projector ``linear_2(gelu(linear_1(flatten(ln(x)))))``.
- 2D RoPE: adjacent pairs of a head; pair 2i turns by ``col · f_i``, pair
  2i + 1 by ``row · f_i``, ``f_i = θ^(-4i/d)``.
- The language model: ``x + attn(rms(x))``, ``x + mlp(rms(x))``; MLA with
  ``q = W_q x``, ``[c, k_pe] = W_kva x``, ``c`` RMS-normed, RoPE on ``k_pe``
  and on the queries' rope part, ``[k_nope, v] = W_kvb c``, scores
  ``(q_nope·k_nope + q_pe·k_pe) / √192``, causal; the dense SwiGLU of the
  first layers; the MoE: ``s = sigmoid(W_g x)``, the top k of ``s + bias``,
  weights ``s`` over the top k normalised to sum 1 times the routed
  scaling factor, each chosen expert's SwiGLU, plus the shared experts;
  the final RMSNorm and the untied head.

Departures from the published model:

- RoPE turns adjacent pairs; the published code de-interleaves q_pe and
  k_pe before its rotate-half. Both sides permute alike, so the scores
  are the same;
- each MoE layer's experts are stacked ``[E, out, in]`` under
  ``mlp.experts.{gate,up,down}_proj``;
- RMSNorm multiplies the float32-normalised row by its scale (the
  published code rounds the row to the input dtype first; in float32 the
  two agree);
- the MoonViT widths and RoPE layout are assumed (SigLIP-so400m-patch14);
  every frame is an image of its own, attended alone; the visual tokens go
  into the prompt's ids at ``media_at``, with no chat template;
- ``expert_round``, where given, is applied to the routed experts'
  stacked weights before use (a lower-precision control);
- ``routes``, where given, replays another computation's expert choices:
  each MoE layer computes the given experts, weighted by its own scores
  there, and still reports its own top k. With random weights the scores'
  top k are separated by little, so a choice flips on rounding, and a flip
  moves every later layer; the replay keeps a comparison of two
  precisions to the precision, and the reported choices say how often
  they would have differed. Each MoE layer also reports the scores it
  chose by (``scores``: sigmoid plus correction bias, ``[L, E]``), so
  that another computation's choices can be ranked by them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def strict_float32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def turn_pairs(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Adjacent pairs of ``x``'s last axis turned by ``angles`` (which
    broadcast against ``x[..., ::2]``)."""
    a, b = x[..., 0::2], x[..., 1::2]
    cos, sin = angles.cos(), angles.sin()
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def vision_angles(rows: int, cols: int, head_dim: int, theta: float,
                  device) -> torch.Tensor:
    """``[rows · cols, head_dim / 2]``: pair 2i on the column, 2i + 1 on the
    row, each at ``θ^(-4i/d)``."""
    out = torch.empty(rows * cols, head_dim // 2, device=device)
    for i in range(head_dim // 4):
        f = theta ** (-4.0 * i / head_dim)
        for r in range(rows):
            out[r * cols:(r + 1) * cols, 2 * i] = torch.arange(
                cols, device=device).float() * f
            out[r * cols:(r + 1) * cols, 2 * i + 1] = r * f
    return out


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


class KimiVLReference:
    """``cfg``: the configuration as a mapping (the fields of the port's
    ``KimiVLConfig``, ``vision`` a mapping of ``MoonViTConfig``'s);
    ``params``: name → tensor, upcast to float32 where read, one layer at
    a time (a lazy mapping may draw each on demand)."""

    def __init__(self, cfg: Mapping, params: Mapping[str, torch.Tensor],
                 expert_round: Optional[Callable] = None):
        self.cfg = cfg
        self.p = params
        self.expert_round = expert_round

    def w(self, name: str) -> torch.Tensor:
        return self.p[name].float()

    # ---------------------------------------------------------- vision
    def vision(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised frames ``[F, H, W, 3]`` → visual tokens ``[F · T,
        hidden]`` in frame order."""
        v = self.cfg["vision"]
        width, heads, m = v["width"], v["heads"], v["merge"]
        hd = width // heads
        p = "vision_tower."
        x = F.conv2d(pixels.permute(0, 3, 1, 2).float(),
                     self.w(p + "patch_embed.proj.weight"),
                     self.w(p + "patch_embed.proj.bias"),
                     stride=v["patch_size"])
        n, _, rows, cols = x.shape
        x = x.flatten(2).transpose(1, 2)
        table = self.w(p + "patch_embed.pos_emb")
        if tuple(table.shape[:2]) != (rows, cols):
            table = F.interpolate(table.permute(2, 0, 1)[None],
                                  size=(rows, cols), mode="bicubic",
                                  align_corners=False)[0].permute(1, 2, 0)
        x = x + table.reshape(rows * cols, width)
        ang = vision_angles(rows, cols, hd, v["rope_theta"], x.device)
        eps = v["norm_eps"]
        for i in range(v["layers"]):
            b = f"{p}encoder.blocks.{i}."
            h = F.layer_norm(x, (width,), self.w(b + "norm0.weight"),
                             self.w(b + "norm0.bias"), eps)
            qkv = (h @ self.w(b + "wqkv.weight").T + self.w(b + "wqkv.bias")
                   ).view(n, rows * cols, 3, heads, hd)
            q = turn_pairs(qkv[:, :, 0], ang[:, None]).transpose(1, 2)
            k = turn_pairs(qkv[:, :, 1], ang[:, None]).transpose(1, 2)
            vv = qkv[:, :, 2].transpose(1, 2)
            s = q @ k.transpose(-1, -2) * hd ** -0.5
            o = (torch.softmax(s, -1) @ vv).transpose(1, 2).reshape(
                n, rows * cols, width)
            x = x + o @ self.w(b + "wo.weight").T + self.w(b + "wo.bias")
            h = F.layer_norm(x, (width,), self.w(b + "norm1.weight"),
                             self.w(b + "norm1.bias"), eps)
            h = F.gelu(h @ self.w(b + "mlp.fc0.weight").T
                       + self.w(b + "mlp.fc0.bias"), approximate="tanh")
            x = x + h @ self.w(b + "mlp.fc1.weight").T \
                + self.w(b + "mlp.fc1.bias")
        x = F.layer_norm(x, (width,), self.w(p + "encoder.final_layernorm."
                                             "weight"),
                         self.w(p + "encoder.final_layernorm.bias"), eps)
        x = x.view(n, rows // m, m, cols // m, m, width).permute(
            0, 1, 3, 2, 4, 5).reshape(n, -1, m * m, width)
        q = "multi_modal_projector."
        x = F.layer_norm(x, (width,), self.w(q + "pre_norm.weight"),
                         self.w(q + "pre_norm.bias"), 1e-5).flatten(-2)
        x = F.gelu(x @ self.w(q + "linear_1.weight").T
                   + self.w(q + "linear_1.bias"))
        x = x @ self.w(q + "linear_2.weight").T + self.w(q + "linear_2.bias")
        return x.reshape(-1, x.shape[-1])

    # ---------------------------------------------------------- language
    def embed(self, ids: Sequence[int], device) -> torch.Tensor:
        table = self.p["language_model.embed_tokens.weight"]
        return table[torch.as_tensor(list(ids), dtype=torch.long,
                                     device=table.device)].float().to(device)

    def attention(self, x: torch.Tensor, p: str) -> torch.Tensor:
        c = self.cfg
        heads, nope, rope = (c["num_attention_heads"], c["qk_nope_head_dim"],
                             c["qk_rope_head_dim"])
        rank, vd = c["kv_lora_rank"], c["v_head_dim"]
        length = x.shape[0]
        q = (x @ self.w(p + "q_proj.weight").T).view(length, heads, -1)
        ckv = x @ self.w(p + "kv_a_proj_with_mqa.weight").T
        lat = rms(ckv[:, :rank], self.w(p + "kv_a_layernorm.weight"),
                  c["rms_norm_eps"])
        pos = torch.arange(length, device=x.device).float()
        inv = c["rope_theta"] ** (-torch.arange(0, rope, 2, device=x.device)
                                  .float() / rope)
        ang = pos[:, None] * inv
        q_pe = turn_pairs(q[..., nope:], ang[:, None])
        k_pe = turn_pairs(ckv[:, rank:], ang)
        kv = (lat @ self.w(p + "kv_b_proj.weight").T).view(length, heads, -1)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        s = (torch.einsum("ihd,jhd->hij", q[..., :nope], k_nope)
             + torch.einsum("ihd,jd->hij", q_pe, k_pe)) * (nope + rope) ** -0.5
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=x.device).tril()
        s = s.masked_fill(~causal, NEG_INF)
        o = torch.einsum("hij,jhd->ihd", torch.softmax(s, -1), v)
        return o.reshape(length, heads * vd) @ self.w(p + "o_proj.weight").T

    def moe(self, x: torch.Tensor, p: str,
            chosen: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The MoE layer, its own choice ``[L, k]`` and the scores it
        chose by ``[L, E]``; with ``chosen``, those experts computed in
        place of its own."""
        c = self.cfg
        scores = torch.sigmoid(x @ self.w(p + "gate.weight").T)
        choice = scores + self.w(p + "gate.e_score_correction_bias")
        own = torch.topk(choice, c["num_experts_per_tok"], dim=-1).indices
        idx = own if chosen is None else chosen.to(own.device)
        wts = scores.gather(1, idx)
        if c["norm_topk_prob"]:
            wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
        wts = wts * c["routed_scaling_factor"]
        stacks = [self.w(p + f"experts.{n}_proj") for n in
                  ("gate", "up", "down")]
        if self.expert_round is not None:
            stacks = [self.expert_round(t) for t in stacks]
        out = torch.zeros_like(x)
        for e in range(stacks[0].shape[0]):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel():
                y = swiglu(x[rows], stacks[0][e], stacks[1][e], stacks[2][e])
                out.index_add_(0, rows, y * wts[rows, slot, None])
        shared = swiglu(x, self.w(p + "shared_experts.gate_proj.weight"),
                        self.w(p + "shared_experts.up_proj.weight"),
                        self.w(p + "shared_experts.down_proj.weight"))
        return out + shared, own, choice

    def language(self, x: torch.Tensor,
                 routes: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, List[torch.Tensor],
                            List[torch.Tensor]]:
        """Embedded inputs ``[L, hidden]`` → (the final norm's output ``[L,
        hidden]``, each MoE layer's own chosen experts ``[L, k]``, and the
        scores it chose by ``[L, E]``); ``routes``, one ``[L, k]`` a MoE
        layer, replayed."""
        c = self.cfg
        eps = c["rms_norm_eps"]
        own: List[torch.Tensor] = []
        scores: List[torch.Tensor] = []
        for i in range(c["num_hidden_layers"]):
            p = f"language_model.layers.{i}."
            x = x + self.attention(
                rms(x, self.w(p + "input_layernorm.weight"), eps),
                p + "self_attn.")
            h = rms(x, self.w(p + "post_attention_layernorm.weight"), eps)
            if i < c["first_k_dense_replace"]:
                x = x + swiglu(h, self.w(p + "mlp.gate_proj.weight"),
                               self.w(p + "mlp.up_proj.weight"),
                               self.w(p + "mlp.down_proj.weight"))
            else:
                j = len(own)
                y, idx, choice = self.moe(
                    h, p + "mlp.", None if routes is None else routes[j])
                x = x + y
                own.append(idx)
                scores.append(choice)
        return (rms(x, self.w("language_model.norm.weight"), eps), own,
                scores)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.w("language_model.lm_head.weight").T

    def forward(self, pixels: torch.Tensor, prompt_ids: Sequence[int],
                media_at: int, tokens: Sequence[int],
                routes: Optional[Sequence[torch.Tensor]] = None
                ) -> Dict[str, object]:
        """One clip's frames ``[F, H, W, 3]`` (normalised), the prompt and
        the generated ``tokens``, teacher-forced: ``logits [len(tokens),
        V]``, row j the prediction of ``tokens[j]`` (from the prompt's last
        position, then from each token before it), ``routes``, each MoE
        layer's own choices, and ``scores``, what it chose by; ``routes``
        given are replayed."""
        visual = self.vision(pixels)
        text = self.embed(prompt_ids, visual.device)
        gen = self.embed(tokens[:-1], visual.device) if len(tokens) > 1 \
            else visual[:0]
        x = torch.cat((text[:media_at], visual, text[media_at:], gen))
        h, own, scores = self.language(x, routes)
        first = x.shape[0] - len(tokens)
        return {"logits": self.head(h[first:]), "routes": own,
                "scores": scores,
                "prompt_length": first + 1}
