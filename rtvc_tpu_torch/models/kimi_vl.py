"""Kimi-VL-A3B-Instruct as a video captioner.

A clip's frames, each encoded as an image by MoonViT and projected
(:mod:`.moonvit`), become ``frames · tokens_per_frame`` visual tokens, in
frame order, placed into the prompt's ids at ``media_at``. The
:meth:`KimiVLCaptioner.prefill` runs one causal pass of the language
model (:mod:`.kimi_lm`) over prompt + visual tokens, fills each layer's
latent cache and gives the last position's logits; each
:meth:`KimiVLCaptioner.decode_step` then extends every row by one token
through the caches. ``decode.vlm_greedy`` drives both, and
``serving.make_caption_step`` / ``BatchCaptionServer`` serve it as they
serve the student.

On a card in eval mode with grad off, the prefill writes into latent
caches kept for each (batch, slots) shape, and the decode replays the
language model's per-layer CUDA graphs over them
(:class:`.kimi_lm.DecodeGraphs`, captured at the shape's first decode:
the server's warm-up); elsewhere each call allocates its caches and the
decode runs eager. Both compute the same products in the same order.

The prompt is a fixed run of token ids (:meth:`set_prompt`); without the
tokenizer's files there is no chat template and no text. Parameter names
are the modules' own (the published checkpoint's, with each MoE layer's
experts stacked ``[E, out, in]``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import KimiVLConfig
from ..utils.profiling import span
from .kimi_lm import DecodeGraphs, KimiLM, MoE, graphs_apply
from .moonvit import MoonViT, Projector


class Prefilled(NamedTuple):
    """What the decode continues from: each layer's latent cache ``[B,
    slots, kv_lora_rank + qk_rope]``, the RoPE angles of every slot, the
    prompt's length (the first position a decode step writes), and the
    shape's workspace where the decode replays graphs."""
    caches: List[torch.Tensor]
    angles: torch.Tensor
    length: int
    workspace: Optional["Workspace"] = None


class Workspace:
    """The latent caches and RoPE table of one (batch, slots) shape, kept
    for the decode graphs that read them (captured at the first decode)."""

    def __init__(self, lm: KimiLM, batch: int, slots: int, device, dtype):
        self.caches = lm.latent_caches(batch, slots, device, dtype)
        self.angles = lm.angles(slots, device)
        self.graphs: Optional[DecodeGraphs] = None


class KimiVLCaptioner(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        v = cfg.vision
        self.cfg = cfg
        self.vision_tower = MoonViT(v)
        self.multi_modal_projector = Projector(v.width, v.merge * v.merge,
                                               cfg.hidden_size)
        self.language_model = KimiLM(cfg)
        self.eos_token_id = int(cfg.eos_token_id)
        self.image_size = int(v.image_size)
        self.pixel_mean = tuple(cfg.pixel_mean)
        self.pixel_std = tuple(cfg.pixel_std)
        self.register_buffer("prompt_ids", torch.zeros(0, dtype=torch.long),
                             persistent=False)
        self.media_at = 0
        # one call at a time: a shape's caches and graphs are shared
        self._workspaces: Dict[Tuple[int, int], Workspace] = {}
        self._where: Tuple[int, ...] = ()
        self._routes: List[torch.Tensor] = []

    def set_prompt(self, ids: Sequence[int], media_at: int) -> None:
        """The prompt's token ids; the visual tokens go before
        ``ids[media_at]``."""
        if not 0 <= media_at <= len(ids):
            raise ValueError(f"media_at {media_at} outside a prompt of "
                             f"{len(ids)} ids")
        self.prompt_ids = torch.as_tensor(list(ids), dtype=torch.long,
                                          device=self.prompt_ids.device)
        self.media_at = int(media_at)

    def moe_layers(self) -> List[MoE]:
        return self.language_model.moe_layers()

    def expert_load(self) -> torch.Tensor:
        """Routed tokens ``[MoE layers, E]`` since the counters were last
        zeroed (summed on the device; this read waits for it)."""
        return torch.stack([m.load for m in self.moe_layers()]).cpu()

    def reset_expert_load(self) -> None:
        for m in self.moe_layers():
            m.load.zero_()

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Normalised frames ``[B, F, H, W, 3]`` → visual tokens ``[B,
        F · tokens, hidden]``."""
        with span("rtvc.vlm.vision"):
            b, f = frames.shape[:2]
            merged = self.vision_tower(frames.flatten(0, 1))
            visual = self.multi_modal_projector(merged)
            return visual.reshape(b, -1, visual.shape[-1])

    def prefill(self, visual: torch.Tensor, new_tokens: int
                ) -> Tuple[torch.Tensor, Prefilled]:
        """The prompt around ``visual [B, Nv, hidden]`` through the language
        model → (the last position's logits ``[B, V]``, the caches with
        room for ``new_tokens`` more)."""
        lm = self.language_model
        with span("rtvc.vlm.prefill"):
            b = visual.shape[0]
            text = lm.embed_tokens(self.prompt_ids)[None].expand(b, -1, -1)
            x = torch.cat((text[:, :self.media_at], visual.to(text.dtype),
                           text[:, self.media_at:]), dim=1)
            length = x.shape[1]
            slots = length + new_tokens
            if slots > self.cfg.max_position_embeddings:
                raise ValueError(f"{slots} positions, past the model's "
                                 f"{self.cfg.max_position_embeddings}")
            ws = None
            if graphs_apply(x, self):
                # graphs read the parameters where they were captured
                where = tuple(p.data_ptr() for p in self.parameters())
                if where != self._where:
                    self._workspaces, self._where = {}, where
                ws = self._workspaces.get((b, slots))
                if ws is None:
                    ws = self._workspaces[(b, slots)] = Workspace(
                        lm, b, slots, x.device, x.dtype)
                caches, angles = ws.caches, ws.angles
            else:
                caches = lm.latent_caches(b, slots, x.device, x.dtype)
                angles = lm.angles(slots, x.device)
            logits = lm.prefill(x, caches, angles)
            self._routes = [m.last_route for m in self.moe_layers()]
        return logits, Prefilled(caches, angles, length, ws)

    def decode_step(self, token: torch.Tensor, pos: int,
                    state: Prefilled) -> torch.Tensor:
        """Tokens ``[B]`` at position ``pos`` → logits ``[B, V]``."""
        lm = self.language_model
        pos_t = torch.full((1,), pos, dtype=torch.long, device=token.device)
        ws = state.workspace
        if ws is not None and ws.graphs is None:
            ws.graphs = DecodeGraphs(lm, ws.caches, ws.angles)
        graphs = None if ws is None else ws.graphs
        logits = lm.decode_step(token, pos_t, state.caches, state.angles,
                                graphs)
        self._routes = (graphs.routes if graphs is not None
                        else [m.last_route for m in self.moe_layers()])
        return logits

    def last_routes(self) -> List[torch.Tensor]:
        """Each MoE layer's chosen experts ``[tokens, k]`` in the last
        prefill or decode step (a graph's buffers: copy them before the
        next step)."""
        return self._routes


def kimi_vl_from_config(cfg: KimiVLConfig, device="cuda",
                        dtype: torch.dtype = None) -> KimiVLCaptioner:
    """The captioner of ``cfg`` on ``device`` in ``dtype`` (default
    ``cfg.dtype``), eval mode, its parameters allocated and not filled:
    load weights (``load_state_dict``) or call :func:`random_init_`."""
    with torch.device("meta"):
        model = KimiVLCaptioner(cfg).to(dtype or cfg.dtype)
    model = model.to_empty(device=device)
    for m in model.moe_layers():
        m.load.zero_()
    return model.eval()


@torch.no_grad()
def random_init_(model: KimiVLCaptioner, generator: torch.Generator
                 ) -> KimiVLCaptioner:
    """Every parameter from ``generator``, drawn on the generator's device
    a parameter at a time (a CPU generator gives any device the same
    values; a card's draws the published sizes in seconds): matrices and
    stacks N(0, fan_in^-1/2), the word table N(0, 1), the position table
    N(0, width^-1/2), biases and correction biases N(0, 0.1), norm scales
    N(1, 0.1)."""
    for name, p in model.named_parameters():
        if name.endswith("embed_tokens.weight"):
            std, mean = 1.0, 0.0
        elif p.dim() == 1:
            std, mean = 0.1, 0.0 if name.endswith("bias") else 1.0
        elif p.dim() == 4:
            std, mean = p[0].numel() ** -0.5, 0.0
        else:
            std, mean = p.shape[-1] ** -0.5, 0.0
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device) * std + mean)
    return model
