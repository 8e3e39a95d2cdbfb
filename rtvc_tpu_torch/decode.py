"""Greedy and beam captioning over the student's KV cache, and the
teacher's beam search.

Counterpart of ``student_greedy``, ``student_beam``, ``teacher_beam`` and
``teacher_kd_targets`` in ``rtvc_tpu/decode.py``. Each JAX
``lax.while_loop`` or ``fori_loop`` becomes a Python loop over the model's
``decode_step`` with preallocated caches; each stop test reads one boolean
back from the device per token.

``student_greedy`` (reference model.py:156-187) runs the student with
caches of ``1 + max_len`` slots from ``model.decode_caches``, held for the
whole caption. One greedy position is :class:`GreedyStep` (the key mask,
the body, the argmax, the token write, the stop). Eagerly the loop runs it
and reads the stop back every token. On the card in eval mode the caches
are a decode workspace's (``models/decode_graph.py``), which captures the
step as one CUDA graph a position: each ``decode_step`` replays it, and
the host reads the stop one position late, after it has issued the next
position, so the card never waits on the read. The semantics are the
reference's:

- the self-attention key mask is ``(pos <= i) & (tokens != 0)``: a
  generated pad id 0 drops out of later steps, as the reference's
  full-recompute decoder masks ``y == 0``;
- decoding stops early only when every row emits SEP at the same step;
  rows that ended earlier keep generating.

``student_beam`` is the reference's EOS-free beam (model.py:189-317) in
JAX's fixed-shape form: caches of ``max_len`` slots, a top-k over the raw
logits of each beam's row, a ``k·k`` candidate table in beam-major order,
ties lowest index first as ``jax.lax.top_k`` breaks them.

``teacher_beam`` is GIT's beam search as the reference modified it
(model.py:465-678): beam 4, 15 steps, length penalty 0.6 applied when a
hypothesis is added, a BeamHypotheses pool keeping the best hypothesis with
the old-HF ``is_done`` rule, EOS candidates added as hypotheses only while
the next beam set is unfilled, forced adds at the last step, pad = EOS, and
every step's raw logits kept for distillation. With ``do_sample`` each beam
samples its candidates (temperature, :func:`top_k_top_p_filtering`, then a
Gumbel top-k whose noise :func:`gumbel_noise` draws from an explicit CPU
generator). ``teacher_generate`` wraps it as the reference's teacher
forward: per-sample captions and beam-consensus logit rows.

``vlm_greedy`` has no JAX counterpart: the greedy decode of the
vision-language captioner (``models/kimi_vl.py``), a prefill over the
prompt and the visual tokens, then one decode step a token through the
latent caches, with :func:`student_greedy`'s spans and all-rows stop.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .models.decode_graph import DecodeWorkspace
from .models.git_teacher import Cache, GITTeacher
from .models.kimi_vl import KimiVLCaptioner
from .models.student import StudentCandidateV1
from .utils.profiling import span


class GreedyStep:
    """A greedy caption's state on its device, and one position of it run
    in place, as JAX's ``lax.while_loop`` body keeps it on the device
    (``rtvc_tpu/decode.py``):

    - ``rows`` ``[B, slots]``: CLS, the generated ids, 0 after an all-rows
      stop; int64, argmax's own type, so that the token write is one
      kernel;
    - ``mask`` ``[B, slots]``: the key mask ``(pos <= i) & (rows != 0)``,
      its column ``i`` set at position ``i`` (the rows never change behind
      the position);
    - ``done``: every row has emitted SEP at one step;
    - ``sep``, ``zero``: the int64 scalars the step compares and writes.

    :func:`student_greedy` runs it eagerly; a decode workspace captures it
    as each position's CUDA graph (``models/decode_graph.py``) and hands
    ``done`` to the host as the position's flag."""

    def __init__(self, batch: int, slots: int, device: torch.device):
        self.rows = torch.zeros((batch, slots), dtype=torch.int64,
                                device=device)
        self.mask = torch.zeros((batch, slots), dtype=torch.bool,
                                device=device)
        self.done = torch.zeros((), dtype=torch.bool, device=device)
        self.sep = torch.zeros((), dtype=torch.int64, device=device)
        self.zero = torch.zeros((), dtype=torch.int64, device=device)

    def start(self, model: StudentCandidateV1) -> None:
        """A new caption: the rows CLS then 0, no key, not done, the
        model's SEP."""
        self.rows.zero_()
        self.rows[:, 0] = model.cls_token_id
        self.mask.zero_()
        self.done.zero_()
        self.sep.fill_(model.sep_token_id)

    def __call__(self, body: Callable[..., torch.Tensor], index: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Position ``index``: ``body(token, index, mask)``'s logits, whose
        argmax is written to ``rows[:, index + 1]`` (0 once ``done``), and
        ``done`` set where every row emitted SEP. Returns the logits and
        ``done``."""
        torch.ne(self.rows[:, index], 0, out=self.mask[:, index])
        logits = body(self.rows[:, index], index, self.mask)
        nxt = torch.argmax(logits, dim=-1)
        torch.where(self.done, self.zero, nxt, out=self.rows[:, index + 1])
        self.done |= (nxt == self.sep).all()
        return logits, self.done


@torch.inference_mode()
def student_greedy(model: StudentCandidateV1, frames: torch.Tensor,
                   max_len: int = 10,
                   vocab_w8: Optional[Dict[str, torch.Tensor]] = None,
                   host_stop: bool = True) -> torch.Tensor:
    """Frames ``[B, F, H, W, 3]`` → int32 ``[B, 1 + max_len]``: CLS, the
    generated ids, 0 after an early stop.

    ``host_stop`` reads the all-rows-SEP test back and breaks the loop.
    ``host_stop=False`` reads nothing back, as an exported program must:
    it runs all ``max_len`` steps, writes 0 once every row has emitted SEP
    at one step and keeps the rows of the early stop, as JAX's while-loop
    leaves them. Either way ``model.decode_step`` is called once a decoded
    position and returns logits the caller owns."""
    with span("rtvc.decode.encode"):
        _, memory = model.forward_image_enc(frames)
    b = frames.shape[0]
    total = 1 + max_len
    with model.decode_caches(b, total, memory, vocab_w8,
                             step=GreedyStep) as caches:
        ws = getattr(caches, "workspace", None)
        if ws is not None and ws.armed:
            return _greedy_on_workspace(model, ws, max_len, vocab_w8,
                                        host_stop)
        greedy = GreedyStep(b, total, memory.device)
        greedy.start(model)

        def body(token, index, mask):
            return model.decode_step(token, index, caches, mask,
                                     vocab_w8=vocab_w8)[0]

        for i in range(max_len):
            with span("rtvc.decode.token"):
                greedy(body, i)
                if host_stop:
                    with span("rtvc.decode.stop_wait"):
                        stopped = bool(greedy.done)
                    if stopped:
                        break
    return greedy.rows.to(torch.int32)


def _greedy_on_workspace(model: StudentCandidateV1, ws: DecodeWorkspace,
                         max_len: int,
                         vocab_w8: Optional[Dict[str, torch.Tensor]],
                         host_stop: bool) -> torch.Tensor:
    """:func:`student_greedy` on a decode workspace armed with
    :class:`GreedyStep` (``ws.step``), whose position graphs write the rows
    and the flag themselves. After issuing position ``i`` the host waits
    for position ``i - 1``'s flag, so the card holds position ``i`` while
    the host reads; on a stop that position was decoded past it (its token
    write is 0, the rows are the eager loop's), counted in
    ``model.decode_graphs.past_stop``. A ``decode_step`` call that did not
    replay its position raises. Returns an int32 copy of the rows."""
    greedy = ws.step
    greedy.start(model)
    for i in range(max_len):
        with span("rtvc.decode.token"):
            model.decode_step(greedy.rows[:, i], i, ws.caches, greedy.mask,
                              vocab_w8=vocab_w8)
            if ws.issued != i + 1:
                raise RuntimeError(
                    f"decode position {i} did not replay its graph: "
                    "model.decode_step must reach the workspace's replay")
            if host_stop and i > 0:
                with span("rtvc.decode.stop_wait"):
                    stopped = ws.flag(i - 1)
                if stopped:
                    model.decode_graphs.past_stop += 1
                    break
    return greedy.rows.to(torch.int32)


@torch.inference_mode()
def vlm_greedy(model: KimiVLCaptioner, frames: torch.Tensor,
               max_new_tokens: int = 64) -> torch.Tensor:
    """The vision-language captioner's greedy decode: normalised frames
    ``[B, F, H, W, 3]`` → int32 ``[B, max_new_tokens]``, the generated ids,
    0 after an early stop. The prefill's logits give the first token; each
    later one comes from a ``decode_step`` through the latent caches.
    Decoding stops early only when every row emits EOS at the same step,
    one read-back a token, as :func:`student_greedy` stops on SEP. The
    prefill's state, and the workspace it may hold, is released at the
    end."""
    with span("rtvc.decode.encode"):
        visual = model.encode(frames)
    logits, state = model.prefill(visual, max_new_tokens)
    try:
        b = frames.shape[0]
        tokens = torch.zeros((b, max_new_tokens), dtype=torch.int32,
                             device=logits.device)
        eos = model.eos_token_id
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens[:, 0] = nxt
        with span("rtvc.decode.stop_wait"):
            if bool((nxt == eos).all()):
                return tokens
        for i in range(1, max_new_tokens):
            with span("rtvc.decode.token"):
                logits = model.decode_step(tokens[:, i - 1],
                                           state.length + i - 1, state)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                tokens[:, i] = nxt
                stop = (nxt == eos).all()
                with span("rtvc.decode.stop_wait"):
                    stopped = bool(stop)
                if stopped:
                    break
        return tokens
    finally:
        state.release()


def _gather_cache(caches: List[Cache], rows: torch.Tensor) -> List[Cache]:
    """Fresh caches holding ``rows`` of each: advanced indexing copies, so a
    later in-place write never reaches a row another beam still reads."""
    return [{k: v[rows] for k, v in cache.items()} for cache in caches]


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row of ``x`` and their indices,
    equal values lowest index first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


_stable_top_k = top_k  # teacher_beam's ``top_k`` argument shadows it


def beam_select(raw: torch.Tensor, scores: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of :func:`student_beam`'s selection: raw float32 logits
    ``[B·k, V]`` (row ``b·k + beam``) and the beams' scores ``[B, k]`` →
    (the new scores, the beam each new beam extends, the word it appends),
    each ``[B, k]``. The top k words of each row by raw logit, normalised
    by the row's logsumexp (log_softmax is a per-row shift, so the words,
    their order and their scores are those of a top-k over log_softmax),
    plus the beam's score, pooled into a ``k·k`` table in beam-major order,
    of which the top k survive."""
    b, k = scores.shape
    top_raw, top_words = top_k(raw, k)                      # [B·k, k]
    lse = torch.logsumexp(raw, dim=-1, keepdim=True)
    cand_scores = (scores[:, :, None]
                   + (top_raw - lse).reshape(b, k, k)).reshape(b, k * k)
    best_scores, best_idx = top_k(cand_scores, k)           # [B, k]
    sel_words = torch.gather(top_words.reshape(b, k * k), 1, best_idx)
    return best_scores, best_idx // k, sel_words


@torch.inference_mode()
def student_beam(model: StudentCandidateV1, frames: torch.Tensor,
                 max_len: int = 10, k: int = 3,
                 vocab_w8: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Beam captioning (reference model.py:189-317), EOS-free: frames
    ``[B, F, H, W, 3]`` → int32 ``[B, max_len]``, CLS at column 0, the
    highest-scoring beam after ``max_len - 1`` words. No length penalty, no
    EOS handling, no pad mask (unlike greedy). ``vocab_w8`` sends the vocab
    projection through K3, as in :func:`student_greedy`."""
    with span("rtvc.decode.encode"):
        _, memory = model.forward_image_enc(frames)
    b = frames.shape[0]
    dev = memory.device
    caches = model.init_cache(b, max_len, memory)
    cls = torch.full((b,), model.cls_token_id, dtype=torch.int32, device=dev)
    with span("rtvc.decode.token"):
        logits0, caches = model.decode_step(cls, 0, caches, None,
                                            vocab_w8=vocab_w8)
        scores, top_idx = top_k(torch.log_softmax(logits0.float(), dim=-1),
                                k)

    seqs = torch.zeros((b, k, max_len), dtype=torch.int32, device=dev)
    seqs[:, :, 0] = model.cls_token_id
    if max_len > 1:  # JAX drops the write past the end: rows of CLS alone
        seqs[:, :, 1] = top_idx.to(torch.int32)
    # one cache row per beam, B-major: row b·k + beam
    caches = _gather_cache(
        caches, torch.arange(b, device=dev).repeat_interleave(k))
    batch_rows = torch.arange(b, device=dev)[:, None] * k
    for step in range(2, max_len):
        with span("rtvc.decode.token"):
            logits, caches = model.decode_step(
                seqs[:, :, step - 1].reshape(b * k), step - 1, caches, None,
                vocab_w8=vocab_w8)
            scores, sel_beams, sel_words = beam_select(logits.float(),
                                                       scores)
            seqs = torch.gather(
                seqs, 1, sel_beams[:, :, None].expand(-1, -1, max_len))
            seqs[:, :, step] = sel_words.to(torch.int32)
            caches = _gather_cache(caches,
                                   (batch_rows + sel_beams).reshape(-1))
    best = torch.argmax(scores, dim=-1)
    return seqs[torch.arange(b, device=dev), best]


class TeacherBeamOutput(NamedTuple):
    predictions: torch.Tensor  # [B, max_steps]: SOS first, EOS-padded
    logprobs: torch.Tensor     # [B] length-penalised best-hypothesis score
    logits: torch.Tensor       # [max_steps - 1, B, beams, V] raw per step
    num_steps: int             # decode iterations run


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 0.0,
                          min_tokens_to_keep: int = 2) -> torch.Tensor:
    """HF-style top-k / nucleus filtering of the last axis, as JAX's
    ``top_k_top_p_filtering`` computes it: logits below the k-th largest
    (k at least ``min_tokens_to_keep``) become -inf; then, over the
    descending sort, a logit is removed once the softmax's running sum
    before it exceeds ``top_p`` (the first ``min_tokens_to_keep`` stay), and
    every logit below the smallest kept one becomes -inf. Kept logits pass
    through unchanged."""
    filtered = logits
    if top_k and top_k > 0:
        k = min(max(top_k, min_tokens_to_keep), logits.shape[-1])
        kth = torch.sort(filtered, dim=-1).values[..., -k, None]
        filtered = torch.where(filtered < kth, -torch.inf, filtered)
    if top_p and top_p > 0.0:
        sorted_logits = torch.sort(filtered, dim=-1,
                                   descending=True).values
        cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1),
                                 dim=-1)
        remove = torch.zeros_like(cum_probs, dtype=torch.bool)
        remove[..., 1:] = cum_probs[..., :-1] > top_p
        remove[..., :min_tokens_to_keep] = False
        kept_min = torch.where(remove, torch.inf, sorted_logits).amin(
            dim=-1, keepdim=True)
        filtered = torch.where(filtered < kept_min, -torch.inf, filtered)
    return filtered


def gumbel_noise(generator: torch.Generator, shape, step: int
                 ) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` of ``shape``, float32, from
    the CPU ``generator`` (u uniform in [tiny, 1), as ``jax.random.gumbel``
    draws it), for the sampled beam's decode step ``step`` (JAX folds it
    into its key; the generator's stream already moves on). On the CPU, so
    that a card and a CPU run draw the same noise."""
    u = torch.rand(shape, generator=generator).clamp_min_(
        torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.inference_mode()
def teacher_beam(model: GITTeacher, frames: torch.Tensor, *,
                 beam_size: int = 4, max_steps: int = 15,
                 per_node_beam_size: int = 2, length_penalty: float = 0.6,
                 repetition_penalty: float = 1.0, do_sample: bool = False,
                 top_k: int = 0, top_p: float = 0.0,
                 temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None
                 ) -> TeacherBeamOutput:
    """GIT beam search over ``frames [B, F, H, W, 3]``. Without
    ``do_sample``, candidates come from a hierarchical top-k: the top m =
    beams × per-node candidates of each beam's raw (penalised) logits,
    normalised by the row's logsumexp plus the beam score, then the top m
    of the pooled rows, ties in beam-major order, as JAX selects them.

    With ``do_sample`` (the reference's sampled beam, model.py:532-554):
    the logits divided by ``temperature``, filtered by
    :func:`top_k_top_p_filtering`, perturbed by :func:`gumbel_noise` from
    the CPU ``generator`` (seeded 0 when None, as JAX's default key), and
    each beam's top ``per_node_beam_size`` kept, ties lowest word first;
    a candidate scores its filtered log-probability plus its beam's score
    and keeps its true source beam, in beam-major order (not sorted by
    score, as in JAX). ``max_steps`` must be at least 2."""
    if max_steps < 2:
        raise ValueError(f"teacher_beam: max_steps must be at least 2 (SOS "
                         f"and one decoded token), got {max_steps}")
    nb, m = beam_size, per_node_beam_size * beam_size
    sos, eos = 101, 102  # BERT CLS / SEP; EOS doubles as the pad id
    vocab = model.config.vocab_size
    if do_sample and generator is None:
        generator = torch.Generator().manual_seed(0)

    visual = model.encode_only(frames)
    b, prefix = visual.shape[:2]
    dev = visual.device
    caches = model.init_cache(visual.repeat_interleave(nb, dim=0), max_steps)

    input_ids = torch.full((b * nb, max_steps), sos, dtype=torch.int32,
                           device=dev)
    beam_scores = torch.full((b, nb), -1e9, device=dev)
    beam_scores[:, 0] = 0.0
    beam_scores = beam_scores.reshape(-1)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    hyp_best = torch.full((b,), -1e5, device=dev)
    hyp_seq = torch.full((b, max_steps), eos, dtype=torch.int32, device=dev)
    hyp_len = torch.ones(b, dtype=torch.int32, device=dev)
    hyp_count = torch.zeros(b, dtype=torch.int32, device=dev)
    logits_buf = torch.zeros((max_steps - 1, b * nb, vocab), device=dev)
    first = torch.arange(b, device=dev) * nb
    slots = torch.arange(1, nb + 1, device=dev)

    cur_len = 1
    while cur_len < max_steps and not bool(done.all()):
        raw, caches = model.decode_step(input_ids[:, cur_len - 1],
                                        cur_len - 1, caches, prefix)
        raw = raw.float()                                   # [B*nb, V]
        logits_buf[cur_len - 1] = raw

        scores_tok = raw
        if repetition_penalty != 1.0:  # CTRL-style, on generated tokens
            present = torch.zeros_like(raw, dtype=torch.bool).scatter_(
                1, input_ids[:, :cur_len].long(), True)
            penalized = torch.where(raw < 0, raw * repetition_penalty,
                                    raw / repetition_penalty)
            scores_tok = torch.where(present, penalized, raw)

        if do_sample:
            s = (scores_tok / temperature if temperature != 1.0
                 else scores_tok)
            s = top_k_top_p_filtering(s, top_k=top_k, top_p=top_p)
            noise = gumbel_noise(generator, tuple(s.shape), cur_len)
            perturbed = torch.where(torch.isfinite(s), s + noise.to(dev),
                                    -torch.inf)
            _, samp = _stable_top_k(perturbed, per_node_beam_size)
            samp_logp = torch.gather(torch.log_softmax(s, dim=-1), 1, samp)
            next_scores = (samp_logp + beam_scores[:, None]).reshape(
                b, nb * per_node_beam_size)
            word_id = samp.reshape(b, nb * per_node_beam_size)
            beam_id = torch.arange(nb, device=dev).repeat_interleave(
                per_node_beam_size)[None, :].expand(b, -1)
        else:
            top_raw, top_word = torch.topk(scores_tok, m, dim=-1)
            lse = torch.logsumexp(scores_tok, dim=-1, keepdim=True)
            pooled = (top_raw - lse + beam_scores[:, None]).reshape(b, nb * m)
            next_scores, pick = torch.topk(pooled, m, dim=1)    # [B, m]
            word_id = torch.gather(top_word.reshape(b, nb * m), 1, pick)
            beam_id = pick // m
        is_eos = word_id == eos

        # the pool's done test comes before this step's candidates
        pool_done = (hyp_count >= 1) & (
            hyp_best >= next_scores[:, 0] / (max_steps ** length_penalty))
        done = done | pool_done

        at_max = cur_len + 1 == max_steps
        sel = ~is_eos & (not at_max)
        cum = torch.cumsum(sel.int(), dim=1)
        processed = (cum - sel.int()) < nb  # before the next beams fill up

        # hypothesis adds: EOS candidates, or every candidate at the end
        hypable = processed & (is_eos | at_max) & ~done[:, None]
        cand = torch.where(hypable, next_scores / (cur_len ** length_penalty),
                           -torch.inf)
        best_cand = torch.argmax(cand, dim=1, keepdim=True)
        best_score = torch.gather(cand, 1, best_cand)[:, 0]
        improves = torch.isfinite(best_score) & (best_score > hyp_best)
        src_rows = first + torch.gather(beam_id, 1, best_cand)[:, 0]
        hyp_seq = torch.where(improves[:, None], input_ids[src_rows], hyp_seq)
        hyp_len = torch.where(improves, cur_len, hyp_len)
        hyp_best = torch.where(improves, best_score, hyp_best)
        hyp_count = hyp_count + hypable.sum(dim=1, dtype=torch.int32)

        # next beams: the first nb non-EOS candidates, in score order
        beam_rank = torch.where(sel, cum, nb + 1)
        slot_idx = torch.argmax(
            (beam_rank[:, None, :] == slots[None, :, None]).int(), dim=2)
        has_slot = torch.gather(beam_rank, 1, slot_idx) <= nb
        pad_slot = ~has_slot | done[:, None]  # → score 0, EOS, beam 0
        new_scores = torch.where(pad_slot, 0.0,
                                 torch.gather(next_scores, 1, slot_idx))
        new_words = torch.where(pad_slot, eos,
                                torch.gather(word_id, 1, slot_idx))
        new_beams = torch.where(pad_slot, 0,
                                torch.gather(beam_id, 1, slot_idx))

        rows = (first[:, None] + new_beams).reshape(-1)
        input_ids = input_ids[rows]
        input_ids[:, cur_len] = new_words.reshape(-1).int()
        caches = _gather_cache(caches, rows)
        beam_scores = new_scores.reshape(-1)
        cur_len += 1

    pos = torch.arange(max_steps, device=dev)[None, :]
    decoded = torch.where(pos < hyp_len[:, None], hyp_seq, eos)
    decoded = torch.where(pos == hyp_len[:, None], eos, decoded)
    return TeacherBeamOutput(
        predictions=decoded.int(), logprobs=hyp_best,
        logits=logits_buf.reshape(max_steps - 1, b, nb, vocab),
        num_steps=cur_len - 1)


def teacher_kd_targets(out: TeacherBeamOutput,
                       captions_text_len: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-consensus teacher distributions (reference model.py:762-793):
    for each generated word, the full-vocab logits of the beam whose logit
    at that word is largest. Returns (``[B, S, V]`` logits, ``[B, S]``
    validity mask), S the steps the logit buffer holds."""
    steps, b, nb, vocab = out.logits.shape
    words = out.predictions[:, 1:steps + 1].long()          # [B, S]
    step_logits = out.logits.permute(1, 0, 2, 3)            # [B, S, nb, V]
    word_logit = torch.gather(
        step_logits, 3, words[:, :, None, None].expand(b, steps, nb, 1))
    best_beam = torch.argmax(word_logit[..., 0], dim=-1)    # [B, S]
    teacher = torch.gather(
        step_logits, 2,
        best_beam[:, :, None, None].expand(b, steps, 1, vocab))[:, :, 0]
    n = torch.clamp(captions_text_len.to(words.device), max=steps)
    valid = torch.arange(steps, device=words.device)[None, :] < n[:, None]
    return teacher, valid


def teacher_generate(model: GITTeacher, frames: torch.Tensor, tokenizer, *,
                     beam_size: int = 4, max_steps: int = 15,
                     length_penalty: float = 0.6) -> List[Dict[str, Any]]:
    """The reference teacher's forward (``GenerativeImageTextTeacher``,
    model.py:762-793) as JAX's ``teacher_generate``: :func:`teacher_beam`
    over the batch, then per sample a dict of ``predictions`` (the int32
    row, numpy), ``cap`` (``tokenizer.decode`` of it without special
    tokens), ``output`` (the beam-consensus logits of its first
    ``n = min(words in cap, decode steps)`` words, ``[1, n, V]`` on the
    model's device) and ``logprobs`` (the best hypothesis's score)."""
    out = teacher_beam(model, frames, beam_size=beam_size,
                       max_steps=max_steps, length_penalty=length_penalty)
    preds = out.predictions.cpu().numpy()
    caps = [tokenizer.decode(p, skip_special_tokens=True) for p in preds]
    n_words = torch.tensor([min(len(c.split(" ")), out.num_steps)
                            for c in caps], dtype=torch.int32)
    teacher_logits, _ = teacher_kd_targets(out, n_words)
    return [{"predictions": preds[i], "cap": cap,
             "output": teacher_logits[i, :int(n_words[i])][None],
             "logprobs": float(out.logprobs[i])}
            for i, cap in enumerate(caps)]
