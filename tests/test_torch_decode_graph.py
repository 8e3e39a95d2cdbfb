"""The student's decode graphs (``rtvc_tpu_torch/models/decode_graph.py``).

On the CPU, on a tiny student: every case where the graphs do not apply
(CPU tensors, train mode, grad on, a compiler tracing, an export's fake
CUDA tensors) takes ``init_cache``'s caches and the eager body;
``student_greedy``'s rows and every step's logits equal a plain loop over
``decode_body``'s; ``student_beam`` runs the eager body; logits of one
step are not overwritten by the next. With each position's graph stood in
by its greedy step run eagerly on the CPU, on scripted decodes (every row
stops at step 0, at step 2 with the rows emitting SEP at different steps,
at the last step, never; pad ids emitted): the positions issued, the stops
read one position late, where the loop ends, ``past_stop``, the rows (0
after the stop) and the first calls' logits against the eager path's,
whose own rows and calls are pinned too; ``host_stop=False`` runs every
position; a call with its own token and mask on a workspace's caches held
without a step runs the eager body; each replay's event is recorded on the
workspace's own card; a wrapper on ``decode_step`` that copies the token
and the mask still replays, one that never reaches the replay raises, as
does a position out of turn. What it shares with the other graph users is
tested in ``tests/test_torch_graphs.py``.

On the card (marked ``cuda``; skips without one), on the full-width
student in bfloat16: graphed greedy captions equal eager ones bit for bit,
rows and the logits of every step the eager loop ran, at batch 1, 2, 4
and 8, with the bf16 head and ``vocab_int8``, over 25 tokens, with an
all-rows early SEP stop and with rows that emit SEP at different steps;
the graphed loop makes the eager loop's calls or one more past the stop
(``past_stop``), no two aliased; ``host_stop=False`` gives the same rows;
with two cards, a replica on card 1 driven from a thread with card 0
current equals the eager captions, early stops and full ones in turn;
in-place ``load_state_dict`` and a reassigned parameter both give the
eager result; a second thread holding the workspace falls back to eager;
``replays`` counts the positions decoded and no capture follows the
warm-up; the kernels' launch counts read as the eager path's; outside
the graph a token issues its graph's launch and the logits' clone, at
most one more host launch.
The file imports no JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_decode_graph.py
"""

import collections
import copy
import json
import os
import threading

import pytest
import torch

from rtvc_tpu_torch import decode, serving
from rtvc_tpu_torch.config import TinyViTConfig
from rtvc_tpu_torch.models import encode_graph, graphs
from rtvc_tpu_torch.models.decode_graph import (DecodeWorkspace,
                                                WorkspaceCaches)
from rtvc_tpu_torch.models.student import StudentCandidateV1, random_init_

TINY_ENC = TinyViTConfig(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                         num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4),
                         drop_path_rate=0.0, gelu_approximate=True)
MAX_LEN = 6


def tiny(seed: int = 0) -> StudentCandidateV1:
    model = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, num_decoder_layers=2,
        vocab_size=211, max_pos_len=64, encoder_config=TINY_ENC,
        input_size=224, num_frames=2, teacher_visual_dim=32,
        teacher_num_tokens=10, teacher_hidden=16)
    model = random_init_(model, torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():  # rows that depend on the frames
        model.linear.weight.mul_(10)
        for layer in model.decoder["layers"]:
            layer.multihead_attn.out_proj.weight.mul_(10)
    return model


def reference_greedy(model, frames, max_len, vocab_w8=None):
    """``student_greedy`` as a plain loop over ``decode_body`` and
    ``init_cache``: its rows and each step's logits."""
    with torch.inference_mode():
        _, memory = model.forward_image_enc(frames)
        b, total = frames.shape[0], 1 + max_len
        caches = model.init_cache(b, total, memory)
        tokens = torch.zeros((b, total), dtype=torch.int32,
                             device=memory.device)
        tokens[:, 0] = model.cls_token_id
        pos = torch.arange(total, device=memory.device)[None, :]
        steps = []
        for i in range(max_len):
            kv_mask = (pos <= i) & (tokens != 0)
            logits = model.decode_body(tokens[:, i], i, caches, kv_mask,
                                       vocab_w8)
            steps.append(logits.clone())
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            tokens[:, i + 1] = nxt
            if bool((nxt == model.sep_token_id).all()):
                break
    return tokens, steps


class Tap:
    """Each ``decode_step`` call's logits, held by reference, and a copy
    made at the call (the benchmark's tap holds them so)."""

    def __init__(self, model):
        self.model = model
        self.held, self.copies = [], []
        inner = model.decode_step

        def decode_step(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.held.append(out[0])
            self.copies.append(out[0].clone())
            return out

        model.decode_step = decode_step

    def close(self):
        del self.model.decode_step

    def assert_unaliased(self):
        for held, copy_ in zip(self.held, self.copies):
            assert torch.equal(held, copy_)
        ptrs = [t.data_ptr() for t in self.held]
        assert len(set(ptrs)) == len(ptrs)


def _frames(b, seed=0, size=224, frames=2, device="cpu",
            dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, frames, size, size, 3), generator=g) * 2 - 1
    return x.to(device, dtype)


def _counts(model):
    g = model.decode_graphs
    return g.replays, g.eager, g.captures


@pytest.fixture(scope="module")
def small():
    return tiny()


@pytest.mark.parametrize("why", ["cpu", "compiling"])
def test_greedy_fallbacks_keep_todays_rows(small, monkeypatch, why):
    frames = _frames(2)
    want, steps = reference_greedy(small, frames, MAX_LEN)
    if why == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    replays, eager, captures = _counts(small)
    got = decode.student_greedy(small, frames, max_len=MAX_LEN)
    assert torch.equal(got, want)
    assert _counts(small) == (replays, eager + len(steps), captures)


def test_beam_runs_the_eager_body(small):
    frames = _frames(2)
    replays, eager, captures = _counts(small)
    rows = decode.student_beam(small, frames, max_len=MAX_LEN, k=3)
    assert rows.shape == (2, MAX_LEN)
    assert _counts(small) == (replays, eager + MAX_LEN - 1, captures)


def test_the_eager_body_is_the_reference_loop(small):
    """Rows and each step's logits of ``student_greedy`` on the CPU equal
    the plain loop's, and no step's logits are overwritten by a later
    one."""
    frames = _frames(3, seed=1)
    want, steps = reference_greedy(small, frames, MAX_LEN)
    tap = Tap(small)
    try:
        got = decode.student_greedy(small, frames, max_len=MAX_LEN)
    finally:
        tap.close()
    assert torch.equal(got, want)
    assert len(tap.held) == len(steps)
    for a, b in zip(tap.held, steps):
        assert torch.equal(a, b)
    tap.assert_unaliased()


@pytest.mark.parametrize("why", ["cpu", "train", "grad", "fake_cuda"])
def test_decode_caches_falls_back_to_init_cache(small, why):
    frames = _frames(1)
    with torch.no_grad():
        _, memory = small.forward_image_enc(frames)
    if why == "train":
        small.train()
    if why == "fake_cuda":
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            memory = torch.empty(memory.shape, device="cuda")
        assert memory.is_cuda
    try:
        grad = torch.enable_grad() if why == "grad" else torch.no_grad()
        with grad:
            assert not graphs.graphs_apply(small, memory)
            if why != "fake_cuda":
                with small.decode_caches(1, 1 + MAX_LEN, memory) as caches:
                    assert type(caches) is list
                    assert not isinstance(caches, WorkspaceCaches)
                    assert len(caches) == 2
                    assert caches[0]["k"].shape[2] == 1 + MAX_LEN
    finally:
        small.eval()


class _Landed:
    """A position's event on the CPU, where the work is done once issued:
    the streams it was recorded on."""

    def __init__(self):
        self.streams = []

    def record(self, stream=None):
        self.streams.append(stream)

    def synchronize(self):
        pass


class _Position:
    """A position's graph on the CPU: its work, run at each replay."""

    def __init__(self, ws, work, index):
        self.ws, self.work, self.index = ws, work, index

    def replay(self):
        self.ws.logits[self.index] = self.work()


def _capture_on_cpu(ws, model):
    positions = ws.positions(model)
    ws.graphs = [_Position(ws, p, i) for i, p in enumerate(positions)]
    ws.deltas = [[] for _ in positions]
    ws.logits = [None] * len(positions)
    ws.landed = [_Landed() for _ in positions]
    return len(positions)


def _stand_in(monkeypatch):
    """Decode workspaces on the CPU, each position's graph stood in by its
    work; the encoder eager; a device's current stream named by it."""
    monkeypatch.setattr(graphs, "graphs_apply", lambda *a: True)
    monkeypatch.setattr(DecodeWorkspace, "capture", _capture_on_cpu)
    monkeypatch.setattr(encode_graph.EncodeGraphs, "run", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))


@pytest.fixture
def stood_in(monkeypatch):
    _stand_in(monkeypatch)


SEP = 102
# the first-argmax ids each row emits at each step, and the step at which
# every row has emitted SEP at once (None: never)
_SCRIPTS = {
    "stop_at_0": ([[SEP, 5, 7, 11, 13, 17], [SEP, 9, 19, 23, 29, 31]], 0),
    "stop_at_2": ([[5, 7, SEP, 11, 13, 17], [9, SEP, SEP, 19, 23, 29]], 2),
    "stop_at_last": ([[5, 7, 11, 13, 17, SEP], [9, 19, SEP, 23, 29, SEP]],
                     MAX_LEN - 1),
    "no_stop": ([[5, 7, 11, 13, 17, 19], [9, 19, SEP, 23, 29, 31]], None),
    # generated pad ids leave the key mask of later positions
    "pad_ids": ([[5, 0, 7, 11, 13, 17], [9, 19, 0, 0, 29, 31]], None),
}


def _scripted(monkeypatch, script, device="cpu"):
    """Every decode body (eager, a graph's or a stood-in graph's) emits
    the script's ids: the real logits less 1e4 everywhere else."""
    real = StudentCandidateV1.decode_body
    ids = torch.tensor(script, device=device)
    rows = torch.arange(ids.shape[0], device=device)

    def decode_body(self, token, index, caches, kv_mask, vocab_w8):
        logits = real(self, token, index, caches, kv_mask, vocab_w8)
        forced = logits - 1e4
        forced[rows, ids[:, index]] = logits[rows, ids[:, index]]
        return forced

    monkeypatch.setattr(StudentCandidateV1, "decode_body", decode_body)


def _expected_rows(model, script, stop):
    rows = torch.zeros((2, 1 + MAX_LEN), dtype=torch.int32)
    rows[:, 0] = model.cls_token_id
    end = MAX_LEN if stop is None else stop + 1
    rows[:, 1:end + 1] = torch.tensor(script, dtype=torch.int32)[:, :end]
    return rows


class _Reads:
    """The positions whose stops the host read."""

    def __init__(self, monkeypatch):
        self.read = []
        real = DecodeWorkspace.flag

        def flag(ws, index):
            self.read.append(index)
            return real(ws, index)

        monkeypatch.setattr(DecodeWorkspace, "flag", flag)


@pytest.mark.parametrize("script", list(_SCRIPTS))
def test_the_stop_is_read_one_position_late(small, monkeypatch, script):
    """Eager, the loop reads each position's stop before the next and ends
    at the stop; on a workspace it reads position ``i - 1``'s after issuing
    position ``i``, so an early stop decodes one position more, whose token
    write is 0: the same rows, the eager calls' logits first."""
    ids, stop = _SCRIPTS[script]
    _scripted(monkeypatch, ids)
    frames = _frames(2, seed=3)
    want = _expected_rows(small, ids, stop)
    eager_calls = MAX_LEN if stop is None else stop + 1
    eager = Tap(small)
    try:
        rows = decode.student_greedy(small, frames, max_len=MAX_LEN)
    finally:
        eager.close()
    assert torch.equal(rows, want)
    assert len(eager.held) == eager_calls

    _stand_in(monkeypatch)
    reads = _Reads(monkeypatch)
    past = small.decode_graphs.past_stop
    replays, eager_n, _ = _counts(small)
    graphed = Tap(small)
    issued = []
    inner = small.decode_step

    def decode_step(token, index, *args, **kwargs):
        issued.append(index)
        return inner(token, index, *args, **kwargs)

    small.decode_step = decode_step
    try:
        got = decode.student_greedy(small, frames, max_len=MAX_LEN)
    finally:
        graphed.close()
    beyond = int(stop is not None and stop < MAX_LEN - 1)
    assert torch.equal(got, want)
    assert issued == list(range(eager_calls + beyond))
    assert reads.read == issued[:-1]
    assert small.decode_graphs.past_stop - past == beyond
    assert _counts(small)[:2] == (replays + len(issued), eager_n)
    for a, b in zip(graphed.held, eager.held):
        assert torch.equal(a, b)
    graphed.assert_unaliased()


def test_host_stop_false_runs_every_position(small, monkeypatch, stood_in):
    ids, stop = _SCRIPTS["stop_at_2"]
    _scripted(monkeypatch, ids)
    reads = _Reads(monkeypatch)
    past = small.decode_graphs.past_stop
    replays = small.decode_graphs.replays
    got = decode.student_greedy(small, _frames(2, seed=3), max_len=MAX_LEN,
                                host_stop=False)
    assert torch.equal(got, _expected_rows(small, ids, stop))
    assert small.decode_graphs.replays - replays == MAX_LEN
    assert reads.read == [] and small.decode_graphs.past_stop == past


def test_the_workspace_loop_is_the_reference_loop(small, stood_in):
    """Real logits: rows and each step's logits equal the plain loop's."""
    frames = _frames(3, seed=1)
    want, steps = reference_greedy(small, frames, MAX_LEN)
    tap = Tap(small)
    try:
        got = decode.student_greedy(small, frames, max_len=MAX_LEN)
    finally:
        tap.close()
    assert torch.equal(got, want)
    assert len(tap.held) in (len(steps), len(steps) + 1)
    for a, b in zip(tap.held, steps):
        assert torch.equal(a, b)
    tap.assert_unaliased()


def test_an_own_token_and_mask_run_the_eager_body(small, stood_in):
    """On a workspace's caches held without a step, a call with its own
    token and mask runs the eager body: the logits of ``init_cache``'s."""
    frames = _frames(2, seed=5)
    with torch.inference_mode():
        _, memory = small.forward_image_enc(frames)
        token = torch.full((2,), small.cls_token_id, dtype=torch.int32)
        mask = torch.zeros((2, 1 + MAX_LEN), dtype=torch.bool)
        mask[:, 0] = True
        want = small.decode_body(token, 0, small.init_cache(
            2, 1 + MAX_LEN, memory), mask, None)
        replays, eager, _ = _counts(small)
        with small.decode_caches(2, 1 + MAX_LEN, memory) as caches:
            assert isinstance(caches, WorkspaceCaches)
            got, _ = small.decode_step(token, 0, caches, mask)
    assert torch.equal(got, want)
    assert _counts(small)[:2] == (replays, eager + 1)


def test_the_flag_events_are_recorded_on_the_workspaces_card(small,
                                                             stood_in):
    """Each replay's event is recorded on the current stream of the
    workspace's own device, not of whichever device the calling thread has
    current (a replica's thread under ``BatchCaptionServer(mesh=)``)."""
    decode.student_greedy(small, _frames(2, seed=7), max_len=MAX_LEN)
    seen = 0
    for ws in small.decode_graphs._workspaces.values():
        recorded = [s for landed in ws.landed for s in landed.streams]
        assert recorded == [("stream of", ws.device)] * len(recorded)
        seen += len(recorded)
    assert seen >= MAX_LEN


@pytest.mark.parametrize("wrapper", ["copies", "skips"])
def test_a_position_that_does_not_replay_fails_loudly(small, stood_in,
                                                      wrapper):
    """The graph reads the step's own buffers, so a wrapper on the
    instance's ``decode_step`` that copies the token and the mask still
    gets the eager rows; one that never reaches the replay raises instead
    of returning the rows of a caption nobody decoded."""
    frames = _frames(2, seed=9)
    want, _ = reference_greedy(small, frames, MAX_LEN)
    inner = small.decode_step

    def decode_step(token, index, caches, kv_mask=None, **kw):
        if wrapper == "copies":
            return inner(token.clone(), index, caches, kv_mask.clone(), **kw)
        return torch.zeros((2, small.vocab_size)), caches

    small.decode_step = decode_step
    try:
        if wrapper == "copies":
            got = decode.student_greedy(small, frames, max_len=MAX_LEN)
            assert torch.equal(got, want)
        else:
            with pytest.raises(RuntimeError, match="did not replay"):
                decode.student_greedy(small, frames, max_len=MAX_LEN)
    finally:
        del small.decode_step


def test_an_armed_position_out_of_turn_raises(small, stood_in):
    frames = _frames(2, seed=11)
    with torch.inference_mode():
        _, memory = small.forward_image_enc(frames)
        with small.decode_caches(2, 1 + MAX_LEN, memory,
                                 step=decode.GreedyStep) as caches:
            greedy = caches.workspace.step
            greedy.start(small)
            with pytest.raises(RuntimeError, match="out of turn"):
                small.decode_step(greedy.rows[:, 1], 1, caches, greedy.mask)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

FULL_LEN = 25


@pytest.fixture(scope="module")
def card():
    """The full-width student in bfloat16 on the card, with the vocab
    projection and cross-attention scaled so rows depend on the frames,
    and its int8 vocab pack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.models.student import student_from_config
    model = student_from_config(cfg, device="cpu")
    random_init_(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.linear.weight.mul_(10)
        for layer in model.decoder["layers"]:
            layer.multihead_attn.out_proj.weight.mul_(10)
    model = model.to("cuda", torch.bfloat16).eval()
    serving.with_vocab_w8(model)
    return model


def _card_frames(b, seed=0, same=False):
    frames = _frames(1 if same else b, seed=seed, frames=6, device="cuda",
                     dtype=torch.bfloat16)
    return frames.expand(b, -1, -1, -1, -1).contiguous() if same else frames


def _eager(model, monkeypatch):
    """Force the eager path for the block."""
    monkeypatch.setattr(graphs, "graphs_apply", lambda *a: False)


def _greedy_with_logits(model, frames, max_len, vocab_w8):
    tap = Tap(model)
    try:
        rows = decode.student_greedy(model, frames, max_len=max_len,
                                     vocab_w8=vocab_w8)
    finally:
        tap.close()
    torch.cuda.synchronize()
    return rows, tap


def _assert_same_caption(model, frames, vocab_w8, max_len=FULL_LEN):
    """Graphed against eager: rows bit for bit; the eager loop's calls, or
    those and one past an early stop (``past_stop``), the first ones'
    logits bit for bit; the graphed steps' logits not overwritten; every
    step a replay. Returns the rows and the eager loop's call count."""
    with pytest.MonkeyPatch.context() as mp:
        _eager(model, mp)
        want, eager = _greedy_with_logits(model, frames, max_len, vocab_w8)
    replays = model.decode_graphs.replays
    past = model.decode_graphs.past_stop
    got, graphed = _greedy_with_logits(model, frames, max_len, vocab_w8)
    assert torch.equal(got, want)
    beyond = int(len(eager.held) < max_len)
    assert len(graphed.held) == len(eager.held) + beyond
    assert model.decode_graphs.past_stop - past == beyond
    for step, (a, b) in enumerate(zip(graphed.held, eager.held)):
        assert torch.equal(a, b), f"step {step}"
    graphed.assert_unaliased()
    assert model.decode_graphs.replays - replays == len(graphed.held)
    return got, len(eager.held)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["bf16", "int8"])
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_graphed_captions_equal_eager_ones(card, batch, head):
    vocab_w8 = card.vocab_w8 if head == "int8" else None
    rows, steps = _assert_same_caption(card, _card_frames(batch, seed=batch),
                                       vocab_w8)
    if steps < FULL_LEN:  # the frames made every row stop at once
        assert bool((rows[:, steps] == card.sep_token_id).all())
    captures = card.decode_graphs.captures
    _assert_same_caption(card, _card_frames(batch, seed=batch + 10),
                         vocab_w8)
    assert card.decode_graphs.captures == captures  # none after warm-up


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_an_early_stop_equals_the_eager_one(card, monkeypatch, batch):
    """Identical rows, and SEP set to the token each emits at step 3:
    every row stops there at once."""
    frames = _card_frames(batch, seed=7, same=True)
    full, _ = _assert_same_caption(card, frames, None)
    monkeypatch.setattr(card, "sep_token_id", int(full[0, 4]))
    rows, steps = _assert_same_caption(card, frames, None)
    assert steps <= 4 and steps < FULL_LEN


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["bf16", "int8"])
def test_rows_that_stop_at_different_steps_equal_the_eager_ones(card,
                                                               monkeypatch,
                                                               head):
    """A scripted decode, captured into a copy's graphs: the three rows emit
    SEP at steps 3, 7 and 10, keep generating, and all emit it at step 12,
    where the eager loop stops and the graphed one decodes one past."""
    sep, all_at = card.sep_token_id, 12
    script = [[1000 + 100 * r + i for i in range(FULL_LEN)]
              for r in range(3)]
    for r, own in enumerate((3, 7, 10)):
        script[r][own] = script[r][all_at] = sep
    _scripted(monkeypatch, script, device="cuda")
    model = copy.deepcopy(card)  # its own workspaces, captured scripted
    vocab_w8 = model.vocab_w8 if head == "int8" else None
    rows, steps = _assert_same_caption(model, _card_frames(3, seed=23),
                                       vocab_w8)
    assert steps == all_at + 1
    want = torch.zeros_like(rows)
    want[:, 0] = card.cls_token_id
    want[:, 1:all_at + 2] = torch.tensor(script)[:, :all_at + 1]
    assert torch.equal(rows.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("stop", ["full", "early"])
def test_host_stop_false_gives_the_same_rows(card, monkeypatch, stop):
    frames = _card_frames(2, seed=19, same=stop == "early")
    want, _ = _assert_same_caption(card, frames, None)
    if stop == "early":
        monkeypatch.setattr(card, "sep_token_id", int(want[0, 4]))
        want, steps = _assert_same_caption(card, frames, None)
        assert steps <= 4
    replays, past = card.decode_graphs.replays, card.decode_graphs.past_stop
    got = decode.student_greedy(card, frames, FULL_LEN, host_stop=False)
    assert torch.equal(got, want)
    assert card.decode_graphs.replays - replays == FULL_LEN
    assert card.decode_graphs.past_stop == past


@pytest.mark.cuda
def test_a_replica_on_another_card_than_the_current_one(card):
    """A replica's thread under ``BatchCaptionServer(mesh=)`` keeps card 0
    current while its model lives on card 1. Early stops and full captions
    in turn there equal the eager ones: a flag read before its position
    landed would find the last caption's stop and cut this one short."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    model = copy.deepcopy(card).to("cuda:1")
    sep = model.sep_token_id
    same = _card_frames(2, seed=7, same=True).to("cuda:1")
    other = _card_frames(2, seed=13).to("cuda:1")
    assert torch.cuda.current_device() == 0
    stop = int(_assert_same_caption(model, same, None)[0][0, 4])
    for _ in range(3):
        model.sep_token_id = stop
        _, steps = _assert_same_caption(model, same, None)
        assert steps <= 4
        model.sep_token_id = sep
        _, steps = _assert_same_caption(model, other, None)
        assert steps > 5
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_weights_changed_in_place_or_reassigned_reach_the_graphs(card):
    frames = _card_frames(2, seed=21)
    _assert_same_caption(card, frames, None)
    saved = copy.deepcopy(card.state_dict())
    try:
        g = torch.Generator().manual_seed(9)
        sd = {k: (v + 0.05 * torch.randn(v.shape, generator=g).to(v)
                  if v.is_floating_point() else v) for k, v in saved.items()}
        captures = card.decode_graphs.captures
        card.load_state_dict(sd)
        _assert_same_caption(card, frames, None)
        assert card.decode_graphs.captures == captures  # same storage
        weight = card.linear.weight
        card.linear.weight = torch.nn.Parameter(weight.detach() * 1.5)
        _assert_same_caption(card, frames, None)
        assert card.decode_graphs.captures > captures  # recaptured
    finally:
        card.linear.weight = weight
        card.load_state_dict(saved)
    _assert_same_caption(card, frames, None)


@pytest.mark.cuda
def test_a_held_workspace_sends_another_thread_to_eager(card):
    frames = _card_frames(1, seed=31)
    want, steps = _assert_same_caption(card, frames, None)
    with torch.inference_mode():
        _, memory = card.forward_image_enc(frames)
    held, release = threading.Event(), threading.Event()

    def hold():
        with torch.inference_mode(), card.decode_caches(
                1, 1 + FULL_LEN, memory) as caches:
            assert isinstance(caches, WorkspaceCaches)
            held.set()
            release.wait(60)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(60)
        replays, eager, _ = _counts(card)
        got = decode.student_greedy(card, frames, max_len=FULL_LEN)
        assert torch.equal(got, want)
        assert _counts(card)[0] == replays
        assert _counts(card)[1] - eager == steps
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive()


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["bf16", "int8"])
def test_launch_counts_read_as_the_eager_paths(card, head):
    from rtvc_tpu_torch.ops import int8_gemm, layernorm
    vocab_w8 = card.vocab_w8 if head == "int8" else None
    frames = _card_frames(4, seed=41)

    def counted():
        before = (layernorm.layer_norm.launches, int8_gemm.w8_matmul.launches)
        rows = decode.student_greedy(card, frames, FULL_LEN, vocab_w8)
        after = (layernorm.layer_norm.launches, int8_gemm.w8_matmul.launches)
        return rows, [a - b for a, b in zip(after, before)]

    with pytest.MonkeyPatch.context() as mp:
        _eager(card, mp)
        want, eager = counted()
    decode.student_greedy(card, frames, FULL_LEN, vocab_w8)  # captures
    replays = card.decode_graphs.replays
    got, graphed = counted()
    assert card.decode_graphs.replays > replays
    assert torch.equal(got, want)
    assert graphed == eager


def _is_launch(name):
    """A CUDA API call that puts work on a stream."""
    return any(part in name for part in ("Launch", "Memcpy", "Memset"))


@pytest.mark.cuda
def test_few_host_launches_a_token_lie_outside_the_graph(card, tmp_path):
    frames = _card_frames(1, seed=51)
    decode.student_greedy(card, frames, FULL_LEN)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decode.student_greedy(card, frames, FULL_LEN)
        torch.cuda.synchronize()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    x = [e for e in events if e.get("ph") == "X"]
    host = [e for e in x if e.get("cat") == "user_annotation"]
    tokens = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in host if e["name"] == "rtvc.decode.token"]
    graphs = [e for e in host if e["name"] == "rtvc.decode.graph"]
    calls = [e for e in x if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and _is_launch(e["name"])
             and any(a <= float(e["ts"]) <= b for a, b in tokens)]
    names = collections.Counter(e["name"] for e in calls)
    print(f"launch calls inside {len(tokens)} tokens: {dict(names)}")
    assert len(tokens) == len(graphs) > 0
    graph_calls = sum(n for name, n in names.items() if "Graph" in name)
    assert graph_calls == len(tokens)
    per_token = (len(calls) - graph_calls) / len(tokens)
    print(f"host launches a token outside the graph: {per_token:.2f}")
    assert 1 <= per_token <= 2  # the logits' clone, at most one more


@pytest.mark.cuda
def test_beam_on_the_card_runs_the_eager_body(card):
    frames = _card_frames(2, seed=61)
    replays, eager, captures = _counts(card)
    rows = decode.student_beam(card, frames, max_len=FULL_LEN, k=3)
    assert rows.shape == (2, FULL_LEN)
    assert _counts(card) == (replays, eager + FULL_LEN - 1, captures)


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["train", "grad", "compiling"])
def test_the_gates_on_the_card(card, monkeypatch, why):
    frames = _card_frames(1, seed=71)
    with torch.inference_mode():
        _, memory = card.forward_image_enc(frames)
    memory = memory.clone()
    with torch.no_grad():
        assert graphs.graphs_apply(card, memory)
    if why == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    if why == "train":
        card.train()
    try:
        grad = torch.enable_grad() if why == "grad" else torch.no_grad()
        with grad:
            assert not graphs.graphs_apply(card, memory)
            with card.decode_caches(1, 1 + FULL_LEN, memory) as caches:
                assert not isinstance(caches, WorkspaceCaches)
    finally:
        card.eval()
