"""The student's decode graphs (``rtvc_tpu_torch/models/decode_graph.py``).

On the CPU, on a tiny student: every case where the graphs do not apply
(CPU tensors, train mode, grad on, a compiler tracing, an export's fake
CUDA tensors) takes ``init_cache``'s caches and the eager body;
``student_greedy``'s rows and every step's logits equal a plain loop over
``decode_body``'s; ``student_beam`` runs the eager body; logits of one
step are not overwritten by the next. What it shares with the other
graph users is tested in ``tests/test_torch_graphs.py``.

On the card (marked ``cuda``; skips without one), on the full-width
student in bfloat16: graphed greedy captions equal eager ones bit for bit,
rows and every step's logits, at batch 1, 2, 4 and 8, with the bf16 head
and ``vocab_int8``, over 25 tokens and with an early SEP stop; a step's
logits survive later steps; in-place ``load_state_dict`` and a reassigned
parameter both give the eager result; a second thread holding the
workspace falls back to eager; ``replays`` counts the tokens decoded and
no capture follows the warm-up; the kernels' launch counts read as the
eager path's; fewer than 20 host launches a token lie outside the graph.
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
from rtvc_tpu_torch.models import graphs
from rtvc_tpu_torch.models.decode_graph import WorkspaceCaches
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
    """Graphed against eager: rows and each step's logits bit for bit; the
    graphed step's logits not overwritten; every step a replay."""
    with pytest.MonkeyPatch.context() as mp:
        _eager(model, mp)
        want, eager = _greedy_with_logits(model, frames, max_len, vocab_w8)
    replays = model.decode_graphs.replays
    got, graphed = _greedy_with_logits(model, frames, max_len, vocab_w8)
    assert torch.equal(got, want)
    assert len(graphed.held) == len(eager.held)
    for step, (a, b) in enumerate(zip(graphed.held, eager.held)):
        assert torch.equal(a, b), f"step {step}"
    graphed.assert_unaliased()
    assert model.decode_graphs.replays - replays == len(graphed.held)
    return got, len(graphed.held)


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
    assert 0 < per_token < 20


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
