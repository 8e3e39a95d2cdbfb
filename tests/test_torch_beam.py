"""The port's student beam search against the JAX package's, token for
token.

The tiny student of tests/test_models.py, carried to the port by the weight
bridge (tests/test_torch_models.py), decodes the same seeded inputs through
``rtvc_tpu.decode.student_beam`` and ``rtvc_tpu_torch.decode.student_beam``
(float32; the JAX side at ``default_matmul_precision("highest")``), with
and without the int8 vocab pack, and through both ``make_caption_step(
beam=2)``s. Random weights give near-flat logits, where the ~1e-5 by which
the two float32 paths differ could swap two candidates, so the vocab
projection is scaled up and the test first replays the JAX beam step by
step and asserts that every choice it makes wins by more than 1e-3: each
row's k-th against its (k+1)-th raw logit, the k-th against the (k+1)-th
candidate of the k·k table, and the best final beam against the next.
Ties are left to a test of their own: integer-valued logits, where both
selections must pick the same (score, word, beam) triples in the same
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu import decode as jdecode
from rtvc_tpu import serving as jserving
from rtvc_tpu.ops.preprocess import clip_preprocess as jax_preprocess
from rtvc_tpu.ops.quantization import quantize_vocab_head as jax_vocab_pack
from rtvc_tpu_torch import decode, serving
from rtvc_tpu_torch.ops.quantization import quantize_vocab_head

from test_torch_models import (FRAMES, SIZE, jax_decode_fns, jax_student,
                               port_student)

MAX_LEN = 8
CROP = 64
LOGIT_SCALE = 10.0
MIN_MARGIN = 1e-3


def scaled(variables, scale: float = LOGIT_SCALE):
    """The variables with the vocab projection scaled by ``scale``."""
    params = dict(variables["params"])
    params["linear"] = {k: v * scale for k, v in params["linear"].items()}
    return dict(variables, params=params)


@pytest.fixture(scope="module")
def students():
    jmodel, variables = jax_student()
    variables = scaled(variables)
    return jmodel, variables, port_student(variables)


def _margin(sorted_desc: np.ndarray, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th value of each row of
    rows sorted in descending order."""
    return float((sorted_desc[..., k - 1] - sorted_desc[..., k]).min())


def assert_jax_beam_margins(jmodel, variables, frames, k: int, max_len: int,
                            pack=None) -> np.ndarray:
    """Replay ``rtvc_tpu.decode.student_beam`` on preprocessed ``frames``
    step by step, assert that each choice wins by more than MIN_MARGIN, and
    return the replay's rows (which must equal JAX's own)."""
    b = frames.shape[0]
    prefill, step = jax_decode_fns(jmodel, b, max_len)
    with jax.default_matmul_precision("highest"):
        _, caches = prefill(variables, jnp.asarray(frames))
        cls = jnp.full((b,), jmodel.cls_token_id, jnp.int32)
        logits, caches = step(variables, cls, 0, caches, None, pack)
        logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32)))
        assert _margin(-np.sort(-logp, axis=-1), k) > MIN_MARGIN, "step 0"
        order = np.argsort(-logp, axis=-1, kind="stable")[:, :k]
        scores = np.take_along_axis(logp, order, axis=1)
        seqs = np.zeros((b, k, max_len), np.int32)
        seqs[:, :, 0] = jmodel.cls_token_id
        seqs[:, :, 1] = order
        rep = np.repeat(np.arange(b), k)
        caches = jax.tree.map(lambda a: a[rep], caches)
        for s in range(2, max_len):
            logits, caches = step(variables,
                                  jnp.asarray(seqs[:, :, s - 1].reshape(-1)),
                                  s - 1, caches, None, pack)
            raw = np.asarray(logits.astype(jnp.float32))
            lse = np.asarray(jax.nn.logsumexp(logits.astype(jnp.float32),
                                              axis=-1, keepdims=True))
            assert _margin(-np.sort(-raw, axis=-1), k) > MIN_MARGIN, \
                f"step {s - 1}: a row's top-k words"
            words = np.argsort(-raw, axis=-1, kind="stable")[:, :k]
            cand = (scores[:, :, None] + (np.take_along_axis(raw, words, 1)
                                          - lse).reshape(b, k, k)
                    ).reshape(b, k * k)
            assert _margin(-np.sort(-cand, axis=-1), k) > MIN_MARGIN, \
                f"step {s - 1}: the candidate table"
            pick = np.argsort(-cand, axis=-1, kind="stable")[:, :k]
            beams = pick // k
            seqs = np.take_along_axis(seqs, beams[:, :, None], axis=1)
            seqs[:, :, s] = np.take_along_axis(words.reshape(b, k * k),
                                               pick, 1)
            scores = np.take_along_axis(cand, pick, 1)
            rows = (np.arange(b)[:, None] * k + beams).reshape(-1)
            caches = jax.tree.map(lambda a: a[rows], caches)
    assert _margin(-np.sort(-scores, axis=-1), 1) > MIN_MARGIN, "best beam"
    return seqs[np.arange(b), scores.argmax(-1)]


def assert_jax_greedy_margins(jmodel, variables, frames, max_len: int,
                              pack=None) -> np.ndarray:
    """Replay ``rtvc_tpu.decode.student_greedy`` on preprocessed
    ``frames`` step by step, assert that each argmax wins by more than
    MIN_MARGIN, and return the replay's rows ``[B, 1 + max_len]``."""
    b, total = frames.shape[0], 1 + max_len
    prefill, step = jax_decode_fns(jmodel, b, total)
    tokens = np.zeros((b, total), np.int32)
    tokens[:, 0] = jmodel.cls_token_id
    pos = np.arange(total)[None, :]
    with jax.default_matmul_precision("highest"):
        _, caches = prefill(variables, jnp.asarray(frames))
        for i in range(max_len):
            mask = (pos <= i) & (tokens != 0)
            logits, caches = step(variables, jnp.asarray(tokens[:, i]), i,
                                  caches, jnp.asarray(mask), pack)
            logits = np.asarray(logits)
            assert _margin(-np.sort(-logits, axis=-1), 1) > MIN_MARGIN, \
                f"step {i}"
            tokens[:, i + 1] = logits.argmax(-1)
            if (tokens[:, i + 1] == jmodel.sep_token_id).all():
                break
    return tokens


def jax_preprocessed(windows: np.ndarray, crop: int) -> np.ndarray:
    """uint8 windows ``[B, W, H, Wd, 3]`` through JAX's clip_preprocess."""
    b, w = windows.shape[:2]
    proc = jax_preprocess(jnp.asarray(windows.reshape(
        (b * w,) + windows.shape[2:])), crop_size=crop)
    return np.asarray(proc).reshape((b, w) + proc.shape[1:])


def _frames(seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(3, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("vocab_w8", [False, True])
def test_student_beam_rows_equal_jax(students, vocab_w8, k):
    jmodel, variables, port = students
    frames = _frames()
    jpack = jax_vocab_pack(variables) if vocab_w8 else None
    replay = assert_jax_beam_margins(jmodel, variables, frames, k, MAX_LEN,
                                     jpack)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdecode.student_beam(
            jmodel, variables, jnp.asarray(frames), max_len=MAX_LEN, k=k,
            vocab_w8=jpack))
    np.testing.assert_array_equal(replay, want)
    got = decode.student_beam(
        port, torch.from_numpy(frames), max_len=MAX_LEN, k=k,
        vocab_w8=quantize_vocab_head(port.linear) if vocab_w8 else None)
    assert got.dtype == torch.int32 and got.shape == (3, MAX_LEN)
    assert (got[:, 0] == port.cls_token_id).all()
    np.testing.assert_array_equal(got.numpy(), want)


def _windows() -> np.ndarray:
    """A dark and a bright window, so that the two rows differ."""
    w = np.random.default_rng(12).integers(
        0, 128, size=(2, FRAMES, 80, 96, 3), dtype=np.uint8)
    w[1] += 128
    return w


@pytest.mark.parametrize("vocab_int8", [False, True])
def test_beam_caption_step_equals_jax(students, vocab_int8):
    jmodel, variables, port = students
    windows = _windows()
    jvars = jserving.with_vocab_w8(variables) if vocab_int8 else variables
    proc = jax_preprocessed(windows, CROP)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jserving.make_caption_step(
            jmodel, max_len=MAX_LEN, beam=2, crop_size=CROP,
            vocab_int8=vocab_int8)(jvars, jnp.asarray(windows)))
    replay = assert_jax_beam_margins(
        jmodel, variables, proc, 2, MAX_LEN,
        jvars["vocab_w8"] if vocab_int8 else None)
    np.testing.assert_array_equal(replay, want)
    if vocab_int8:
        serving.with_vocab_w8(port)
    got = serving.make_caption_step(port, max_len=MAX_LEN, beam=2,
                                    crop_size=CROP, vocab_int8=vocab_int8)(
        torch.from_numpy(windows))
    assert got.dtype == torch.int32 and got.shape == (2, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_select(raw: np.ndarray, scores: np.ndarray):
    """``rtvc_tpu.decode.student_beam``'s in-loop selection, verbatim."""
    b, k = scores.shape
    raw, scores = jnp.asarray(raw), jnp.asarray(scores)
    top_raw, top_words = jax.lax.top_k(raw, k)
    lse = jax.nn.logsumexp(raw, axis=-1, keepdims=True)
    top_scores = (top_raw - lse).reshape(b, k, k)
    cand_scores = (scores[:, :, None] + top_scores).reshape(b, k * k)
    cand_words = top_words.reshape(b, k * k)
    cand_beams = jnp.repeat(jnp.arange(k), k)[None, :]
    best_scores, best_idx = jax.lax.top_k(cand_scores, k)
    sel_beams = jnp.take_along_axis(
        jnp.broadcast_to(cand_beams, (b, k * k)), best_idx, axis=1)
    sel_words = jnp.take_along_axis(cand_words, best_idx, axis=1)
    return (np.asarray(best_scores), np.asarray(sel_beams),
            np.asarray(sel_words))


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("probe", ["normal", "integer"])
def test_beam_select_matches_jax_including_ties(probe, k):
    """The same (score, word, beam) triples in the same order as JAX's
    selection, and as the flat ``top_k(log_softmax + score, k·V)`` both
    stand for. Integer-valued logits and scores rounded to 0.1 force heavy
    ties, which ``jax.lax.top_k`` breaks lowest index first."""
    rng = np.random.default_rng(3 + k)
    b, vocab = 3, 50
    raw = (rng.normal(size=(b * k, vocab)) if probe == "normal" else
           rng.integers(0, 3, size=(b * k, vocab))).astype(np.float32)
    scores = rng.normal(size=(b, k)).round(1).astype(np.float32)
    if probe == "integer":
        scores[:, 1] = scores[:, 0]  # two beams tied, every word tied
    want_scores, want_beams, want_words = _jax_select(raw, scores)
    got_scores, got_beams, got_words = decode.beam_select(
        torch.from_numpy(raw), torch.from_numpy(scores))
    np.testing.assert_array_equal(got_words.numpy(), want_words)
    np.testing.assert_array_equal(got_beams.numpy(), want_beams)
    np.testing.assert_allclose(got_scores.numpy(), want_scores, rtol=1e-6,
                               atol=1e-6)

    flat = (jax.nn.log_softmax(jnp.asarray(raw), axis=-1)
            + jnp.asarray(scores).reshape(-1, 1)).reshape(b, k * vocab)
    flat_scores, flat_idx = jax.lax.top_k(flat, k)
    np.testing.assert_array_equal(got_words.numpy(),
                                  np.asarray(flat_idx) % vocab)
    np.testing.assert_array_equal(got_beams.numpy(),
                                  np.asarray(flat_idx) // vocab)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(flat_scores),
                               rtol=1e-6, atol=1e-6)


def test_top_k_breaks_ties_as_jax():
    x = np.random.default_rng(5).integers(0, 4, size=(6, 40)).astype(
        np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 7)
    got_v, got_i = decode.top_k(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_gather_cache_returns_fresh_rows():
    """A beam's in-place cache write must never reach a row another beam
    reads: gathered caches share no memory with their source."""
    src = [{"k": torch.arange(24.0).reshape(4, 1, 3, 2),
            "mem_k": torch.ones(4, 1, 2, 2)}]
    out = decode._gather_cache(src, torch.tensor([0, 0, 2, 2]))
    before = src[0]["k"].clone()
    out[0]["k"][:, :, 1] = -1.0
    out[0]["mem_k"].zero_()
    assert torch.equal(src[0]["k"], before)
    assert torch.equal(src[0]["mem_k"], torch.ones(4, 1, 2, 2))
    assert torch.equal(out[0]["k"][0], out[0]["k"][1])
