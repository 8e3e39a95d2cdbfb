"""Kimi-VL-A3B as a captioner (``models/moonvit.py``, ``kimi_lm.py``,
``kimi_vl.py``) against its plain float32 reference
(``models/kimi_vl_reference.py``), and its serving path.

On the CPU, at a small size in float32 (hidden 64; 4 layers, 1 dense and
3 MoE; 8 experts, 2 a token, 1 shared; latent 32, rope 16; MoonViT width
48, 2 blocks, 112-px frames), on seeded weights whose every bias, norm
scale and correction bias is drawn: the prefill and the greedy decode
through the latent caches give the reference's full-forward logits at
every generated position; the absorbed decode equals expanded attention;
the router's cases; the 2D RoPE's angles; the grouped experts equal the
per-expert loop; ``make_caption_step`` and ``BatchCaptionServer`` serve
the model, stop early only when every row emits EOS, and count routed
tokens on the device.

On the card (marked ``cuda``; skips without one), at the published
widths in bfloat16: the caption step at batch 1 and 8; at those batches'
prefill sizes, one MoE layer's grouped experts against the per-expert
loop, and one layer's absorbed decode against the eager expanded
attention (layer by layer: with random weights an expert choice flips on
rounding and moves every later layer, so whole-model outputs of two
orders of summation differ by more than rounding); a decode token
synchronises once, at its stop;
the decode graphs' rows, logits and routed-token counts equal the eager
decode's bit for bit; the student's caption rows through
``make_caption_step`` and
``BatchCaptionServer`` equal ``student_greedy``'s. The file imports no
JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kimi_vl.py
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from rtvc_tpu_torch import decode, serving
from rtvc_tpu_torch.config import KimiVLConfig, MoonViTConfig
from rtvc_tpu_torch.models import graphs, kimi_lm, moonvit
from rtvc_tpu_torch.models.kimi_vl import kimi_vl_from_config, random_init_
from rtvc_tpu_torch.models.kimi_vl_reference import (KimiVLReference,
                                                     strict_float32,
                                                     vision_angles)
from rtvc_tpu_torch.ops.preprocess import clip_preprocess

SMALL = KimiVLConfig(
    vision=MoonViTConfig(image_size=112, width=48, layers=2, heads=4,
                         mlp=96, pos_grid=6),
    vocab_size=512, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
    n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
    v_head_dim=16, eos_token_id=7, dtype=torch.float32)
PROMPT = list(range(100, 116))
MEDIA_AT = 8
NEW = 6
# float32 on both sides; the program reassociates (the absorbed decode
# multiplies through W_UK and W_UV in another order, SDPA blocks its
# sums), which moves logits of magnitude ~4 by a few 1e-6
TOL = 1e-4


def small(seed: int = 1, cfg: KimiVLConfig = SMALL):
    torch.manual_seed(0)
    model = kimi_vl_from_config(cfg, device="cpu")
    random_init_(model, torch.Generator().manual_seed(seed))
    model.set_prompt(PROMPT, MEDIA_AT)
    return model


def frames_u8(b: int, f: int = 3, size: int = 112, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, f, size, size, 3), generator=g,
                         dtype=torch.uint8)


def normalised(model, frames):
    b, f = frames.shape[:2]
    proc = clip_preprocess(frames.flatten(0, 1), crop_size=model.image_size,
                           mean=model.pixel_mean, std=model.pixel_std)
    return proc.reshape((b, f) + proc.shape[1:])


def reference_of(model):
    strict_float32()
    params = {k: v.detach() for k, v in model.named_parameters()}
    return KimiVLReference(dataclasses.asdict(model.cfg), params)


def tapped_greedy(model, proc, new=NEW):
    """``vlm_greedy``'s rows and the logits of each generated position."""
    logits = []
    prefill, step = model.prefill, model.decode_step

    def tap_prefill(*a, **k):
        out = prefill(*a, **k)
        logits.append(out[0].clone())
        return out

    def tap_step(*a, **k):
        out = step(*a, **k)
        logits.append(out.clone())
        return out

    model.prefill, model.decode_step = tap_prefill, tap_step
    try:
        rows = decode.vlm_greedy(model, proc, new)
    finally:
        del model.prefill, model.decode_step
    return rows, torch.stack(logits, 1)


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return small()


def test_prefill_and_cached_decode_equal_the_full_forward(model):
    proc = normalised(model, frames_u8(2))
    rows, logits = tapped_greedy(model, proc)
    assert rows.shape == (2, NEW) and logits.shape[:2] == (2, NEW)
    ref = reference_of(model)
    for r in range(2):
        out = ref.forward(proc[r], PROMPT, MEDIA_AT, rows[r].tolist())
        assert out["prompt_length"] == len(PROMPT) + 3 * 16
        err = (logits[r] - out["logits"]).abs().max()
        assert float(err) < TOL, (r, float(err))
    # the rows depend on the frames
    assert not torch.equal(rows[0], rows[1])


def test_absorbed_decode_equals_expanded_attention(model):
    """The last position's attention output: absorbed over the latent
    cache, and expanded as the prefill computes it over the whole row."""
    attn = model.language_model.layers[1].self_attn
    lm = model.language_model
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 9, SMALL.hidden_size, generator=g)
    angles = lm.angles(12, "cpu")
    full = lm.latent_caches(2, 9, "cpu", torch.float32)[0]
    ang = angles[:9, None]
    expanded = attn.prefill(x, ang.cos(), ang.sin(), full)
    # three slots past the position hold what a later token would: masked
    cache = torch.randn(2, 12, full.shape[-1], generator=g)
    attn.prefill(x[:, :8], ang[:8].cos(), ang[:8].sin(), cache)
    absorbed = attn.decode(x[:, 8], angles, cache, torch.tensor([8]))
    assert torch.allclose(absorbed, expanded[:, 8], atol=1e-5), \
        float((absorbed - expanded[:, 8]).abs().max())
    assert torch.allclose(cache[:, :9], full, atol=1e-6)


def _router(bias, norm=True):
    cfg = dataclasses.replace(SMALL, norm_topk_prob=norm)
    r = kimi_lm.Router(cfg)
    with torch.no_grad():
        r.weight.copy_(torch.randn(r.weight.shape,
                                   generator=torch.Generator().manual_seed(2)))
        r.e_score_correction_bias.copy_(bias)
    return r


def test_correction_bias_changes_the_choice_not_the_weights():
    x = torch.randn(16, SMALL.hidden_size,
                    generator=torch.Generator().manual_seed(3))
    zero = torch.zeros(SMALL.n_routed_experts)
    idx0, w0 = _router(zero)(x)
    pushed = zero.clone()
    pushed[5] = 10.0  # expert 5 chosen for every token
    idx1, w1 = _router(pushed)(x)
    assert (idx1 == 5).any(1).all()
    assert not (idx0 == 5).any(1).all()
    scores = torch.sigmoid(x @ _router(zero).weight.T)
    for idx, w in ((idx0, w0), (idx1, w1)):
        raw = scores.gather(1, idx)
        expect = raw / raw.sum(1, keepdim=True) * SMALL.routed_scaling_factor
        assert torch.allclose(w, expect, atol=1e-6)


@pytest.mark.parametrize("norm", [True, False])
def test_router_normalisation_and_scale(norm):
    x = torch.randn(16, SMALL.hidden_size,
                    generator=torch.Generator().manual_seed(4))
    r = _router(torch.zeros(SMALL.n_routed_experts), norm=norm)
    idx, w = r(x)
    raw = torch.sigmoid(x @ r.weight.T).gather(1, idx)
    if norm:
        assert torch.allclose(w.sum(1), torch.full((16,), 2.446), atol=1e-5)
    else:
        assert torch.allclose(w, raw * 2.446, atol=1e-6)


def test_shared_expert_is_added_once(model):
    moe = model.language_model.layers[2].mlp
    x = torch.randn(10, SMALL.hidden_size,
                    generator=torch.Generator().manual_seed(6))
    idx, w = moe.gate(x)
    routed = moe.experts.looped(x, idx, w)
    assert torch.allclose(moe(x) - routed, moe.shared_experts(x),
                          atol=1e-5)


def test_reference_replays_given_routes(model):
    proc = normalised(model, frames_u8(1))
    ref = reference_of(model)
    own = ref.forward(proc[0], PROMPT, MEDIA_AT, [5, 6, 7])
    same = ref.forward(proc[0], PROMPT, MEDIA_AT, [5, 6, 7],
                       routes=own["routes"])
    assert torch.equal(same["logits"], own["logits"])
    moved = [(r + 1) % SMALL.n_routed_experts for r in own["routes"]]
    other = ref.forward(proc[0], PROMPT, MEDIA_AT, [5, 6, 7], routes=moved)
    assert not torch.allclose(other["logits"], own["logits"], atol=1e-3)
    # the reported choices are the layer's own, of its own inputs
    assert torch.equal(other["routes"][0], own["routes"][0])


def test_grouped_experts_equal_the_loop(model):
    moe = model.language_model.layers[3].mlp
    x = torch.randn(37, SMALL.hidden_size,
                    generator=torch.Generator().manual_seed(7))
    idx, w = moe.gate(x)
    counts = torch.bincount(idx.reshape(-1),
                            minlength=SMALL.n_routed_experts)
    grouped = moe.experts.grouped(x, idx, w, counts)
    assert torch.allclose(grouped, moe.experts.looped(x, idx, w), atol=1e-5)


def test_2d_rope_angles_as_written():
    rows, cols, hd, theta = 3, 5, 12, 10000.0
    ang = moonvit.rope_2d_angles(rows, cols, hd, theta)
    assert ang.shape == (rows * cols, hd // 2)
    for r in range(rows):
        for c in range(cols):
            for i in range(hd // 4):
                f = theta ** (-4.0 * i / hd)
                assert ang[r * cols + c, 2 * i].item() == pytest.approx(c * f)
                assert ang[r * cols + c, 2 * i + 1].item() == \
                    pytest.approx(r * f)
    assert torch.allclose(ang, vision_angles(rows, cols, hd, theta, "cpu"))


def test_merge_is_row_major_over_each_neighbourhood():
    x = torch.arange(4 * 6, dtype=torch.float32).view(1, 24, 1)
    merged = moonvit.merge_patches(x, 4, 6, 2)
    assert merged.shape == (1, 6, 4, 1)
    assert merged[0, 0, :, 0].tolist() == [0, 1, 6, 7]
    assert merged[0, 4, :, 0].tolist() == [14, 15, 20, 21]


def test_served_through_batch_caption_server(model):
    frames = frames_u8(3, seed=9)
    step = serving.make_caption_step(model, max_len=NEW)
    rows = step(frames).numpy()
    with pytest.raises(ValueError, match="greedily"):
        serving.make_caption_step(model, beam=2)
    model.reset_expert_load()
    with serving.BatchCaptionServer(
            model, None, max_batch=4, max_wait_ms=50, max_len=NEW,
            buckets=(1, 2, 4), frame_shape=(112, 112, 3), window=3,
            warmup=False) as srv:
        futs = [srv.submit(frames[i].numpy()) for i in range(3)]
        got = [f.tokens(timeout=60) for f in futs]
        assert [f.result(timeout=1) for f in futs] == [None] * 3
        assert srv.stats()["expert_load_max_over_mean"] >= 1.0
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], serving.truncate_at_sep(rows[i], SMALL.eos_token_id))
    load = model.expert_load()
    assert load.shape == (3, SMALL.n_routed_experts)
    # every token of a served batch routed k times in every MoE layer
    totals = load.sum(1)
    assert (totals == totals[0]).all() and int(totals[0]) > 0
    assert int(totals[0]) % SMALL.num_experts_per_tok == 0


def test_stops_only_when_every_row_emits_eos(model, monkeypatch):
    """Row 0 emits EOS from the first decode step on, row 1 at the third:
    the loop runs three decode steps and leaves 0 after them."""
    eos, v = SMALL.eos_token_id, SMALL.vocab_size
    prefill = model.prefill
    calls = []

    def one_hot(ids):
        out = torch.zeros(len(ids), v)
        out[torch.arange(len(ids)), torch.tensor(ids)] = 1.0
        return out

    def fake_prefill(visual, new):
        _, state = prefill(visual, new)
        return one_hot([5, 5]), state

    def fake_step(token, pos, state):
        calls.append(pos)
        return one_hot([eos, eos if len(calls) == 3 else 9])

    monkeypatch.setattr(model, "prefill", fake_prefill)
    monkeypatch.setattr(model, "decode_step", fake_step)
    rows = decode.vlm_greedy(model, normalised(model, frames_u8(2)), NEW)
    length = len(PROMPT) + 3 * 16
    assert calls == [length, length + 1, length + 2]
    assert rows.tolist() == [[5, eos, eos, eos, 0, 0], [5, 9, 9, eos, 0, 0]]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full():
    """The published widths in bfloat16 on the card, drawn there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rtvc_tpu_torch.config import kimi_vl_a3b_config
    model = kimi_vl_from_config(kimi_vl_a3b_config(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    random_init_(model, gen)
    model.set_prompt(list(range(1000, 1016)), 8)
    return model


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_card_prefill_and_decode_at_the_published_widths(full, batch):
    frames = frames_u8(batch, f=2, size=448, seed=batch).cuda()
    with torch.inference_mode():
        rows = serving.make_caption_step(full, max_len=3)(frames)
    assert rows.shape == (batch, 3) and rows.dtype == torch.int32
    assert bool(((rows >= 0) & (rows < 163840)).all())


# bf16 on both sides, summed in other orders: relative RMS differences of
# a few 1e-3; a wrong expert, weight or cache entry moves the output by
# its own size
CARD_TOL = 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_card_grouped_experts_equal_the_loop(full, batch):
    """One MoE layer over a prefill's tokens (``batch`` rows of 4,112)."""
    moe = full.moe_layers()[0]
    g = torch.Generator(device="cuda").manual_seed(batch)
    x = torch.randn(batch * 4112, 2048, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        idx, w = moe.gate(x)
        counts = torch.bincount(idx.reshape(-1), minlength=64)
        grouped = moe.experts.grouped(x, idx, w, counts)
        looped = moe.experts.looped(x, idx, w)
    assert _rel(grouped, looped) < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_card_absorbed_decode_equals_eager_attention(full, batch):
    """One layer's attention at position 4,112 over the latent cache,
    against the expanded attention of a prefill one position longer."""
    attn = full.language_model.layers[1].self_attn
    lm = full.language_model
    g = torch.Generator(device="cuda").manual_seed(batch)
    x = torch.randn(batch, 4113, 2048, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        angles = lm.angles(4176, "cuda")
        ang = angles[:4113, None]
        cache = lm.latent_caches(batch, 4113, "cuda", torch.bfloat16)[0]
        eager = attn.prefill(x, ang.cos(), ang.sin(), cache)[:, -1]
        # the slots past the position hold what later tokens would
        cache = torch.randn(batch, 4176, cache.shape[-1], generator=g,
                            device="cuda", dtype=torch.bfloat16)
        attn.prefill(x[:, :-1], ang[:-1].cos(), ang[:-1].sin(), cache)
        absorbed = attn.decode(x[:, -1], angles, cache,
                               torch.tensor([4112], device="cuda"))
    assert _rel(absorbed, eager) < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_card_graphed_decode_equals_eager(full, batch, monkeypatch):
    """The decode graphs replay the eager body: rows and every step's
    logits bit for bit, the routed-token counts alike."""
    proc = normalised(full, frames_u8(batch, f=2, size=448, seed=3).cuda())
    out = {}
    for graphed in (False, True):
        replays = full.decode_graphs.replays
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(graphs, "graphs_apply", lambda *a: False)
            full.reset_expert_load()
            rows, logits = tapped_greedy(full, proc, new=5)
        out[graphed] = (rows, logits, full.expert_load())
        assert (full.decode_graphs.replays > replays) == graphed
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert torch.equal(out[True][2], out[False][2])
    # a second call replays the graphs captured by the first
    captures = full.decode_graphs.captures
    rows, logits = tapped_greedy(full, proc, new=5)
    assert torch.equal(rows, out[True][0]) and torch.equal(logits,
                                                           out[True][1])
    assert full.decode_graphs.captures == captures


@pytest.mark.cuda
def test_card_decode_token_synchronises_once(full):
    proc = normalised(full, frames_u8(2, f=1, size=448).cuda())
    with torch.inference_mode():
        logits, state = full.prefill(full.encode(proc), 3)
        tok = torch.argmax(logits, -1)
        try:
            full.decode_step(tok, state.length, state)  # warm: the capture
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = full.decode_step(tok, state.length + 1, state)
                nxt = torch.argmax(out, -1)
                stop = bool((nxt == full.eos_token_id).all())
        finally:
            torch.cuda.set_sync_debug_mode(0)
            state.release()
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert stop in (True, False)


@pytest.mark.cuda
def test_card_student_rows_unchanged_by_the_dispatch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.models.student import (random_init_ as student_init,
                                               student_from_config)
    from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer
    student = student_from_config(cfg, device="cpu")
    student_init(student, torch.Generator().manual_seed(3))
    with torch.no_grad():
        student.linear.weight.mul_(10)
    student = student.to("cuda", torch.bfloat16).eval()
    for b in (1, 2, 4, 8):
        frames = frames_u8(b, f=6, size=224, seed=b).cuda()
        rows = serving.make_caption_step(student, max_len=25)(frames)
        proc = clip_preprocess(frames.flatten(0, 1)).reshape(
            b, 6, 224, 224, 3)
        direct = decode.student_greedy(student, proc, max_len=25)
        assert torch.equal(rows, direct), b
    frames = frames_u8(8, f=6, size=224, seed=8)
    with serving.BatchCaptionServer(
            student, BertWordPieceTokenizer(), max_batch=8, max_wait_ms=50,
            warmup=False) as srv:
        futs = [srv.submit(frames[i].numpy()) for i in range(8)]
        got = [f.tokens(timeout=120) for f in futs]
    for i in range(8):
        np.testing.assert_array_equal(
            got[i], serving.truncate_at_sep(rows[i].cpu().numpy()))
