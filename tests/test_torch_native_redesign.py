"""The rules K4n and K8n (the input-dtype softmax's flash kernels,
``rtvc_tpu_torch/csrc/flash_attention_sm90.cu`` and
``flash_attention_bwd_sm90.cu``) rely on, on the CPU.

(a) The product-only max sweep: for a positive scale, the max over keys of
    bf16(bf16(s) * bf16(scale)) is bf16(bf16(max s) * bf16(scale)), with a
    disallowed key below Lkv standing in as bf16(-1e30); a negative scale
    breaks it, which is why the kernel guards it.
(b) Packed bf16 arithmetic: one bf16 rounding of the exact x - m and x * c
    of two bf16 values is bf16(float32 op), which the per-score kernels
    took.
(c) The exact fast exponential: its fallback rule, emulated in numpy on all
    2^15 non-positive bf16 d with an exponential off by the error the card
    measured, reaches bf16(expf(d)) everywhere; without the fallback it
    does not.
(d) The row statistics K4n leaves for K8n: their plain version against the
    quantities of JAX's ``_block_probs``; ``flash_attention_bwd_plain`` fed
    them gives the bits it gives without; a forward keeps statistics only
    where autograd will need them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.ops import attention as jattention
from rtvc_tpu_torch.ops import attention

MASKED = torch.tensor(-1e30, dtype=torch.bfloat16).float()


def _bf16(x) -> torch.Tensor:
    """float32 values rounded to bf16 (nearest even) and widened back."""
    return torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16).float()


def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """float64 values rounded once to bf16 (8 significant bits, nearest
    even), as float64; normal range only."""
    m, e = np.frexp(x)
    return np.ldexp(np.rint(m * 256.0) / 256.0, e)


# ---------------------------------------------------------------------------
# (a) the max identity
# ---------------------------------------------------------------------------

def _scores(rng, rows: int, keys: int) -> np.ndarray:
    """Seeded float32 scores over wide ranges, with exact ties and values
    that differ in float32 but round to one bf16 value."""
    mag = 10.0 ** rng.uniform(-3, 4, size=(rows, 1))
    s = (rng.normal(size=(rows, keys)) * mag).astype(np.float32)
    s[:, 5] = s[:, 3]                          # an exact tie
    s[:, 7] = np.nextafter(s[:, 3], np.inf)    # a tie in bf16 only
    s[::3, 9] = s[::3].max(axis=1)             # ties at the max
    return s


def _per_score_max(s, allowed, inside, scale):
    y = _bf16(_bf16(s) * _bf16(scale))
    y = torch.where(allowed, y, MASKED)
    y = torch.where(inside, y, torch.tensor(-np.inf))
    return y.max(dim=-1).values


def _raw_max_rule(s, allowed, inside, scale):
    """The kernel's sweep 1: the raw max of the allowed keys, mapped once;
    bf16(-1e30) where a disallowed key below Lkv outranks it."""
    raw = torch.where(allowed & inside, s, torch.tensor(-np.inf))
    m = _bf16(_bf16(raw.max(dim=-1).values) * _bf16(scale))
    flag = (inside & ~allowed).any(dim=-1)
    return torch.maximum(m, torch.where(flag, MASKED,
                                        torch.tensor(-np.inf)))


@pytest.mark.parametrize("scale", [64 ** -0.5, 40 ** -0.5, 32 ** -0.5, 3.7])
def test_max_of_mapped_scores_is_mapped_raw_max(scale):
    rng = np.random.default_rng(7)
    rows, keys, lkv = 600, 80, 71                # keys past Lkv: -inf
    s = torch.from_numpy(_scores(rng, rows, keys))
    allowed = torch.from_numpy(rng.random((rows, keys)) > 0.3)
    allowed[::10] = False                         # fully masked rows
    allowed[1::10, :40] = False                   # the max among the masked
    inside = (torch.arange(keys) < lkv).expand(rows, keys)
    want = _per_score_max(s, allowed, inside, scale)
    got = _raw_max_rule(s, allowed, inside, scale)
    assert torch.equal(got, want)
    assert bool((want[::10] == MASKED).all())     # fully masked rows


def test_max_identity_fails_for_a_negative_scale():
    """For scale < 0 the map reverses the order, so the raw max no longer
    gives the max: the kernel takes the scores themselves there."""
    rng = np.random.default_rng(8)
    s = torch.from_numpy(_scores(rng, 50, 64))
    every = torch.ones(50, 64, dtype=torch.bool)
    got = _raw_max_rule(s, every, every, -0.125)
    want = _per_score_max(s, every, every, -0.125)
    assert not torch.equal(got, want)


# ---------------------------------------------------------------------------
# (b) one rounding of the exact result = bf16(float32 op)
# ---------------------------------------------------------------------------

def _bf16_sample(rng, n: int) -> np.ndarray:
    """n bf16 values (as float64): random 8-bit significands, exponents in
    [-40, 40], both signs; exponent gaps between two of them reach 80."""
    sig = rng.integers(128, 256, size=n) / 128.0
    exp = rng.integers(-40, 41, size=n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return sign * np.ldexp(sig, exp)


def test_packed_ops_round_the_exact_result_as_float32_then_bf16():
    rng = np.random.default_rng(9)
    a = _bf16_sample(rng, 1500)[:, None]
    b = _bf16_sample(rng, 1500)[None, :]
    gaps = np.abs(np.frexp(a)[1] - np.frexp(b)[1])
    assert gaps.max() > 16 and (gaps > 16).mean() > 0.5
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    for exact, f32 in ((a - b, a32 - b32), (a * b, a32 * b32)):
        # float64 holds a difference exactly up to a gap of 45; beyond it
        # the smaller operand is far below both roundings
        nonzero = exact != 0
        once = _rne_bf16(exact[nonzero])
        twice = _rne_bf16(f32.astype(np.float64)[nonzero])
        assert np.array_equal(once, twice)


# ---------------------------------------------------------------------------
# (c) the exact fast exponential's fallback rule
# ---------------------------------------------------------------------------

# the largest |y 2^-10 / expf(d) - 1| of ex2.approx where expf(d) is a
# normal float32, as chip_smoke's probe measured it on an NVIDIA H100 80GB
# HBM3 (3.338e-6)
CARD_EXP_REL_ERR = 3.34e-6
SHIFT = 10.0
EPS = 2.0 ** -17
LO = np.float32(2.0 ** -SHIFT * (1 - EPS))
HI = np.float32(2.0 ** -SHIFT * (1 + EPS))


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even) as their bit
    patterns, subnormals included."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


def _domain() -> np.ndarray:
    """Every bf16 d <= 0 (and -inf) as float64: 0 and the 2^15 negative
    patterns up to -inf."""
    bits = np.concatenate([[0], np.arange(0x8000, 0xFF81)]).astype(np.uint32)
    return (bits << 16).view(np.float32).astype(np.float64)


def _fast_exp(d: np.ndarray, rel: float, fallback: bool) -> np.ndarray:
    with np.errstate(over="ignore", under="ignore"):
        y = np.float32(np.exp(d) * 2.0 ** SHIFT * (1 + rel))
    y = np.where(y < 2.0 ** -126, np.float32(0), y)      # ex2.approx.ftz
    lo, hi = _f32_to_bf16(y * LO), _f32_to_bf16(y * HI)
    want = _f32_to_bf16(np.float32(np.exp(d)))
    return np.where(lo == hi, lo, want) if fallback else lo


def test_fast_exponential_reaches_expf_bits_on_the_whole_domain():
    d = _domain()
    assert d.size == 32642
    with np.errstate(under="ignore"):
        want = _f32_to_bf16(np.float32(np.exp(d)))
    for rel in (-CARD_EXP_REL_ERR, CARD_EXP_REL_ERR):
        with np.errstate(under="ignore"):
            assert np.array_equal(_fast_exp(d, rel, True), want)
            # the same rule without the fallback flips inputs
            assert (_fast_exp(d, rel, False) != want).sum() > 0


def test_bracket_covers_the_card_error():
    """The rule is exact where expf(d) lies in [y LO, y HI]: the card's
    error must be inside that bracket, with room for float32 roundings."""
    assert CARD_EXP_REL_ERR + 2.0 ** -22 < EPS


# ---------------------------------------------------------------------------
# (d) the row statistics
# ---------------------------------------------------------------------------

B, H, LQ, LKV, D = 2, 2, 67, 71, 32
LIMIT = 2 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, H, n, D)).astype(np.float32)
                 for n in (LQ, LKV, LKV, LQ))


def _mask(kind):
    if kind is None:
        return None
    m = np.repeat((np.arange(LKV) < 59)[None, :], B, axis=0)
    if kind == "row":
        m[1] = False
    return m


CASES = {
    "prefix-causal": dict(causal=True, prefix_len=5),
    "key-masked": dict(causal=True, prefix_len=5, mask="keys"),
    "fully masked batch row": dict(causal=False, prefix_len=0, mask="row"),
}


def _jax_row_stats(q, k, mask, causal, prefix_len, scale):
    """(max, bf16(1 / z)) per row by ``_block_probs``' own jnp ops with
    ``softmax_native``, over the whole [Lq, Lkv] block."""
    acc = jnp.bfloat16
    s = jax.lax.dot_general(
        jnp.asarray(q).astype(acc), jnp.asarray(k).astype(acc),
        (((3,), (3,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.float32).astype(acc) \
        * jnp.asarray(scale, acc)
    k_idx = jnp.arange(LKV)[None, :]
    valid = jnp.ones((LQ, LKV), bool)
    if causal:
        valid = (k_idx < prefix_len) | (k_idx <= jnp.arange(LQ)[:, None])
    valid = valid[None, None]
    if mask is not None:
        valid = valid & jnp.asarray(mask)[:, None, None, :]
    s = jnp.where(valid, s, jnp.asarray(jattention._NEG_INF, acc))
    m = jnp.max(s, axis=-1, keepdims=True)
    e = jnp.exp(s - m)
    z = jnp.sum(e.astype(jnp.float32), axis=-1, keepdims=True)
    return (np.asarray(m.astype(jnp.float32)),
            np.asarray((1.0 / z).astype(acc).astype(jnp.float32)))


def _t(a):
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16)


@pytest.mark.parametrize("case", list(CASES))
def test_row_stats_plain_match_jax_block_probs(case):
    c = CASES[case]
    q, k, v, g = _inputs(21)
    mask = _mask(c.get("mask"))
    scale = D ** -0.5
    kw = dict(causal=c["causal"], prefix_len=c["prefix_len"], scale=scale,
              kv_mask=None if mask is None else torch.from_numpy(mask))
    got = attention.flash_attention_stats_plain(_t(q), _t(k), **kw)
    assert got.shape == (B, H, LQ, 2) and got.dtype == torch.float32
    with jax.default_matmul_precision("highest"):
        jm, jrz = _jax_row_stats(q, k, mask, c["causal"], c["prefix_len"],
                                 scale)
    for what, a, b in (("max", got[..., :1], jm), ("1/z", got[..., 1:], jrz)):
        a = a.numpy()
        err = np.abs(a - b).max() / np.abs(b).max()
        print(f"{case} {what}: max|diff| {err:.2e}, bit-equal "
              f"{float((a == b).mean()):.4f}")
        assert err <= LIMIT
    if c.get("mask") == "row":
        assert bool((got[1, ..., 0] == MASKED).all())
    # the CPU wrapper is the plain version
    assert torch.equal(attention.flash_attention_stats(_t(q), _t(k), **kw),
                       got)


def test_jax_block_probs_against_probs_from_the_port_stats():
    """``_block_probs`` with ``softmax_native`` (JAX's own function) gives
    the probabilities that the port's statistics give."""
    q, k, v, _ = _inputs(22)
    scale = D ** -0.5
    kw = dict(causal=True, prefix_len=5, kv_mask=None)
    stats = attention.flash_attention_stats_plain(_t(q), _t(k), scale=scale,
                                                  **kw)
    p, _ = attention._flash_probs(_t(q), _t(k), True, 5, None, scale, 0.0,
                                  None, True, stats)
    with jax.default_matmul_precision("highest"):
        for b in range(B):
            kb, vb = jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1])
            for hh in range(H):
                jp, _, _, _ = jattention._block_probs(
                    kb.astype(jnp.bfloat16), vb.astype(jnp.bfloat16), None,
                    jnp.asarray(q[b, hh]).astype(jnp.bfloat16), hh, b, 0,
                    scale=scale, causal=True, prefix_len=5, block_q=LQ,
                    lkv_valid=LKV, masked_kv=False, dropout_rate=0.0,
                    seed_ref=None, ghi=hh, softmax_native=True)
                jp = np.asarray(jp.astype(jnp.float32))
                err = np.abs(p[b, hh].numpy() - jp).max() / jp.max()
                assert err <= LIMIT


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_plain_from_the_stats_gives_the_same_bits(rate):
    q, k, v, g = (_t(a) for a in _inputs(23))
    kw = dict(causal=True, prefix_len=5, scale=D ** -0.5,
              kv_mask=torch.from_numpy(_mask("row")), dropout_rate=rate,
              seed=4321 if rate else None, softmax_in_input_dtype=True)
    stats = attention.flash_attention_stats_plain(
        q, k, causal=True, prefix_len=5, scale=D ** -0.5,
        kv_mask=kw["kv_mask"])
    without = attention.flash_attention_bwd_plain(q, k, v, g, **kw)
    given = attention.flash_attention_bwd_plain(q, k, v, g, row_stats=stats,
                                                **kw)
    for a, b in zip(without, given):
        assert torch.equal(a, b)
    out = attention.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(out.float()).all()


def test_forward_keeps_statistics_only_for_autograd(monkeypatch):
    """``flash_attention`` asks its autograd Function to keep K4n's row
    statistics only where grad is enabled and an input requires it: the
    teacher's no-grad forward keeps none."""
    seen = []
    real = attention._FlashAttention.apply
    monkeypatch.setattr(attention._FlashAttention, "apply",
                        lambda *a: seen.append(a[-1]) or real(*a))
    q, k, v, _ = (_t(a) for a in _inputs(24))
    kw = dict(causal=True, prefix_len=5, softmax_in_input_dtype=True)
    with torch.no_grad():
        attention.flash_attention(q.requires_grad_(), k, v, **kw)
    attention.flash_attention(q.detach(), k, v, **kw)
    out = attention.flash_attention(q.detach().requires_grad_(), k, v, **kw)
    assert seen == [False, False, True]
    # on the CPU the plain path keeps none either way
    assert out.grad_fn.saved_tensors[-1] is None
    out.float().sum().backward()


def test_stats_gate_rejects_a_max_or_reciprocal_off():
    """chip_smoke's limit for the stats-only launch: the max bit for bit,
    bf16(1 / z) within one bf16 ulp (the float32 sum runs in another
    order); a max one bf16 ulp off, or a reciprocal two off, fails."""
    import chip_smoke
    q, k, _, _ = (_t(a) for a in _inputs(25))
    want = attention.flash_attention_stats_plain(q, k, causal=True,
                                                 prefix_len=5)

    def nudged(col, ulps):
        got = want.clone()
        bits = got[..., col].to(torch.bfloat16).view(torch.int16)
        got[..., col] = (bits + ulps).view(torch.bfloat16).float()
        return got

    assert chip_smoke.stats_gate(want.clone(), want)[0]
    assert chip_smoke.stats_gate(nudged(1, 1), want)[0]
    assert not chip_smoke.stats_gate(nudged(1, 2), want)[0]
    assert not chip_smoke.stats_gate(nudged(0, 1), want)[0]
