"""The port's ops against the JAX package (rtvc_tpu_torch.ops).

Inputs come from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode under ``default_matmul_precision("highest")``; the port runs
the plain versions its wrappers take for CPU tensors. Tolerances:

- 1e-5 for the float32 kernels (window, flash and BLHD attention, with
  and without dropout, LayerNorm, add + LayerNorm, w8 GEMV, the depthwise
  weight gradient) and for the backward passes of K1, K2, K4 (K8) and the
  depthwise conv against ``jax.vjp`` or the Pallas backward: the same
  arithmetic, summed in another order; one bf16 ulp for the bf16 add +
  LayerNorm, where both round one float32 result;
- for bf16 K1 and K8, the card's limits (``chip_smoke.limit``): 2^-7 and
  2e-2 of each output's own largest value, which reject the known faults
  of ``tests/test_torch_card_limits.py``;
- the dropout hash bit for bit: the same uint32 arithmetic;
- 1e-6 relative for the W8A8 GEMM: its integer sums are exact on both
  sides, and only the float32 epilogue may round differently;
- int8 packs identical, scales to 1e-7: the same float32 rounding;
- 1e-4 after CLIP normalize for preprocess: two bicubic implementations
  (≈5e-6 before the divide by std ≈ 0.27).

The ``cuda`` tests compare each kernel with its plain version on a card and
skip without one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_card_limits import _k1_unrounded_bias, chip_smoke

from rtvc_tpu.ops import attention as jattention
from rtvc_tpu.ops import depthwise as jdepthwise
from rtvc_tpu.ops import int8_gemm as jint8_gemm
from rtvc_tpu.ops import layernorm as jlayernorm
from rtvc_tpu.ops import preprocess as jpreprocess
from rtvc_tpu.ops import quantization as jquantization
from rtvc_tpu_torch.ops import _kernel, attention, depthwise, int8_gemm
from rtvc_tpu_torch.ops import layernorm, preprocess, quantization

KERNEL_WRAPPERS = (attention.window_attention, layernorm.layer_norm,
                   int8_gemm.w8_matmul, attention.flash_attention,
                   attention.blhd_attention, layernorm.fused_add_layer_norm,
                   int8_gemm.w8a8_matmul, attention.flash_attention_bwd,
                   depthwise.dw3x3_wgrad)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _window_inputs(n: int, seed: int = 0, b: int = 6, h: int = 2,
                   d: int = 32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(h, n, n)).astype(np.float32)
    return q, k, v, bias


def _card_rel_err(name: str, got: torch.Tensor, want: np.ndarray) -> tuple:
    """(the error of ``got`` against ``want`` on ``chip_smoke``'s scale for
    kernel ``name`` in bfloat16, that kernel's bf16 limit on the card): the
    CPU parity and the card share one number."""
    tol, floor = chip_smoke.limit(name, "bfloat16")
    return chip_smoke.rel_err(got, torch.from_numpy(want), floor)[1], tol


# (N, native, dtype): the caption step's windows (7 x 7 and stage 2's
# 14 x 14, at a small batch and head count), float32 and the bfloat16
# TinyViT path (native) that the tensor-core K1 serves
WINDOW_CASES = [(49, False, "float32"), (49, True, "float32"),
                (16, False, "float32"), (16, True, "float32"),
                (196, False, "float32"), (196, True, "float32"),
                (49, True, "bfloat16"), (196, True, "bfloat16")]


def _window_case(n: int, dtype: str):
    """``_window_inputs`` at N (batch 2 from N = 100 up) in ``dtype`` as
    torch tensors (q, k, v, bias) and the JAX kernel's native-mode output
    (interpret mode, highest precision) as float32 numpy."""
    q, k, v, bias = _window_inputs(n, **({} if n < 100 else dict(b=2)))
    return ((*(_t(a).to(getattr(torch, dtype)) for a in (q, k, v)), _t(bias)),
            _jax_window(n, True, dtype))


@functools.lru_cache(maxsize=None)
def _jax_window(n: int, native: bool, dtype: str) -> np.ndarray:
    q, k, v, bias = _window_inputs(n, **({} if n < 100 else dict(b=2)))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    with jax.default_matmul_precision("highest"):
        want = jattention.window_attention(
            jq, jk, jv, jnp.asarray(bias), scale=q.shape[-1] ** -0.5,
            softmax_in_input_dtype=native, interpret=True)
    return np.asarray(want).astype(np.float32)


@pytest.mark.parametrize(
    "n,native,dtype", WINDOW_CASES,
    ids=[f"{n}-{native}" + ("" if dt == "float32" else f"-{dt}")
         for n, native, dt in WINDOW_CASES])
def test_window_attention_matches_jax(n, native, dtype):
    """bf16 is held to K1's card limit, 2^-7 of the output's own max."""
    q, k, v, bias = _window_inputs(n, **({} if n < 100 else dict(b=2)))
    d = q.shape[-1]
    want = _jax_window(n, native, dtype)
    tq, tk, tv = (_t(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got = attention.window_attention(tq, tk, tv, _t(bias), scale=d ** -0.5,
                                     softmax_in_input_dtype=native)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        rel, tol = _card_rel_err("window_attention", got, want)
        assert rel <= tol, f"{rel:.3e} of max|want| > {tol:g}"


@pytest.mark.parametrize("n", [49, 196])
def test_k1_unrounded_bias_misses_jax_by_more_than_the_card_limit(n):
    """K1's known bf16 fault (the bias added to the bf16 score unrounded)
    against the JAX kernel on the parity test's own inputs: the limit that
    the CPU parity and the card share rejects it."""
    (q, k, v, bias), want = _window_case(n, "bfloat16")
    rel, tol = _card_rel_err("window_attention", _k1_unrounded_bias(
        q, k, v, bias), want)
    assert rel > tol, f"the unrounded bias misses by {rel:.3e} <= {tol:g}"


@pytest.mark.parametrize("n", [49, 196])
def test_k1_plain_stays_inside_the_card_limit_of_jax(n):
    """The port's K1 takes a float32 softmax of the bf16 scores, where the
    TPU kernel takes max, exp, sum and divide in bf16
    (rtvc_tpu/ops/attention.py:754-757). float32 is kept: it is the more
    exact of the two, and the TPU's own rounding of that bf16 arithmetic
    under --xla_allow_excess_precision is uncertain (:739-748). The gap
    it costs against the JAX kernel is pinned here, inside the card's
    2^-7 of max|want|: 4.6e-3 at N = 49 and 6.2e-3 at N = 196, 80% of
    the margin."""
    (q, k, v, bias), want = _window_case(n, "bfloat16")
    got = attention.window_attention_plain(q, k, v, bias,
                                           softmax_in_input_dtype=True)
    rel, tol = _card_rel_err("window_attention", got, want)
    assert rel <= tol, f"{rel:.3e} of max|want| > {tol:g}"


def test_multi_head_attention_routes_window_bias_to_k1():
    """A [1, H, N, N] bias on unmasked self-attention takes the window
    path, and that path equals the plain path."""
    q, k, v, bias = map(_t, _window_inputs(16, seed=1))
    got = attention.multi_head_attention(q, k, v, bias=bias[None],
                                         softmax_in_input_dtype=True)
    want = attention.attention_plain(q, k, v, bias=bias[None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal,prefix,masked", [
    (False, 0, False), (True, 0, True), (True, 3, False), (False, 0, True)])
def test_attention_plain_matches_xla_attention(causal, prefix, masked):
    rng = np.random.default_rng(2)
    b, h, lq, lk, d = 2, 3, 7, 7, 8
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    mask = np.ones((b, lk), bool)
    mask[1, 5:] = False
    kv_mask = mask if masked else None
    with jax.default_matmul_precision("highest"):
        want = jattention.xla_attention(
            *map(jnp.asarray, (q, k, v)), causal=causal, prefix_len=prefix,
            kv_mask=None if kv_mask is None else jnp.asarray(kv_mask))
    got = attention.multi_head_attention(
        *map(_t, (q, k, v)), causal=causal, prefix_len=prefix,
        kv_mask=None if kv_mask is None else _t(kv_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("rows,width", [(8, 576), (13, 40)])
def test_layer_norm_matches_pallas_ln(rows, width):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(rows, width)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(width,)).astype(np.float32)
    bias = rng.normal(size=(width,)).astype(np.float32)
    want = jlayernorm._pallas_ln(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-5, interpret=True)
    ln = layernorm.FusedLayerNorm(width)
    with torch.no_grad():
        ln.weight.copy_(_t(scale))
        ln.bias.copy_(_t(bias))
        got = ln(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# (bias, layout of wq): JAX's [K, N] array under the old ids, and the [K, N]
# view of an [N, K] pack, the layout K3 reads on a card
W8_CASES = [(bias, layout) for layout in ("kn", "pack")
            for bias in (True, False)]


@pytest.mark.parametrize(
    "with_bias,layout", W8_CASES,
    ids=[str(b) if lay == "kn" else f"{b}-{lay}" for b, lay in W8_CASES])
def test_w8_matmul_matches_jax(with_bias, layout):
    rng = np.random.default_rng(7)
    m, k, n = 5, 32, 200
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sw = (np.abs(rng.normal(size=(n,))) * 0.01 + 1e-3).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    want = jint8_gemm.w8_matmul(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw),
        bias=None if b is None else jnp.asarray(b), out_dtype=jnp.float32,
        tn=128, interpret=True)
    twq = _t(wq) if layout == "kn" else _t(np.ascontiguousarray(wq.T)).t()
    assert twq.is_contiguous() == (layout == "kn")
    got = int8_gemm.w8_dense(_t(x)[None], twq, _t(sw),
                             None if b is None else _t(b))[0]
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_quantize_vocab_head_pack_equals_jax():
    rng = np.random.default_rng(4)
    d, vocab = 24, 1100  # pads to 2048 columns
    kernel = rng.normal(size=(d, vocab)).astype(np.float32) * 0.1
    kernel[:, 3] = 0.0  # an all-zero column takes the 1e-8 scale floor
    bias = rng.normal(size=(vocab,)).astype(np.float32)
    want = jquantization.quantize_vocab_head(
        {"params": {"linear": {"kernel": jnp.asarray(kernel),
                               "bias": jnp.asarray(bias)}}})
    linear = torch.nn.Linear(d, vocab)
    with torch.no_grad():
        linear.weight.copy_(_t(kernel.T))
        linear.bias.copy_(_t(bias))
    got = quantization.quantize_vocab_head(linear)
    assert got["wq"].shape == (d, 2048) and got["wq"].dtype == torch.int8
    np.testing.assert_array_equal(got["wq"].numpy(), np.asarray(want["wq"]))
    np.testing.assert_allclose(got["sw"].numpy(), np.asarray(want["sw"]),
                               rtol=1e-7, atol=0)
    np.testing.assert_array_equal(got["bias"].numpy(),
                                  np.asarray(want["bias"]))
    assert float(got["bias"][0, -1]) == -1e9


def test_quantize_vocab_head_is_a_view_of_a_k_contiguous_pack():
    """``wq`` is the [D, Vp] view of a contiguous [Vp, D] pack, which K3
    reads on a card without a copy; the pad rows are zero."""
    linear = torch.nn.Linear(24, 1100)
    got = quantization.quantize_vocab_head(linear)
    pack = got["wq"].t()
    assert pack.is_contiguous() and pack.shape == (2048, 24)
    assert not bool(pack[1100:].any())
    want = quantization.quantize_weight(linear.weight.detach().t())[0]
    assert torch.equal(got["wq"][:, :1100], want)


def test_layer_norm_large_mean_matches_pallas_ln():
    """Rows of mean 64 and spread 2 (the card's "mean 64" case), float32:
    the centred variance of ``_pallas_ln`` and the port's plain version
    agree inside the card's K2 limit, which a one-pass E[x^2] - mean^2
    misses (tests/test_torch_card_limits.py)."""
    rng = np.random.default_rng(23)
    rows, width = 40, 576
    x = (rng.normal(size=(rows, width)) * 2 + 64).astype(np.float32)
    scale, bias = (rng.normal(size=(width,)).astype(np.float32)
                   for _ in range(2))
    want = jlayernorm._pallas_ln(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-5, interpret=True)
    got = layernorm.layer_norm(_t(x), _t(scale), _t(bias))
    tol, floor = chip_smoke.limit("layer_norm", "float32")
    rel = chip_smoke.rel_err(got, _t(np.asarray(want)), floor)[1]
    assert rel <= tol / 4, f"{rel:.3e} of max(1, max|want|)"


@pytest.mark.parametrize("shape,crop", [((2, 480, 640, 3), 224),
                                        ((2, 224, 224, 3), 224),
                                        ((3, 96, 80, 3), 64)])
def test_clip_preprocess_matches_jax(shape, crop):
    frames = np.random.default_rng(5).integers(0, 256, size=shape,
                                               dtype=np.uint8)
    want = jpreprocess.clip_preprocess(jnp.asarray(frames), crop_size=crop)
    got = preprocess.clip_preprocess(_t(frames), crop_size=crop)
    assert got.shape == (shape[0], crop, crop, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _flash_inputs(b, h, lq, lkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lkv, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case,causal,prefix,lq,masked", [
    ("prefix_causal", True, 50, 70, False),
    ("plain_causal", True, 0, 70, False),
    ("bidirectional", False, 0, 70, False),
    ("key_masked", True, 50, 70, True),
    ("cross_ragged", False, 0, 37, True),
])
def test_flash_attention_matches_pallas(case, causal, prefix, lq, masked):
    """K4's plain version against ``_pallas_attention`` in interpret mode;
    Lq is no multiple of 64, and with a mask batch row 1 has no key left
    (the uniform average of V, not NaN)."""
    b, h, lkv, d = 2, 3, 70, 16
    q, k, v = _flash_inputs(b, h, lq, lkv, d, seed=8)
    kv_mask = None
    if masked:
        kv_mask = np.ones((b, lkv), bool)
        kv_mask[0, ::3] = False
        kv_mask[1] = False
    with jax.default_matmul_precision("highest"):
        want = jattention._pallas_attention(
            *map(jnp.asarray, (q, k, v)),
            None if kv_mask is None else jnp.asarray(kv_mask),
            causal=causal, prefix_len=prefix, scale=d ** -0.5,
            interpret=True)
    got = attention.flash_attention(
        *map(_t, (q, k, v)), causal=causal, prefix_len=prefix,
        kv_mask=None if kv_mask is None else _t(kv_mask))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_multi_head_attention_routes_long_context_to_k4():
    """Bias-free attention over >= PALLAS_MIN_KV_LEN keys takes K4's route
    (here its plain version); use_pallas=False forces the plain path; both
    agree with JAX's xla_attention."""
    b, h, lq, lkv, d = 1, 2, 9, attention.PALLAS_MIN_KV_LEN, 8
    q, k, v = _flash_inputs(b, h, lq, lkv, d, seed=9)
    with jax.default_matmul_precision("highest"):
        want = jattention.xla_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=True, prefix_len=500)
    calls = []
    real = attention.flash_attention_plain
    attention.flash_attention_plain = lambda *a, **kw: (
        calls.append(1), real(*a, **kw))[1]
    try:
        routed = attention.multi_head_attention(
            *map(_t, (q, k, v)), causal=True, prefix_len=500)
        plain = attention.multi_head_attention(
            *map(_t, (q, k, v)), causal=True, prefix_len=500,
            use_pallas=False)
    finally:
        attention.flash_attention_plain = real
    assert len(calls) == 1
    for got in (routed, plain):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_flash_attention_refuses_dropout_and_native_softmax():
    """Dropout without a seed or a generator raises, as JAX's does without
    a ``dropout_rng``; the input-dtype softmax is not ported."""
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="seed or a generator"):
        attention.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(NotImplementedError):
        attention.flash_attention(q, q, q, softmax_in_input_dtype=True)


@pytest.mark.parametrize("l", [17, 70])
def test_blhd_attention_matches_pallas(l):
    """K5's plain version on strided [B, L, H, D] views of a packed QKV
    product against ``blhd_attention`` in interpret mode."""
    b, h, d = 2, 4, 16
    qkv = np.random.default_rng(10).normal(
        size=(b, l, 3 * h * d)).astype(np.float32)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, l, h, d)
               for i in range(3))
    with jax.default_matmul_precision("highest"):
        want = jattention.blhd_attention(*map(jnp.asarray, (q, k, v)),
                                         interpret=True)
    views = _t(qkv).view(b, l, 3, h, d).unbind(2)
    got = attention.blhd_attention(*views)
    assert got.shape == (b, l, h, d) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_layer_norm_matches_pallas(dtype):
    """Both outputs of K6's plain version against ``_pallas_add_ln``: the
    rounded sum, and the norm of the float32 sum."""
    rng = np.random.default_rng(11)
    rows, width = 13, 96
    x = (rng.normal(size=(rows, width)) * 3 + 1).astype(np.float32)
    delta = rng.normal(size=(rows, width)).astype(np.float32)
    scale = rng.normal(size=(width,)).astype(np.float32)
    bias = rng.normal(size=(width,)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want_y, want_h = jlayernorm._pallas_add_ln(
        *(jnp.asarray(a).astype(jdt) for a in (x, delta, scale, bias)),
        1e-5, interpret=True)
    tdt = getattr(torch, dtype)
    norm = layernorm.FusedAddLayerNorm(width)
    with torch.no_grad():
        norm.weight.copy_(_t(scale))
        norm.bias.copy_(_t(bias))
        norm.to(tdt)
        got_y, got_h = norm(_t(x).to(tdt), _t(delta).to(tdt))
    assert got_y.dtype == got_h.dtype == tdt
    for got, want in ((got_y, want_y), (got_h, want_h)):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:  # at most one bf16 ulp (2^-7 of the value's binade)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got - want) <= ulp).all()


# (M, K, N, bias, out dtype): the first two under their old ids; then the
# ragged shapes the wgmma K7's tiles must take (M past one 64-row
# warpgroup, K off its 128-byte stage, N off every tile; one row, K below a
# stage, N below one 8-column group), in float32 and bfloat16
W8A8_CASES = ([(37, 64, 300, bias, "float32") for bias in (True, False)]
              + [(m, k, n, bias, dtype)
                 for m, k, n in ((65, 144, 257), (1, 16, 8))
                 for bias in (True, False)
                 for dtype in ("float32", "bfloat16")])


@pytest.mark.parametrize(
    "m,k,n,with_bias,dtype", W8A8_CASES,
    ids=[str(c[3]) if c[:3] == (37, 64, 300)
         else f"{c[0]}x{c[1]}x{c[2]}-{'bias' if c[3] else 'nobias'}-{c[4]}"
         for c in W8A8_CASES])
def test_w8a8_matmul_matches_pallas(m, k, n, with_bias, dtype):
    """The port's K7 (its plain version here) against the Pallas kernel in
    interpret mode. Not bit for bit: XLA on the CPU rounds the bias add
    otherwise (up to 4e-7 of the largest value, none without bias); the
    card holds K7 to its plain version exactly."""
    rng = np.random.default_rng(12)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    sx = (rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sw = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    want = jint8_gemm.w8a8_matmul(
        jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(wq), jnp.asarray(sw),
        bias=None if b is None else jnp.asarray(b),
        out_dtype=getattr(jnp, dtype), tm=128, tn=128, interpret=True)
    got = int8_gemm.w8a8_matmul(_t(xq), _t(sx), _t(wq), _t(sw),
                                None if b is None else _t(b),
                                getattr(torch, dtype))
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == (m, n) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_w8a8_plain_sums_exactly_past_float32():
    """|sum| = 127²·4096 > 2^24: the plain version still gets the exact
    integer before its one rounding to float32."""
    k = 4096
    xq = torch.full((1, k), 127, dtype=torch.int8)
    wq = torch.full((k, 2), 127, dtype=torch.int8)
    wq[0, 1] = 126  # sum 127²·4096 - 127: odd, not a float32 value
    got = int8_gemm.w8a8_matmul_plain(xq, torch.ones(1), wq, torch.ones(2))
    exact = np.array([127 * 127 * k, 127 * 127 * k - 127], np.int64)
    assert got[0].numpy().tolist() == exact.astype(np.float32).tolist()


def test_quantize_activations_and_teacher_packs_equal_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 scale floor
    jq, js = jquantization.quantize_activations(jnp.asarray(x))
    pq, ps = quantization.quantize_activations(_t(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-7, atol=0)

    model = torch.nn.Sequential(torch.nn.Linear(24, 40),
                                torch.nn.LayerNorm(40),
                                torch.nn.Linear(40, 8, bias=False))
    params = {str(i): {"kernel": model[i].weight.detach().numpy().T}
              for i in (0, 2)}
    params["0"]["bias"] = model[0].bias.detach().numpy()
    jpacked = jquantization.quantize_teacher_params(
        {k: {n: jnp.asarray(a) for n, a in v.items()}
         for k, v in params.items()})
    quantization.quantize_teacher_(model)
    assert isinstance(model[1], torch.nn.LayerNorm)
    for i in (0, 2):
        q = model[i]
        assert isinstance(q, quantization.QuantLinear)
        np.testing.assert_array_equal(q.weight_q.t().numpy(),
                                      np.asarray(jpacked[str(i)]["kernel_q"]))
        np.testing.assert_allclose(
            q.weight_scale.numpy(),
            np.asarray(jpacked[str(i)]["kernel_scale"]), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(model[0].bias.numpy(), params["0"]["bias"])
    assert model[2].bias is None


def test_int8_matmul_matches_jax():
    """QuantDense's W8A8 matmul (JAX's XLA int8 route) and the port's
    (K7's plain version) on the same pack."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    w = rng.normal(size=(32, 20)).astype(np.float32)
    b = rng.normal(size=(20,)).astype(np.float32)
    wq, sw = jquantization.quantize_weight(jnp.asarray(w))
    want = jquantization.int8_matmul(jnp.asarray(x), wq, sw, jnp.asarray(b))
    got = quantization.int8_matmul(_t(x), _t(np.asarray(wq)),
                                   _t(np.asarray(sw)), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_cpu_tensors_never_launch_a_kernel():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    q, k, v, bias = map(_t, _window_inputs(16))
    attention.window_attention(q, k, v, bias)
    layernorm.layer_norm(q, torch.ones(32), torch.zeros(32))
    int8_gemm.w8_matmul(torch.ones(2, 8), torch.ones(8, 4, dtype=torch.int8),
                        torch.ones(4))
    attention.flash_attention(q, k, v, causal=True)
    attention.blhd_attention(q, k, v)
    layernorm.fused_add_layer_norm(q, k, torch.ones(32), torch.zeros(32))
    int8_gemm.w8a8_matmul(torch.ones(2, 16, dtype=torch.int8), torch.ones(2),
                          torch.ones(16, 4, dtype=torch.int8), torch.ones(4))
    attention.flash_attention_bwd(q, k, v, q, causal=True)
    depthwise.dw3x3_wgrad(q, k)
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * 9


# ---------------------------------------------------------------------------
# the train step's ops: dropout hash, K4 dropout, K8, K1/K2 backward, K9
# ---------------------------------------------------------------------------

SEED = 1234567


def test_dropout_bits_match_jax():
    """``dropout_bits`` over the whole grid equals ``_dropout_bits`` of
    every (batch, head, q-block) on a ragged grid (37 rows in blocks of 16,
    45 columns), bit for bit."""
    b, h, lq, lkv, block_q = 2, 3, 37, 45, 16
    got = attention.dropout_bits(SEED, b, h, lq, lkv).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    for bi in range(b):
        for hi in range(h):
            for qi in range(-(-lq // block_q)):
                want = np.asarray(jattention._dropout_bits(
                    jnp.int32(SEED), bi, hi, qi, (block_q, lkv), block_q))
                rows = min(block_q, lq - qi * block_q)
                np.testing.assert_array_equal(
                    got[bi, hi, qi * block_q:qi * block_q + rows],
                    want[:rows].astype(np.int64))


FLASH_DROPOUT_CASES = [
    ("prefix_causal", True, 50, 70, False),
    ("key_masked", True, 50, 70, True),
    ("ragged_lq", False, 0, 37, True),
]


def _flash_case(causal, prefix, lq, masked, seed=15):
    b, h, lkv, d = 2, 3, 70, 16
    q, k, v = _flash_inputs(b, h, lq, lkv, d, seed=seed)
    g = np.random.default_rng(seed + 1).normal(
        size=(b, h, lq, d)).astype(np.float32)
    kv_mask = None
    if masked:
        kv_mask = np.ones((b, lkv), bool)
        kv_mask[0, ::3] = False
        kv_mask[1] = False
    return (q, k, v, g, kv_mask,
            dict(causal=causal, prefix_len=prefix, scale=d ** -0.5))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("case,causal,prefix,lq,masked", FLASH_DROPOUT_CASES)
def test_flash_attention_dropout_matches_pallas(case, causal, prefix, lq,
                                                masked):
    """K4's plain version with dropout 0.1 against ``_pallas_attention`` in
    interpret mode with the same seed."""
    q, k, v, _, kv_mask, kw = _flash_case(causal, prefix, lq, masked)
    with jax.default_matmul_precision("highest"):
        want = jattention._pallas_attention(
            *map(jnp.asarray, (q, k, v)), _j(kv_mask), dropout_rate=0.1,
            seed=jnp.int32(SEED), interpret=True, **kw)
    got = attention.flash_attention(*map(_t, (q, k, v)),
                                    kv_mask=_tt(kv_mask), dropout_rate=0.1,
                                    seed=SEED, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    nodrop = attention.flash_attention_plain(*map(_t, (q, k, v)),
                                             kv_mask=_tt(kv_mask), **kw)
    assert not torch.allclose(got, nodrop)


# every case with and without dropout in float32; the same in bfloat16,
# the dtype the tensor-core K8 serves
FLASH_BWD_CASES = [c + (rate, dtype) for dtype in ("float32", "bfloat16")
                   for c in FLASH_DROPOUT_CASES for rate in (0.0, 0.1)]


@pytest.mark.parametrize(
    "case,causal,prefix,lq,masked,rate,dtype", FLASH_BWD_CASES,
    ids=["-".join(map(str, c[:6])) + ("" if c[6] == "float32" else
                                      f"-{c[6]}") for c in FLASH_BWD_CASES])
def test_flash_attention_bwd_matches_pallas(case, causal, prefix, lq, masked,
                                            rate, dtype):
    """K8's plain version against ``_pallas_attention_bwd`` in interpret
    mode (with a row that has no allowed key where masked), and autograd
    through the port's ``flash_attention`` on the CPU gives the same
    gradients."""
    q, k, v, g, kv_mask, kw = _flash_case(causal, prefix, lq, masked)
    with jax.default_matmul_precision("highest"):
        want = jattention._pallas_attention_bwd(
            *(jnp.asarray(a).astype(dtype) for a in (q, k, v)), _j(kv_mask),
            jnp.asarray(g).astype(dtype), dropout_rate=rate,
            seed=jnp.int32(SEED) if rate else None, interpret=True, **kw)
    seed = SEED if rate else None
    tq, tk, tv, tg = (_t(a).to(getattr(torch, dtype)) for a in (q, k, v, g))
    got = attention.flash_attention_bwd_plain(
        tq, tk, tv, tg, kv_mask=_tt(kv_mask), dropout_rate=rate, seed=seed,
        **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    attention.flash_attention(*leaves, kv_mask=_tt(kv_mask),
                              dropout_rate=rate, seed=seed,
                              **kw).backward(tg)
    for name, p, a, w in zip("qkv", got, leaves, want):
        w = np.asarray(w).astype(np.float32)
        assert p.dtype == getattr(torch, dtype)
        assert np.isfinite(p.float().numpy()).all()
        if dtype == "float32":
            np.testing.assert_allclose(p.numpy(), w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"d{name}")
        else:  # K8's card limit: 2e-2 of each gradient's own max
            rel, tol = _card_rel_err("flash_attention_bwd", p, w)
            assert rel <= tol, f"d{name}: {rel:.3e} of max|want| > {tol:g}"
        np.testing.assert_array_equal(a.grad.float().numpy(),
                                      p.float().numpy())


@pytest.mark.parametrize("native", [False, True])
def test_window_attention_grads_match_jax(native):
    """K1's backward (dq, dk, dv, dbias) against ``jax.vjp`` of
    ``window_attention(..., interpret=True)``, whose VJP is
    ``_window_attention_bwd``."""
    q, k, v, bias = _window_inputs(16, seed=16)
    g = np.random.default_rng(17).normal(size=q.shape).astype(np.float32)
    scale = q.shape[-1] ** -0.5
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: jattention.window_attention(
            *a, scale=scale, softmax_in_input_dtype=native, interpret=True),
            *map(jnp.asarray, (q, k, v, bias)))
        want = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    out = attention.window_attention(*leaves, scale=scale,
                                     softmax_in_input_dtype=native)
    out.backward(_t(g))
    for name, a, w in zip(("q", "k", "v", "bias"), leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


def test_layer_norm_grads_match_jax():
    """K2's backward (dx, dweight, dbias) against ``jax.vjp`` of
    ``_ln_reference`` on a [2, 7, 40] input."""
    rng = np.random.default_rng(18)
    x = (rng.normal(size=(2, 7, 40)) * 3 + 1).astype(np.float32)
    w, b = (rng.normal(size=(40,)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jlayernorm._ln_reference(*a, 1e-5),
                     *map(jnp.asarray, (x, w, b)))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    layernorm.layer_norm(*leaves).backward(_t(g))
    for name, a, wnt in zip(("x", "weight", "bias"), leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(wnt),
                                   atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


def _hwio_to_oihw(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1))


# NHWC; after the first two, the edges of K9's channel groups: a 1 x 1
# plane, three channels (no group size divides them), a 5 x 9 plane, one
# image of 7 x 7 planes
@pytest.mark.parametrize("shape", [(2, 9, 9, 16), (3, 7, 5, 8), (1, 1, 1, 3),
                                   (2, 5, 9, 3), (1, 7, 7, 16)])
def test_dw3x3_wgrad_matches_pallas(shape):
    """K9's plain version on NCHW against ``dw3x3_wgrad_pallas`` (interpret
    mode off a TPU) on NHWC, HWIO [3, 3, 1, C] turned to [C, 1, 3, 3]."""
    rng = np.random.default_rng(19)
    x, dy = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want = jdepthwise.dw3x3_wgrad_pallas(jnp.asarray(x), jnp.asarray(dy))
    got = depthwise.dw3x3_wgrad(*(_t(a.transpose(0, 3, 1, 2).copy())
                                  for a in (x, dy)))
    assert got.shape == (shape[-1], 1, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _hwio_to_oihw(want), atol=1e-5,
                               rtol=1e-5)


def test_depthwise_conv3x3_grads_match_jax():
    """``depthwise_conv3x3``'s output and (dx, dw) against ``jax.vjp`` of
    the JAX op (custom VJP: flipped-kernel dgrad, one-pass wgrad)."""
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 6, 7, 12)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 1, 12)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(jdepthwise.depthwise_conv3x3, jnp.asarray(x),
                           jnp.asarray(kernel))
        dx, dw = vjp(jnp.asarray(g))
    xt = _t(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    wt = _t(_hwio_to_oihw(kernel)).requires_grad_()
    got = depthwise.depthwise_conv3x3(xt, wt)
    got.backward(_t(g.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(dx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), _hwio_to_oihw(dw),
                               atol=1e-5, rtol=1e-5)


def test_require_no_grad_refuses_tensors_that_need_a_gradient():
    """The guard of the kernels without a backward (K3, K5, K6, K7 on a
    card): it raises where autograd would need their gradient, and lets
    through work under ``no_grad`` or on tensors that need none."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _kernel.require_no_grad("blhd_attention", torch.ones(2), x)
    _kernel.require_no_grad("blhd_attention", torch.ones(2), None)
    with torch.no_grad():
        _kernel.require_no_grad("blhd_attention", x)


# ---------------------------------------------------------------------------
# on a card: each kernel against its plain version (skips without CUDA)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_on_cuda(cuda, dtype, tol):
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    q, k, v = (rand(12, 6, 49, 32).to(dtype) for _ in range(3))
    bias = rand(6, 49, 49)
    got = attention.window_attention(q, k, v, bias,
                                     softmax_in_input_dtype=True)
    want = attention.window_attention_plain(q, k, v, bias,
                                            softmax_in_input_dtype=True)
    assert (got.float() - want.float()).abs().max() <= tol

    x, w, b = rand(200, 576).to(dtype), rand(576).to(dtype), rand(576).to(dtype)
    got = layernorm.layer_norm(x, w, b)
    want = layernorm.layer_norm_plain(x, w, b)
    assert (got.float() - want.float()).abs().max() <= tol * 4

    wq = torch.randint(-127, 128, (1024, 576), generator=g,
                       dtype=torch.int8).to(cuda).t()  # the pack's view
    sw, bb = rand(1024).abs() * 1e-3, rand(1024)
    for m in (1, 8):
        xm = rand(m, 576).to(dtype)
        got = int8_gemm.w8_matmul(xm, wq, sw, bb)
        want = int8_gemm.w8_matmul_plain(xm, wq, sw, bb)
        assert (got.float() - want.float()).abs().max() <= tol * 4
    torch.cuda.synchronize()


CUDA_TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _rand(cuda, g):
    return lambda *shape: torch.randn(*shape, generator=g).to(cuda)


def _assert_close_on_cuda(got, want, tol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max()
    assert err <= tol * max(1.0, float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CUDA_TOLS)
def test_flash_attention_matches_plain_on_cuda(cuda, dtype, tol):
    """K4 on strided head views of a packed QKV product: prefix-causal,
    and key-masked with a batch row that has no key left."""
    rand = _rand(cuda, torch.Generator().manual_seed(1))
    qkv = rand(2, 300, 3 * 4 * 64).to(dtype)
    heads = [t.transpose(1, 2) for t in qkv.view(2, 300, 3, 4, 64).unbind(2)]
    mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    mask[1] = False
    for kw in (dict(causal=True, prefix_len=260), dict(kv_mask=mask)):
        _assert_close_on_cuda(attention.flash_attention(*heads, **kw),
                              attention.flash_attention_plain(*heads, **kw),
                              tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CUDA_TOLS)
def test_blhd_attention_matches_plain_on_cuda(cuda, dtype, tol):
    """K5 on the [B, L, H, D] views of a packed QKV product."""
    rand = _rand(cuda, torch.Generator().manual_seed(2))
    views = rand(3, 257, 3 * 4 * 64).to(dtype).view(3, 257, 3, 4,
                                                    64).unbind(2)
    _assert_close_on_cuda(attention.blhd_attention(*views),
                          attention.blhd_attention_plain(*views), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CUDA_TOLS)
def test_fused_add_layer_norm_matches_plain_on_cuda(cuda, dtype, tol):
    rand = _rand(cuda, torch.Generator().manual_seed(3))
    x, d = rand(500, 1024).to(dtype), rand(500, 1024).to(dtype)
    w, b = rand(1024).to(dtype), rand(1024).to(dtype)
    for got, want in zip(layernorm.fused_add_layer_norm(x, d, w, b),
                         layernorm.fused_add_layer_norm_plain(x, d, w, b)):
        _assert_close_on_cuda(got, want, tol * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CUDA_TOLS)
def test_w8a8_matmul_matches_plain_on_cuda(cuda, dtype, tol):
    """K7 with a ragged N and M = 8 and 300, output in ``dtype``."""
    g = torch.Generator().manual_seed(4)
    rand = _rand(cuda, g)
    pack = torch.randint(-127, 128, (1000, 768), generator=g,
                         dtype=torch.int8).to(cuda)
    sw, bb = rand(1000).abs() * 1e-3, rand(1000)
    for m in (8, 300):
        xq = torch.randint(-127, 128, (m, 768), generator=g,
                           dtype=torch.int8).to(cuda)
        sx = rand(m).abs() * 1e-2
        _assert_close_on_cuda(
            int8_gemm.w8a8_matmul(xq, sx, pack.t(), sw, bb, dtype),
            int8_gemm.w8a8_matmul_plain(xq, sx, pack.t(), sw, bb, dtype),
            tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CUDA_TOLS)
def test_flash_attention_bwd_matches_plain_on_cuda(cuda, dtype, tol):
    """K8, with and without dropout, prefix-causal and key-masked with a
    row that has no key left; the autograd of ``flash_attention`` launches
    it and gives the same gradients."""
    rand = _rand(cuda, torch.Generator().manual_seed(5))
    q, k, v, g = (rand(2, 4, 300, 64).to(dtype) for _ in range(4))
    mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    mask[1] = False
    for kw in (dict(causal=True, prefix_len=260),
               dict(kv_mask=mask, dropout_rate=0.1, seed=SEED)):
        want = attention.flash_attention_bwd_plain(q, k, v, g, **kw)
        got = attention.flash_attention_bwd(q, k, v, g, **kw)
        for a, b in zip(got, want):
            _assert_close_on_cuda(a, b, tol)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attention.flash_attention(*leaves, **kw).backward(g)
        for a, b in zip(leaves, got):
            _assert_close_on_cuda(a.grad, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CUDA_TOLS)
def test_dw3x3_wgrad_matches_plain_on_cuda(cuda, dtype, tol):
    rand = _rand(cuda, torch.Generator().manual_seed(6))
    x, dy = (rand(4, 24, 14, 14).to(dtype) for _ in range(2))
    _assert_close_on_cuda(depthwise.dw3x3_wgrad(x, dy),
                          depthwise.dw3x3_wgrad_plain(x, dy), tol)


@pytest.mark.cuda
def test_w8_matmul_refuses_a_k_by_n_contiguous_weight_on_cuda(cuda):
    """K3 reads the [N, K] pack; a contiguous [K, N] wq would need a copy of
    the whole weight on every call, so the wrapper raises instead."""
    wq = torch.ones(576, 1024, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="pack"):
        int8_gemm.w8_matmul(torch.ones(8, 576, device=cuda), wq,
                            torch.ones(1024, device=cuda))


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad_on_cuda(cuda):
    """K3, K5, K6 and K7 refuse inputs that require grad instead of
    returning a tensor with no autograd history."""
    x = torch.ones(4, 2, 2, 64, device=cuda, requires_grad=True)
    w = torch.ones(64, device=cuda)
    i8 = torch.ones(64, 8, dtype=torch.int8, device=cuda)
    calls = [
        lambda: attention.blhd_attention(x, x, x),
        lambda: layernorm.fused_add_layer_norm(x, x, w, w),
        lambda: int8_gemm.w8_matmul(x[0, 0], i8, torch.ones(8, device=cuda)),
        lambda: quantization.int8_matmul(x, i8, torch.ones(8, device=cuda)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
