"""The input-dtype softmax of K4/K8 (JAX's ``softmax_native``) and K6's
backward, the port against the JAX package.

The port's plain versions of the mode (``flash_attention_plain`` and
``flash_attention_bwd_plain`` with ``softmax_in_input_dtype``) are held
against ``_pallas_attention`` / ``_pallas_attention_bwd`` with
``softmax_native=True`` in interpret mode, under
``default_matmul_precision("highest")``, in bfloat16 at lq 67, lkv 71,
d 32 (tests/test_ops.py's shape): prefix-causal, key-masked, with dropout
(the same seed through both packages' dropout hash) and with a batch row
whose keys are all masked. Limit: 2^-7 of each output's own largest value,
one bf16 ulp of it; XLA may keep the bf16 chain's intermediates in float32
(``xla_allow_excess_precision``) where torch rounds each, so single
elements can differ by an ulp. The share of bit-equal elements is printed.

K6 (``fused_add_layer_norm``) against ``jax.vjp`` of ``_fused_add_ln`` in
interpret mode: float32 to 1e-5 of each gradient's largest value, bfloat16
at the card's limit for it (2e-2 of max(1, max|plain|)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rtvc_tpu.ops import attention as jattention
from rtvc_tpu.ops import layernorm as jlayernorm
from rtvc_tpu_torch.ops import attention, layernorm

B, H, LQ, LKV, D = 2, 2, 67, 71, 32
SEED = 4321
LIMIT = 2 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bf16(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, g = (_bf16(rng, B, H, n, D) for n in (LQ, LKV, LKV, LQ))
    return q, k, v, g


def _j(a, dtype=jnp.bfloat16):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(a)).to(dtype)


CASES = {
    "prefix-causal": dict(causal=True, prefix_len=5),
    "key-masked": dict(causal=True, prefix_len=5, mask="keys"),
    "dropout 0.1": dict(causal=True, prefix_len=5, rate=0.1),
    "fully masked batch row": dict(causal=False, prefix_len=0, mask="row"),
}


def _mask(kind):
    if kind is None:
        return None
    m = np.arange(LKV)[None, :] < 59
    m = np.repeat(m, B, axis=0)
    if kind == "row":
        m[1] = False
    return m


def _close_by_own_max(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    same = float((got == want).mean())
    print(f"{what}: max|diff| {err:.2e} of max|jax|, bit-equal {same:.4f}")
    assert err <= LIMIT, f"{what}: {err:.3e} > 2^-7 of max|jax|"


@pytest.mark.parametrize("case", list(CASES))
def test_native_plain_forward_and_backward_match_jax(case):
    c = CASES[case]
    q, k, v, g = _inputs(11)
    mask = _mask(c.get("mask"))
    rate = c.get("rate", 0.0)
    kw = dict(causal=c["causal"], prefix_len=c["prefix_len"],
              scale=D ** -0.5)
    jkw = dict(kw, dropout_rate=rate, interpret=True, softmax_native=True,
               seed=jnp.asarray([SEED], jnp.int32) if rate else None)
    jmask = None if mask is None else jnp.asarray(mask)
    with jax.default_matmul_precision("highest"):
        want = jattention._pallas_attention(_j(q), _j(k), _j(v), jmask,
                                            **jkw)
        want_grads = jattention._pallas_attention_bwd(
            _j(q), _j(k), _j(v), jmask, _j(g), **jkw)
    pkw = dict(kw, kv_mask=None if mask is None else torch.from_numpy(mask),
               dropout_rate=rate, seed=SEED if rate else None,
               softmax_in_input_dtype=True)
    got = attention.flash_attention_plain(_t(q), _t(k), _t(v), **pkw)
    assert got.dtype == torch.bfloat16
    _close_by_own_max(got.float(), want, f"{case} out")
    grads = attention.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g),
                                                **pkw)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        assert a.dtype == torch.bfloat16
        _close_by_own_max(a.float(), b, f"{case} {name}")


def test_native_mode_is_a_no_op_for_float32():
    """As JAX demotes it: float32 inputs give the mode-off bits, forward,
    backward and through autograd."""
    q, k, v, g = (_t(a, torch.float32) for a in _inputs(12))
    kw = dict(causal=True, prefix_len=5, dropout_rate=0.1, seed=SEED)
    off = attention.flash_attention_plain(q, k, v, **kw)
    on = attention.flash_attention_plain(q, k, v, softmax_in_input_dtype=True,
                                         **kw)
    assert torch.equal(off, on)
    for a, b in zip(attention.flash_attention_bwd_plain(q, k, v, g, **kw),
                    attention.flash_attention_bwd_plain(
                        q, k, v, g, softmax_in_input_dtype=True, **kw)):
        assert torch.equal(a, b)
    leaves = []
    for native in (False, True):
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        attention.flash_attention(ql, kl, vl, softmax_in_input_dtype=native,
                                  **kw).backward(g)
        leaves.append([t.grad for t in (ql, kl, vl)])
    for a, b in zip(*leaves):
        assert torch.equal(a, b)


@pytest.fixture
def switch():
    yield attention
    attention.set_softmax_native_pallas(False)
    jattention.set_softmax_native_pallas(False)


def test_switch_routes_the_default_calls_as_jax(switch, monkeypatch):
    """``multi_head_attention`` hands ``softmax_in_input_dtype or None`` to
    the flash route, so the switch decides the teacher's default calls; an
    explicit True wins over the switch off. The window route (K1) passes
    the argument as it is and never reads the switch."""
    seen, jseen = [], []
    monkeypatch.setattr(attention, "_flash_forward",
                        lambda *a: seen.append(a[-1]) or a[0])
    monkeypatch.setattr(jattention, "_flash",
                        lambda *a: jseen.append(a[-1]) or a[0])
    q = torch.zeros(1, 2, 3, 8, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 600, 8, dtype=torch.bfloat16)
    jq, jk = jnp.zeros(q.shape, jnp.bfloat16), jnp.zeros(k.shape, jnp.bfloat16)
    for on in (False, True):
        switch.set_softmax_native_pallas(on)
        jattention.set_softmax_native_pallas(on)
        for explicit in (False, True):
            attention.multi_head_attention(
                q, k, k, use_pallas=True, softmax_in_input_dtype=explicit)
            jattention.multi_head_attention(
                jq, jk, jk, use_pallas=True, softmax_in_input_dtype=explicit)
    assert seen == jseen == [False, True, True, True]
    # the switch alone, through the default threshold (Lkv >= 512)
    seen.clear()
    attention.multi_head_attention(q, k, k)
    assert seen == [True]
    # float32 demotes the mode before the kernel, as JAX's kernels do
    seen.clear()
    attention.multi_head_attention(q.float(), k.float(), k.float())
    assert seen == [False]
    # K1 takes its argument, not the switch
    monkeypatch.setattr(attention, "_window_forward",
                        lambda *a: seen.append(("k1", a[-1])) or a[0])
    seen.clear()
    w = torch.zeros(2, 2, 16, 8)
    attention.multi_head_attention(w, w, w, bias=torch.zeros(2, 16, 16))
    assert seen == [("k1", False)]


def _card_joint_case(native_gap_seed: int = 0):
    """The kernel phase's joint bf16 case (chip_smoke.kernel_cases' draws:
    randn q/k/v on strided head views, 1542 visual + 40 text tokens, prefix
    1542) cut to one batch row and two heads."""
    g = torch.Generator().manual_seed(native_gap_seed)
    lq, prefix = chip_smoke.FRAMES * 257 + chip_smoke.CAPTION_LEN, \
        chip_smoke.FRAMES * 257
    qkv = torch.randn(1, lq, 3, 2, 64, generator=g).to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    return (q, k, v), dict(causal=True, prefix_len=prefix)


def _native_in_float64(q, k, v, causal, prefix_len):
    """The mode's forward with its float32 sums (the score dot, the
    normaliser, P.V) taken in float64: the same function summed in another
    order, as a kernel sums it."""
    dt = torch.bfloat16
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)).to(dt)
    s = s * torch.tensor(q.shape[-1] ** -0.5, dtype=dt)
    s = s.masked_fill(~attention._allowed(q.shape[2], k.shape[2], causal,
                                          prefix_len, None, q.device),
                      attention.NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.double().sum(dim=-1, keepdim=True)).to(dt)
    return torch.matmul(p.double(), v.double()).to(dt)


def test_discriminating_gate_separates_summation_order_from_the_mode():
    """At the kernel phase's joint case the mode-off output misses the
    mode's by more than twice the mean the gate allows a mode kernel, so a
    kernel that ignored the flag fails the gate, while the mode summed in
    another order passes it."""
    (q, k, v), kw = _card_joint_case()
    on = attention.flash_attention_plain(q, k, v, softmax_in_input_dtype=True,
                                         **kw)
    off = attention.flash_attention_plain(q, k, v, **kw)
    reordered = _native_in_float64(q, k, v, **kw)
    ok, err, gap = chip_smoke.native_gate(reordered, on, off)
    print(f"mean |f64-summed - mode| {err:.3e}, mean |off - mode| {gap:.3e}")
    assert ok
    assert not chip_smoke.native_gate(off, on, off)[0]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", None)])
def test_fused_add_layer_norm_gradient_matches_jax_vjp(dtype, tol):
    """(dx, ddelta, dweight, dbias) of K6's autograd against ``jax.vjp`` of
    ``_fused_add_ln`` (interpret mode): the closed form of the ROUNDED sum
    plus the sum's own gradient, the same for x and delta."""
    rng = np.random.default_rng(5)
    rows, width = 37, 96
    x, d = (rng.normal(size=(rows, width)).astype(np.float32) * 2
            for _ in range(2))
    w, b = (rng.normal(size=(width,)).astype(np.float32) for _ in range(2))
    gy, gh = (rng.normal(size=(rows, width)).astype(np.float32)
              for _ in range(2))
    jt = getattr(jnp, dtype)
    tt = getattr(torch, dtype)
    with jax.default_matmul_precision("highest"):
        (jy, jh), vjp = jax.vjp(
            lambda x_, d_, w_, b_: jlayernorm._fused_add_ln(
                x_, d_, w_, b_, 1e-5, True),
            *(jnp.asarray(a).astype(jt) for a in (x, d, w, b)))
        want = vjp((jnp.asarray(gy).astype(jt), jnp.asarray(gh).astype(jt)))
    leaves = [torch.from_numpy(a).to(tt).requires_grad_()
              for a in (x, d, w, b)]
    y, h = layernorm.fused_add_layer_norm(*leaves, eps=1e-5)
    torch.autograd.backward((y, h), (torch.from_numpy(gy).to(tt),
                                     torch.from_numpy(gh).to(tt)))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jy, np.float32))
    for name, leaf, ref in zip(("dx", "ddelta", "dweight", "dbias"), leaves,
                               want):
        got = leaf.grad.float().numpy()
        ref = np.asarray(ref, np.float32)
        assert leaf.grad.dtype == tt
        if tol is None:
            bound, floor = chip_smoke.limit("fused_add_layer_norm", dtype)
            err = chip_smoke.rel_err(leaf.grad, torch.from_numpy(ref),
                                     floor)[1]
            assert err <= bound, f"{name}: {err:.3e}"
        else:
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err <= tol, f"{name}: {err:.3e}"
    assert torch.equal(leaves[0].grad, leaves[1].grad)
