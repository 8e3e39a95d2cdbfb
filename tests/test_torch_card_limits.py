"""The limits ``chip_smoke.py`` holds the bf16 tensor-core K1 and K8, the
W8A8 GEMM K7, the float32 LayerNorm K2 and the int8 GEMV K3 to on the
card, against kernels with one known fault, on the CPU: a limit that a
faulty kernel passes checks nothing.

Each fault is written as the plain version with one step changed, run on
inputs from a numpy seed at the shapes the card checks use (K1 at the six
caption-step stages; K8 with the joint head dim and dropout 0.1, cut in
length; K7 at CLIP's qkv cut to 256 rows; K2 on the card's rows of mean 64
and the decode's [8, 576]; K3 at the decode's 8 rows and K = 576, the
vocab cut to 4096 columns), and must miss the plain version by more than
the card's limit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from rtvc_tpu_torch.ops import attention, int8_gemm, layernorm

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# [B·nW, H, N] of K1 per TinyViT stage at batch 1 and 8 (6-frame windows)
K1_STAGES = [(96, 6, 49), (6, 12, 196), (6, 18, 49),
             (768, 6, 49), (48, 12, 196), (48, 18, 49)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


def _k1_unrounded_bias(q, k, v, bias):
    """K1's bf16 mode with the bias added to the bf16 score unrounded."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = ((s * q.shape[-1] ** -0.5).to(q.dtype).float() + bias).to(q.dtype)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


@pytest.mark.parametrize("b,h,n", K1_STAGES,
                         ids=[f"{b}x{h}x{n}" for b, h, n in K1_STAGES])
def test_k1_card_limit_rejects_an_unrounded_bias(b, h, n):
    rng = np.random.default_rng(b * n)
    q, k, v = (_bf16(rng, b, h, n, 32) for _ in range(3))
    bias = torch.from_numpy(0.5 * rng.normal(size=(h, n, n)).astype(
        np.float32))
    want = attention.window_attention_plain(q, k, v, bias,
                                            softmax_in_input_dtype=True)
    tol, floor = chip_smoke.limit("window_attention", "bfloat16")
    _, rel = chip_smoke.rel_err(_k1_unrounded_bias(q, k, v, bias), want,
                                floor)
    assert rel > tol, f"the unrounded bias misses by {rel:.3e} <= {tol:g}"


RATE = 0.1


def _k8_faulty(fault, q, k, v, g, **kw):
    """(dq, dk, dv) of flash_attention_bwd_plain with one step changed."""
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    p, p_used = attention._flash_probs(q32, k32, kw["causal"],
                                       kw["prefix_len"], None, scale, RATE,
                                       kw["seed"])
    kept = p_used > 0.0
    keep = 1.0 if fault == "no 1/keep" else 1.0 - RATE
    dv = torch.matmul(torch.where(kept, p / keep, 0.0).transpose(-1, -2),
                      g32)
    dp = torch.matmul(g32, v32.transpose(-1, -2)) / keep
    if fault != "unmasked dP":
        dp = torch.where(kept, dp, 0.0)
    delta = 0.0 if fault == "no delta" else (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


K8_KW = dict(causal=True, prefix_len=260, seed=12345)


def _k8_case():
    """(q, k, v, g) [2, 3, 300, 64] bf16 and their plain gradients."""
    rng = np.random.default_rng(7)
    args = tuple(_bf16(rng, 2, 3, 300, 64) for _ in range(4))
    return args, attention.flash_attention_bwd_plain(
        *args, dropout_rate=RATE, **K8_KW)


@pytest.mark.parametrize("fault", ["no 1/keep", "no delta", "unmasked dP"])
def test_k8_card_limit_rejects_a_faulty_backward(fault):
    args, want = _k8_case()
    tol, floor = chip_smoke.limit("flash_attention_bwd", "bfloat16")
    rel = max(chip_smoke.rel_err(a, b, floor)[1]
              for a, b in zip(_k8_faulty(fault, *args, **K8_KW), want))
    assert rel > tol, f"{fault}: misses by {rel:.3e} <= {tol:g}"


def test_k8_fault_model_is_the_plain_version_without_a_fault():
    args, want = _k8_case()
    for a, b in zip(_k8_faulty(None, *args, **K8_KW), want):
        torch.testing.assert_close(a.float(), b.float(), atol=0, rtol=0)


def _k7_case():
    """CLIP's qkv [1024 -> 3072] cut to 256 rows, int8 operands and the
    scale and bias ranges of the card's K7 cases: (xq, sx, wq [K, N], sw,
    bias)."""
    rng = np.random.default_rng(11)
    m, k, n = 256, 1024, 3072
    xq, wq = (torch.from_numpy(rng.integers(-127, 128, size=s, dtype=np.int8))
              for s in ((m, k), (k, n)))
    sx = torch.from_numpy((rng.random(m) * 0.02 + 1e-3).astype(np.float32))
    sw = torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.normal(size=n)).astype(np.float32))
    return xq, sx, wq, sw, bias


def _k7_faulty(fault, xq, sx, wq, sw, bias, out_dtype):
    """w8a8_matmul_plain with its float32 epilogue changed."""
    acc = torch.matmul(xq.double(), wq.double()).float()
    t = acc * sx[:, None]
    if fault == "fma epilogue":  # t * sw + bias rounded once
        y = (t.double() * sw.double() + bias.double()).float()
    elif fault == "bias before sw":
        y = (t + bias) * sw
    elif fault == "scales multiplied first":
        y = acc * (sx[:, None] * sw) + bias
    else:
        y = t * sw + bias
    return y.to(out_dtype)


K7_FAULTS = ["fma epilogue", "bias before sw", "scales multiplied first"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", K7_FAULTS)
def test_k7_card_limit_rejects_a_reordered_epilogue(fault, dtype):
    """K7 is held bit for bit: an epilogue that rounds in another order
    misses the plain version by more than 0."""
    args = _k7_case()
    want = int8_gemm.w8a8_matmul_plain(*args, getattr(torch, dtype))
    tol, floor = chip_smoke.limit("w8a8_matmul", dtype)
    _, rel = chip_smoke.rel_err(
        _k7_faulty(fault, *args, getattr(torch, dtype)), want, floor)
    assert tol == 0.0 and rel > tol, f"{fault}: misses by {rel:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_fault_model_is_the_plain_version_without_a_fault(dtype):
    args = _k7_case()
    assert torch.equal(_k7_faulty(None, *args, getattr(torch, dtype)),
                       int8_gemm.w8a8_matmul_plain(*args,
                                                   getattr(torch, dtype)))


def _k2_rows(rows, width, seed=21):
    """Rows of mean 64 and spread 2 (the card's "mean 64" case), weight and
    bias, float32."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, width)) * 2 + 64).astype(np.float32)
    w, b = (rng.normal(size=width).astype(np.float32) for _ in range(2))
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


def _k2_kernel_order(x, w, b, one_pass, eps=1e-5, lanes=32):
    """K2 as a warp sums a row: lane l takes columns l, l + 32, ... in
    order, then a butterfly over the lanes; the variance centred (two
    passes) or as E[x^2] - mean^2 (one pass, the fault)."""
    rows, width = x.shape
    cols = x.reshape(rows, -1, lanes)

    def butterfly(v):
        o = lanes // 2
        while o:
            v = v + v[:, torch.arange(lanes) ^ o]
            o //= 2
        return v[:, :1]

    total = torch.zeros(rows, lanes)
    for i in range(cols.shape[1]):
        total = total + cols[:, i]
    mean = butterfly(total) * (1.0 / width)
    sq = torch.zeros(rows, lanes)
    for i in range(cols.shape[1]):
        d = cols[:, i] if one_pass else cols[:, i] - mean
        sq = sq + d * d
    var = butterfly(sq) * (1.0 / width)
    if one_pass:
        var = var - mean * mean
    return (x - mean) * torch.rsqrt(var + eps) * w + b


K2_SHAPES = [(8, 576), (2352, 576)]


@pytest.mark.parametrize("rows,width", K2_SHAPES,
                         ids=[f"{r}x{w}" for r, w in K2_SHAPES])
def test_k2_card_limit_rejects_a_one_pass_variance(rows, width):
    """In float32 the card holds K2 to 2e-5 of max(1, max|plain|): the TOL
    of 1e-4 passes a one-pass variance at the decode's [8, 576]."""
    x, w, b = _k2_rows(rows, width)
    want = layernorm.layer_norm_plain(x, w, b)
    tol, floor = chip_smoke.limit("layer_norm", "float32")
    _, rel = chip_smoke.rel_err(_k2_kernel_order(x, w, b, True), want, floor)
    assert rel > tol, f"the one-pass variance misses by {rel:.3e} <= {tol:g}"
    _, loose = chip_smoke.rel_err(_k2_kernel_order(x, w, b, True), want)
    assert rows > 8 or loose <= chip_smoke.TOL["float32"]


@pytest.mark.parametrize("rows,width", K2_SHAPES,
                         ids=[f"{r}x{w}" for r, w in K2_SHAPES])
def test_k2_centred_variance_in_kernel_order_is_inside_the_limit(rows,
                                                                 width):
    x, w, b = _k2_rows(rows, width)
    tol, floor = chip_smoke.limit("layer_norm", "float32")
    _, rel = chip_smoke.rel_err(_k2_kernel_order(x, w, b, False),
                                layernorm.layer_norm_plain(x, w, b), floor)
    assert rel <= tol / 4, f"{rel:.3e} of max(1, max|plain|)"


def _k3_case(dtype):
    """x [8, 576] in ``dtype``, wq [576, 4096] int8 and the scale and bias
    ranges of the card's K3 cases."""
    rng = np.random.default_rng(22)
    m, k, n = 8, 576, 4096
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        getattr(torch, dtype))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n),
                                       dtype=np.int8))
    sw = torch.from_numpy((rng.random(n) / (127 * 24)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.normal(size=n)).astype(np.float32))
    return x, wq, sw, bias


def _k3_faulty(fault, x, wq, sw, bias):
    """w8_matmul_plain with one step changed: one 16-wide k-slice (one
    lane's 16-byte load) left out, or x rounded to bf16 first."""
    x32 = x.float()
    if fault == "dropped k-slice":
        x32 = x32.clone()
        x32[:, 16:32] = 0.0
    elif fault == "x rounded to bf16":
        x32 = x32.to(torch.bfloat16).float()
    y = torch.matmul(x32, wq.float()) * sw.reshape(1, -1) + bias
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_card_limit_rejects_a_dropped_k_slice(dtype):
    args = _k3_case(dtype)
    tol, floor = chip_smoke.limit("w8_matmul", dtype)
    _, rel = chip_smoke.rel_err(_k3_faulty("dropped k-slice", *args),
                                int8_gemm.w8_matmul_plain(*args), floor)
    assert rel > tol, f"a dropped k-slice misses by {rel:.3e} <= {tol:g}"


def test_k3_card_limit_rejects_x_rounded_to_bf16():
    """float32 x takes the CUDA-core kernel: the tensor cores' bf16 x would
    be another function."""
    args = _k3_case("float32")
    tol, floor = chip_smoke.limit("w8_matmul", "float32")
    _, rel = chip_smoke.rel_err(_k3_faulty("x rounded to bf16", *args),
                                int8_gemm.w8_matmul_plain(*args), floor)
    assert rel > tol, f"bf16 x misses by {rel:.3e} <= {tol:g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_fault_model_is_the_plain_version_without_a_fault(dtype):
    args = _k3_case(dtype)
    assert torch.equal(_k3_faulty(None, *args),
                       int8_gemm.w8_matmul_plain(*args))
