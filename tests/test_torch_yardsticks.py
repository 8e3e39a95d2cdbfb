"""The kernels' library yardsticks and bounds (rtvc_tpu_torch/yardsticks.py).

``chip_smoke.py`` times one PyTorch library call beside each kernel and
reports each kernel's bound. Here, on the CPU in float32 at small shapes,
each yardstick must compute the same function as the kernel's plain
version (so the times on the card compare like with like), and the bound
arithmetic must give the numbers the records quote for the teacher's
shapes. Tolerances: float32 on both sides, the same products summed in
another order: 1e-5 of max(1, max|plain|) for forward values, 1e-4 for
gradients and 3x3 weight gradients (sums over hundreds of terms).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtvc_tpu_torch import yardsticks as Y
from rtvc_tpu_torch.ops import attention, depthwise, int8_gemm, layernorm


def _rand(seed: int):
    rng = np.random.default_rng(seed)
    return lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))


def _close(got, want, tol: float) -> None:
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(1.0, float(want.float().abs().max())), err


def test_window_yardstick_matches_plain():
    rand = _rand(0)
    q, k, v = (rand(6, 3, 16, 8) for _ in range(3))
    bias = rand(3, 16, 16)
    y = Y.window_library(q, k, v, bias, scale=0.3)
    _close(y.fn(), attention.window_attention_plain(q, k, v, bias, scale=0.3),
           1e-5)


# (causal, prefix_len, key mask): the key mask keeps key 0 and the prefix
# holds it, so every row has an allowed key. A row with none is left out:
# SDPA gives NaN there, the kernel (and its plain version) a uniform
# average of V.
FLASH_CASES = [(False, 0, False), (True, 5, False), (False, 0, True),
               (True, 7, True)]


def _flash_inputs(seed: int, masked: bool):
    rand = _rand(seed)
    q = rand(2, 3, 13, 8)
    k, v = rand(2, 3, 19, 8), rand(2, 3, 19, 8)
    mask = None
    if masked:
        rng = np.random.default_rng(seed + 1)
        mask = torch.from_numpy(rng.random((2, 19)) > 0.4)
        mask[:, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("causal,prefix,masked", FLASH_CASES)
def test_flash_yardstick_matches_plain(causal, prefix, masked):
    q, k, v, mask = _flash_inputs(1, masked)
    kw = dict(causal=causal, prefix_len=prefix, kv_mask=mask, scale=0.4)
    _close(Y.flash_library(q, k, v, **kw).fn(),
           attention.flash_attention_plain(q, k, v, **kw), 1e-5)


def test_flash_yardstick_has_none_for_dropout():
    q, k, v, _ = _flash_inputs(2, False)
    y = Y.flash_library(q, k, v, dropout_rate=0.1)
    assert y.fn is None and y.name.startswith("none")
    assert Y.flash_bwd_library(q, k, v, q, dropout_rate=0.1).fn is None


@pytest.mark.parametrize("causal,prefix,masked", FLASH_CASES)
def test_flash_bwd_yardstick_matches_plain(causal, prefix, masked):
    q, k, v, mask = _flash_inputs(3, masked)
    g = _rand(4)(*q.shape)
    kw = dict(causal=causal, prefix_len=prefix, kv_mask=mask, scale=0.4)
    got = Y.flash_bwd_library(q, k, v, g, **kw).fn()
    want = attention.flash_attention_bwd_plain(q, k, v, g, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("l", [17, 50])
def test_blhd_yardstick_matches_plain(l):
    rand = _rand(5)
    views = rand(2, l, 3 * 4 * 8).view(2, l, 3, 4, 8).unbind(2)
    _close(Y.blhd_library(*views).fn(),
           attention.blhd_attention_plain(*views), 1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_yardstick_matches_plain(eps):
    rand = _rand(6)
    x, w, b = rand(9, 40) * 3.0, rand(40), rand(40)
    _close(Y.layer_norm_library(x, w, b, eps).fn(),
           layernorm.layer_norm_plain(x, w, b, eps), 1e-5)


def test_add_layer_norm_yardstick_matches_plain():
    rand = _rand(7)
    x, d, w, b = rand(9, 40), rand(9, 40), rand(40), rand(40)
    for a, want in zip(Y.add_layer_norm_library(x, d, w, b).fn(),
                       layernorm.fused_add_layer_norm_plain(x, d, w, b)):
        _close(a, want, 1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 9, 9), (3, 4, 7, 5)])
def test_dw3x3_wgrad_yardstick_matches_plain(shape):
    rand = _rand(8)
    x, dy = rand(*shape), rand(*shape)
    _close(Y.dw3x3_wgrad_library(x, dy).fn(),
           depthwise.dw3x3_wgrad_plain(x, dy), 1e-4)


def test_w8_yardstick_plus_bias_matches_plain():
    rand = _rand(9)
    x = rand(4, 64)
    wq = torch.from_numpy(np.random.default_rng(10).integers(
        -127, 128, (64, 24)).astype(np.int8))
    sw, b = rand(24).abs() * 1e-2, rand(24)
    y = Y.w8_library(x, wq, sw, b)
    _close(y.fn() + b, int8_gemm.w8_matmul_plain(x, wq, sw, b), 1e-5)


def test_w8_replaced_projection_is_the_plain_version_unquantized():
    """What vocab_int8 replaces, ``F.linear`` over the float weight, is
    K3's function on the dequantized weight ``wq · sw``."""
    rand = _rand(12)
    x = rand(4, 64)
    wq = torch.from_numpy(np.random.default_rng(13).integers(
        -127, 128, (64, 24)).astype(np.int8))
    sw, b = rand(24).abs() * 1e-2, rand(24)
    y = Y.w8_replaced_library(x, (wq.float() * sw).t(), b)
    _close(y.fn(), int8_gemm.w8_matmul_plain(x, wq, sw, b), 1e-5)


def test_w8a8_yardstick_is_the_exact_int32_product():
    rng = np.random.default_rng(11)
    xq, wq = (torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8))
              for s in ((32, 64), (64, 24)))
    sx = torch.from_numpy(rng.random(32).astype(np.float32)) * 0.02
    sw = torch.from_numpy(rng.random(24).astype(np.float32)) * 1e-3
    b = torch.zeros(24)
    acc = Y.w8a8_library(xq, sx, wq, sw, b, torch.float32).fn()
    assert acc.dtype == torch.int32
    assert torch.equal(acc.long(), xq.long() @ wq.long())
    _close(acc.float() * sx[:, None] * sw,
           int8_gemm.w8a8_matmul_plain(xq, sx, wq, sw, b), 1e-5)


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_joint_attention_bound():
    """K4 at [8, 12, 1582, 64], prefix 1542, on head views of the packed
    QKV: 1542² + Σ(q + 1) over the 40 caption rows allowed pairs per
    (b, h), 59.97 GFLOP, 60.6 µs against 989 TFLOP/s (the bytes, 77.8 MB,
    take 23.2 µs)."""
    assert Y.allowed_pairs(1, 1582, 1582, True, 1542) == 2_440_264
    qkv = _meta(8, 1582, 3 * 12 * 64)
    heads = [t.transpose(1, 2)
             for t in qkv.view(8, 1582, 3, 12, 64).unbind(2)]
    work = Y.flash_work(*heads, causal=True, prefix_len=1542)
    assert work.ops == 96 * 2_440_264 * 4 * 64
    assert round(work.ops / 1e9, 2) == 59.97
    assert round(work.bytes / 1e6, 1) == 77.8
    seconds, by = work.bound()
    assert (round(seconds * 1e6, 1), by) == (60.6, "operations")


def test_clip_attention_bound():
    """K5 at [48, 257, 16, 64]: 75.8 MB of packed QKV read, 25.3 MB
    written, 30.2 µs at 3.35 TB/s (12.99 GFLOP take 13.1 µs)."""
    views = _meta(48, 257, 3 * 16 * 64).view(48, 257, 3, 16, 64).unbind(2)
    work = Y.blhd_work(*views)
    assert round(work.ops / 1e9, 2) == 12.99
    seconds, by = work.bound()
    assert (round(seconds * 1e6, 1), by) == (30.2, "bytes")


@pytest.mark.parametrize("causal,prefix,masked", FLASH_CASES + [
    (True, 0, True)])
def test_allowed_pairs_counts_each_row(causal, prefix, masked):
    """Brute force over the mask K4 applies; a row left with no key counts
    every key (it averages them all)."""
    q, k, _, mask = _flash_inputs(12, masked)
    if mask is not None:
        mask[1] = False                       # batch row 1: no key at all
    allowed = attention._allowed(13, 19, causal, prefix, mask, "cpu")
    per_row = allowed.expand(2, 1, 13, 19).sum(-1)
    want = int(torch.where(per_row == 0, 19, per_row).sum())
    assert Y.allowed_pairs(2, 13, 19, causal, prefix, mask) == want


def _bf16(*shape, offset: int = 0):
    """A bfloat16 tensor of ``shape`` starting ``offset`` elements into a
    fresh (16-byte aligned) buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


def _git_heads():
    qkv = _bf16(2, 7, 3 * 12 * 64)
    return qkv.view(2, 7, 3, 12, 64).unbind(2)[0].transpose(1, 2)


# (tensor, strides the bf16 K4/K5 kernel's TMA maps get over dims 0-2, or
# None where the wrapper must raise)
TMA_CASES = {
    "git head view": (_git_heads, [7 * 2304, 64, 2304]),
    "clip blhd view": (lambda: _bf16(2, 9, 3072).view(2, 9, 3, 16, 64)
                       .unbind(2)[1], [9 * 3072, 3072, 64]),
    "contiguous d40": (lambda: _bf16(2, 3, 5, 40), [600, 200, 40]),
    "single row": (lambda: _bf16(2, 3, 64).as_strided((2, 3, 1, 40),
                                                      (192, 64, 4, 1)),
                   [192, 64, 8]),
    "row pitch 72 bytes": (lambda: _bf16(2, 3, 5, 36), None),
    "base off 16 bytes": (lambda: _bf16(2, 3, 5, 40, offset=1), None),
}


@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_tma_strides_take_packed_views_and_refuse_the_rest(case):
    """The bf16 kernel reads q, k, v through TMA tensor maps, which need a
    16-byte aligned base and strides that are multiples of 16 bytes: the
    packed QKV views of both call sites pass as they are; anything else
    raises instead of falling back. A dim of size 1 is never stepped, so
    its stride is rounded up."""
    make, want = TMA_CASES[case]
    t = make()
    if want is None:
        with pytest.raises(ValueError, match="TMA"):
            attention._tma_strides("k", t, 0, 1, 2)
    else:
        assert attention._tma_strides("k", t, 0, 1, 2) == want


def test_yardsticks_and_chip_smoke_import_no_jax():
    """The yardsticks are timed on the card, where there is no JAX: the
    module and ``chip_smoke.py`` import neither it nor the JAX package."""
    code = ("import sys\n"
            "import rtvc_tpu_torch.yardsticks, chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'rtvc_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
