"""The port's ops against the JAX package (rtvc_tpu_torch.ops).

Inputs come from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode under ``default_matmul_precision("highest")``; the port runs
the plain versions its wrappers take for CPU tensors. Tolerances:

- 1e-5 for the float32 kernels (window attention, LayerNorm, w8 GEMV):
  the same arithmetic, summed in another order;
- int8 packs identical, scales to 1e-7: the same float32 rounding;
- 1e-4 after CLIP normalize for preprocess: two bicubic implementations
  (≈5e-6 before the divide by std ≈ 0.27).

The ``cuda`` tests compare each kernel with its plain version on a card and
skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.ops import attention as jattention
from rtvc_tpu.ops import int8_gemm as jint8_gemm
from rtvc_tpu.ops import layernorm as jlayernorm
from rtvc_tpu.ops import preprocess as jpreprocess
from rtvc_tpu.ops import quantization as jquantization
from rtvc_tpu_torch.ops import attention, int8_gemm, layernorm, preprocess
from rtvc_tpu_torch.ops import quantization

KERNEL_WRAPPERS = (attention.window_attention, layernorm.layer_norm,
                   int8_gemm.w8_matmul)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _window_inputs(n: int, seed: int = 0, b: int = 6, h: int = 2,
                   d: int = 32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(h, n, n)).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("n", [49, 16])
def test_window_attention_matches_jax(n, native):
    q, k, v, bias = _window_inputs(n)
    d = q.shape[-1]
    with jax.default_matmul_precision("highest"):
        want = jattention.window_attention(
            *map(jnp.asarray, (q, k, v, bias)), scale=d ** -0.5,
            softmax_in_input_dtype=native, interpret=True)
    got = attention.window_attention(*map(_t, (q, k, v, bias)),
                                     scale=d ** -0.5,
                                     softmax_in_input_dtype=native)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


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


@pytest.mark.parametrize("with_bias", [True, False])
def test_w8_matmul_matches_jax(with_bias):
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
    got = int8_gemm.w8_dense(_t(x)[None], _t(wq), _t(sw),
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


def test_cpu_tensors_never_launch_a_kernel():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    q, k, v, bias = map(_t, _window_inputs(16))
    attention.window_attention(q, k, v, bias)
    layernorm.layer_norm(q, torch.ones(32), torch.zeros(32))
    int8_gemm.w8_matmul(torch.ones(2, 8), torch.ones(8, 4, dtype=torch.int8),
                        torch.ones(4))
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0, 0, 0]


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

    wq = torch.randint(-127, 128, (576, 1024), generator=g,
                       dtype=torch.int8).to(cuda)
    sw, bb = rand(1024).abs() * 1e-3, rand(1024)
    for m in (1, 8):
        xm = rand(m, 576).to(dtype)
        got = int8_gemm.w8_matmul(xm, wq, sw, bb)
        want = int8_gemm.w8_matmul_plain(xm, wq, sw, bb)
        assert (got.float() - want.float()).abs().max() <= tol * 4
    torch.cuda.synchronize()
