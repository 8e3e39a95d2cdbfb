"""The port's caption step against the JAX package's, token for token.

uint8 windows ``[2, 2, 80, 96, 3]`` from a numpy seed go through both
``make_caption_step``s (crop 64, greedy, ``max_len`` 8) with the same
weights, the default step and the ``vocab_int8`` step each against its JAX
counterpart. Random weights give near-flat logits, where any rounding
difference flips an argmax, so the vocab projection is scaled up and the
test first asserts that every step's top-1/top-2 logit margin on the JAX
side exceeds 1e-3, far above the ~1e-5 the two float32 paths differ by.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu import serving as jserving
from rtvc_tpu.ops.preprocess import clip_preprocess as jax_preprocess
from rtvc_tpu_torch import serving

from test_torch_models import (FRAMES, jax_decode_fns, jax_student,
                               port_student)

MAX_LEN = 8
CROP = 64
LOGIT_SCALE = 10.0
MIN_MARGIN = 1e-3
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def students():
    jmodel, variables = jax_student()
    params = dict(variables["params"])
    params["linear"] = {k: v * LOGIT_SCALE
                        for k, v in params["linear"].items()}
    variables = dict(variables, params=params)
    return jmodel, variables, port_student(variables)


def _windows() -> np.ndarray:
    """A dark and a bright window, so that the two rows differ."""
    w = np.random.default_rng(11).integers(
        0, 128, size=(2, FRAMES, 80, 96, 3), dtype=np.uint8)
    w[1] += 128
    return w


def _assert_jax_margins(jmodel, variables, windows, tokens, pack):
    """Replay the JAX greedy path step by step: each step's argmax is the
    JAX row's token, by a margin of at least MIN_MARGIN."""
    b, w = windows.shape[:2]
    proc = jax_preprocess(jnp.asarray(windows.reshape((b * w,)
                                                      + windows.shape[2:])),
                          crop_size=CROP)
    proc = proc.reshape((b, w) + proc.shape[1:])
    total = 1 + MAX_LEN
    prefill, step = jax_decode_fns(jmodel, b, total)
    _, caches = prefill(variables, proc)
    pos = np.arange(total)[None, :]
    for i in range(MAX_LEN):
        mask = (pos <= i) & (tokens != 0)
        logits, caches = step(variables, jnp.asarray(tokens[:, i]), i,
                              caches, jnp.asarray(mask), pack)
        logits = np.asarray(logits)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MIN_MARGIN, f"step {i}"
        nxt = logits.argmax(-1)
        np.testing.assert_array_equal(nxt, tokens[:, i + 1])
        if (nxt == jmodel.sep_token_id).all():
            break


@pytest.mark.parametrize("vocab_int8", [False, True])
def test_caption_step_tokens_equal_jax(students, vocab_int8):
    jmodel, variables, port = students
    windows = _windows()
    jvars = jserving.with_vocab_w8(variables) if vocab_int8 else variables
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jserving.make_caption_step(
            jmodel, max_len=MAX_LEN, crop_size=CROP,
            vocab_int8=vocab_int8)(jvars, jnp.asarray(windows)))
        _assert_jax_margins(jmodel, variables, windows, want,
                            jvars["vocab_w8"] if vocab_int8 else None)
    if vocab_int8:
        serving.with_vocab_w8(port)
    got = serving.make_caption_step(port, max_len=MAX_LEN, crop_size=CROP,
                                    vocab_int8=vocab_int8)(
        torch.from_numpy(windows))
    assert got.dtype == torch.int32 and got.shape == (2, 1 + MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)
    for row_got, row_want in zip(got.numpy(), want):
        np.testing.assert_array_equal(serving.truncate_at_sep(row_got),
                                      jserving.truncate_at_sep(row_want))


def test_vocab_int8_step_needs_the_pack(students):
    _, _, port = students
    fresh = port_student(students[1])
    with pytest.raises(ValueError, match="with_vocab_w8"):
        serving.make_caption_step(fresh, vocab_int8=True)


def test_port_imports_no_jax_flax_or_cv2():
    modules = ["rtvc_tpu_torch", "rtvc_tpu_torch._build",
               "rtvc_tpu_torch.config", "rtvc_tpu_torch.ops.preprocess",
               "rtvc_tpu_torch.ops.layernorm", "rtvc_tpu_torch.ops.attention",
               "rtvc_tpu_torch.ops.quantization",
               "rtvc_tpu_torch.ops.int8_gemm",
               "rtvc_tpu_torch.models.layers", "rtvc_tpu_torch.models.tinyvit",
               "rtvc_tpu_torch.models.student",
               "rtvc_tpu_torch.models.clip_vit",
               "rtvc_tpu_torch.models.git_teacher",
               "rtvc_tpu_torch.models.convert", "rtvc_tpu_torch.decode",
               "rtvc_tpu_torch.serving", "rtvc_tpu_torch.profile_teacher",
               "rtvc_tpu_torch.profile_w8", "rtvc_tpu_torch.profile_w8a8",
               "rtvc_tpu_torch.ops.dropout", "rtvc_tpu_torch.ops.depthwise",
               "rtvc_tpu_torch.distill", "rtvc_tpu_torch.train",
               "rtvc_tpu_torch.tokenization",
               "rtvc_tpu_torch.tokenization.vocab",
               "rtvc_tpu_torch.tokenization.wordpiece",
               "rtvc_tpu_torch.data.io", "rtvc_tpu_torch.utils.profiling",
               "rtvc_tpu_torch.serving_http",
               "rtvc_tpu_torch.real_time_inference"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cv2', 'rtvc_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
