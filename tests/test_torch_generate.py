"""The port's sampled teacher beam, ``teacher_generate`` and
``top_k_top_p_filtering`` against the JAX package's, and the decode
repairs.

The tiny teacher of tests/test_torch_teacher.py (float32, weights carried
across in the reference ``model.pt`` layout, the output layer sharpened)
runs ``teacher_beam(do_sample=True, ...)`` in both packages. JAX draws
each step's Gumbel noise as ``jax.random.gumbel(fold_in(rng, cur_len))``;
the port's ``decode.gumbel_noise`` is replaced by that same draw, so both
sample from the same noise, and the rows must agree token for token, the
log-probabilities and every step's logits within 1e-5. One case keeps
three candidates a beam under top-k 2: the third pick is a tie among -inf
logits, which the stable top-k breaks lowest word first, as JAX's does.
``top_k_top_p_filtering`` is held bit for bit against JAX's (and against
transformers' warpers, as tests/test_parity_hf.py holds JAX's).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu import decode as jdecode
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
from rtvc_tpu_torch import decode
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

from test_models import TINY_GIT
from test_torch_beam import jax_student, port_student, scaled
from test_torch_models import FRAMES as STUDENT_FRAMES
from test_torch_models import SIZE as STUDENT_SIZE
from test_torch_teacher import _frames, sharp_sd, teacher_pair

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def teachers():
    return teacher_pair(TINY_GIT, sharp_sd())


FILTER_CASES = [dict(top_k=5), dict(top_k=1), dict(top_p=0.5),
                dict(top_p=0.9), dict(top_k=10, top_p=0.8),
                dict(top_k=3, min_tokens_to_keep=1),
                dict(top_p=0.05, min_tokens_to_keep=3),
                dict(top_k=60, top_p=0.99)]


@pytest.mark.parametrize("kw", FILTER_CASES,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              for c in FILTER_CASES])
def test_top_k_top_p_filtering_is_bit_equal_to_jax(kw):
    logits = np.random.default_rng(3).normal(size=(4, 50)).astype(
        np.float32) * 3
    logits[0, 7] = logits[0, 9]           # a tie at the threshold
    want = np.asarray(jdecode.top_k_top_p_filtering(jnp.asarray(logits),
                                                    **kw))
    got = decode.top_k_top_p_filtering(torch.from_numpy(logits), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_top_p_filtering_matches_hf_warpers():
    """The same fuzz as tests/test_parity_hf.py's, on the port's copy."""
    transformers = pytest.importorskip("transformers")
    from transformers.generation import TopKLogitsWarper, TopPLogitsWarper
    del transformers
    rng = np.random.RandomState(7)
    for trial in range(20):
        logits = rng.randn(3, 50).astype(np.float32) * 3
        top_k = int(rng.choice([0, 1, 3, 10, 49]))
        top_p = float(rng.choice([0.0, 0.1, 0.5, 0.9, 0.99]))
        keep = int(rng.choice([1, 2]))
        want = torch.from_numpy(logits)
        if top_k > 0:
            want = TopKLogitsWarper(top_k, min_tokens_to_keep=keep)(None,
                                                                     want)
        if top_p > 0.0:
            want = TopPLogitsWarper(top_p, min_tokens_to_keep=keep)(None,
                                                                     want)
        got = decode.top_k_top_p_filtering(torch.from_numpy(logits),
                                           top_k=top_k, top_p=top_p,
                                           min_tokens_to_keep=keep)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"trial {trial}")


def _jax_noise(rng):
    """``decode.gumbel_noise`` drawing JAX's noise for each step."""
    def noise(generator, shape, step):
        return torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(rng, step), shape)))
    return noise


SAMPLE_CASES = {
    "top-p 0.9": dict(top_p=0.9),
    "t 0.7 top-k 50 top-p 0.9": dict(temperature=0.7, top_k=50, top_p=0.9),
    "3 a beam, top-k 2": dict(per_node_beam_size=3, top_k=2),
    "penalty 1.3, t 1.5": dict(repetition_penalty=1.3, temperature=1.5),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sampled_teacher_beam_matches_jax(teachers, monkeypatch, case):
    jmodel, variables, port = teachers
    frames = _frames(5)
    kw = dict(beam_size=4, max_steps=8, do_sample=True,
              **SAMPLE_CASES[case])
    rng = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("highest"):
        want = jdecode.teacher_beam(jmodel, variables, jnp.asarray(frames),
                                    rng=rng, **kw)
    monkeypatch.setattr(decode, "gumbel_noise", _jax_noise(rng))
    got = decode.teacher_beam(port, torch.from_numpy(frames), **kw)
    assert got.num_steps == int(want.num_steps)
    np.testing.assert_array_equal(got.predictions.numpy(),
                                  np.asarray(want.predictions))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=TOL, atol=TOL)


def test_sampled_teacher_beam_follows_its_generator(teachers):
    """The same generator seed gives the same rows; another seed other
    rows; the default generator is seeded 0."""
    _, _, port = teachers
    frames = torch.from_numpy(_frames(6))
    kw = dict(beam_size=4, max_steps=8, do_sample=True, top_k=20)

    def rows(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return decode.teacher_beam(port, frames, generator=g,
                                   **kw).predictions
    a, b = rows(0), rows(1)
    assert torch.equal(a, rows(0)) and torch.equal(a, rows(None))
    assert not torch.equal(a, b)
    assert bool((a[:, 0] == 101).all())


def test_teacher_generate_matches_jax(teachers):
    jmodel, variables, port = teachers
    frames = _frames(7)
    kw = dict(beam_size=3, max_steps=8)
    with jax.default_matmul_precision("highest"):
        want = jdecode.teacher_generate(jmodel, variables, jnp.asarray(frames),
                                        JaxTokenizer(), **kw)
    tok = BertWordPieceTokenizer()
    got = decode.teacher_generate(port, torch.from_numpy(frames), tok, **kw)
    assert len(got) == len(want) == frames.shape[0]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"predictions", "cap", "output",
                                    "logprobs"}
        np.testing.assert_array_equal(g["predictions"], w["predictions"])
        assert g["cap"] == w["cap"] == tok.decode(g["predictions"])
        assert g["output"].shape == w["output"].shape
        assert g["output"].shape[:1] == (1,) and g["output"].ndim == 3
        np.testing.assert_allclose(g["output"].numpy(),
                                   np.asarray(w["output"]), rtol=TOL,
                                   atol=TOL)
        assert abs(g["logprobs"] - w["logprobs"]) <= TOL * max(
            1.0, abs(w["logprobs"]))


def test_student_beam_of_one_token_is_the_cls_column():
    """JAX drops the out-of-range write of the first word at max_len 1,
    leaving rows of CLS alone; the port returns the same."""
    jmodel, variables = jax_student()
    variables = scaled(variables)
    port = port_student(variables)
    frames = np.random.default_rng(4).normal(
        size=(2, STUDENT_FRAMES, STUDENT_SIZE, STUDENT_SIZE, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdecode.student_beam(
            jmodel, variables, jnp.asarray(frames), max_len=1, k=2))
    got = decode.student_beam(port, torch.from_numpy(frames), max_len=1, k=2)
    assert want.shape == (2, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_steps", [0, 1])
def test_teacher_beam_needs_two_steps(teachers, max_steps):
    _, _, port = teachers
    with pytest.raises(ValueError, match="max_steps"):
        decode.teacher_beam(port, torch.from_numpy(_frames()),
                            max_steps=max_steps)


def test_teacher_beam_of_two_steps_matches_jax(teachers):
    """The shortest beam the port takes: one decoded token, as JAX."""
    jmodel, variables, port = teachers
    frames = _frames(8)
    with jax.default_matmul_precision("highest"):
        want = jdecode.teacher_beam(jmodel, variables, jnp.asarray(frames),
                                    max_steps=2)
    got = decode.teacher_beam(port, torch.from_numpy(frames), max_steps=2)
    np.testing.assert_array_equal(got.predictions.numpy(),
                                  np.asarray(want.predictions))



def test_changed_port_modules_import_without_jax():
    """The modules this slice adds to or changes import with jax, flax,
    the JAX package, PyYAML and transformers blocked (the card's machine
    has no jax; the yaml loader imports PyYAML on first use)."""
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'rtvc_tpu', 'yaml',\n"
            "             'transformers'):\n"
            "    sys.modules[name] = None\n"
            "import rtvc_tpu_torch.decode, rtvc_tpu_torch.ops.attention\n"
            "import rtvc_tpu_torch.ops.layernorm, rtvc_tpu_torch._build\n"
            "import rtvc_tpu_torch.models.convert\n"
            "import rtvc_tpu_torch.models.git_teacher\n"
            "import rtvc_tpu_torch.data.teacher_cache, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'flax', 'rtvc_tpu', 'yaml', 'transformers')\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
