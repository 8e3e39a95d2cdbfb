"""The port's models against the JAX package (rtvc_tpu_torch.models).

Weights are the JAX model's, perturbed from a numpy seed and carried over by
the port's weight bridge (``student_state_dict_from_jax``); inputs come from
numpy. The JAX side runs under ``default_matmul_precision("highest")``, the
port its plain versions in float32 on the CPU. Tolerance 1e-4: float32
through a few layers whose sums run in another order in the two
frameworks.
"""

import dataclasses
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu import config as jconfig
from rtvc_tpu.models import clip_vit as jclip_vit
from rtvc_tpu.models import convert as jconvert
from rtvc_tpu.models import git_teacher as jgit_teacher
from rtvc_tpu.models import tinyvit as jtinyvit
from rtvc_tpu.models.student import StudentCandidateV1 as JaxStudent
from rtvc_tpu.ops.quantization import quantize_vocab_head as jax_vocab_pack
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch.models.convert import student_state_dict_from_jax
from rtvc_tpu_torch.models.student import StudentCandidateV1
from rtvc_tpu_torch.models.tinyvit import TinyViT
from rtvc_tpu_torch.ops.quantization import quantize_vocab_head

from test_models import TINY_ENC, tiny_student

FRAMES = 2  # frames per window in the tiny student
SIZE = 64   # frame size the tiny encoder is built for
TOL = 1e-4


def randomize(variables, seed: int = 1):
    """Perturb biases, norm scales, BN statistics and the relative-position
    tables (all zeros or ones at JAX init) from a numpy seed, so that every
    weight the bridge carries is distinct."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, Mapping):
                out[key] = walk(value)
                continue
            a = np.asarray(value, np.float32)
            if key == "var":
                a = rng.uniform(0.5, 1.5, a.shape)
            elif key == "scale":
                a = 1.0 + 0.2 * rng.standard_normal(a.shape)
            elif key in ("bias", "mean", "in_proj_bias", "attention_biases"):
                a = 0.2 * rng.standard_normal(a.shape)
            out[key] = a.astype(np.float32)
        return out

    return walk(variables)


def jax_student(gelu_approximate: bool = True, size: int = SIZE):
    """Tiny JAX student (test_models.tiny_student) with every head built,
    for frames of ``size`` pixels (the relative-position tables depend on
    the stage maps' sizes)."""
    enc = dataclasses.replace(TINY_ENC, gelu_approximate=gelu_approximate)
    model = tiny_student(encoder_config=enc, dropout=0.0)
    x = jnp.zeros((1, FRAMES, size, size, 3))
    y = jnp.array([[model.cls_token_id, 5]], jnp.int32)
    # one jitted init: op-by-op eager init compiles each op on its own
    variables = jax.jit(lambda key: model.init(
        key, x, y, method=JaxStudent.full_init))(jax.random.PRNGKey(0))
    return model, randomize(variables)


def port_encoder_config(gelu_approximate: bool) -> pconfig.TinyViTConfig:
    return pconfig.TinyViTConfig(
        embed_dims=TINY_ENC.embed_dims, depths=TINY_ENC.depths,
        num_heads=TINY_ENC.num_heads, window_sizes=TINY_ENC.window_sizes,
        drop_path_rate=0.0, gelu_approximate=gelu_approximate)


def port_student(variables, gelu_approximate: bool = True,
                 input_size: int = SIZE) -> StudentCandidateV1:
    """The port's tiny student carrying the JAX variables."""
    model = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, num_decoder_layers=2,
        vocab_size=211, max_pos_len=64,
        encoder_config=port_encoder_config(gelu_approximate),
        input_size=input_size, num_frames=FRAMES, teacher_visual_dim=32,
        teacher_num_tokens=10, teacher_hidden=16)
    sd = student_state_dict_from_jax(variables["params"],
                                     variables["batch_stats"])
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert unexpected == []
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return model.eval()


def jax_decode_fns(jmodel, batch: int, total: int):
    """Jitted JAX (prefill, step): prefill encodes frames and builds the
    caches, step is one ``decode_step``."""
    def prefill(v, frames):
        def go(m, frames):
            memory = m.forward_image_enc(frames)[1]
            return memory, m.init_cache(batch, total, memory)
        return jmodel.apply(v, frames, method=go)

    def step(v, token, i, caches, mask, pack):
        return jmodel.apply(v, token, i, caches, mask, pack,
                            method=lambda m, t, i_, c, k, vw: m.decode_step(
                                t, i_, c, k, vocab_w8=vw))

    return jax.jit(prefill), jax.jit(step)


@pytest.fixture(scope="module")
def students():
    jmodel, variables = jax_student()
    return jmodel, variables, port_student(variables)


def _frames(seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_tinyvit_stage_maps_match_jax(gelu_approximate):
    _, variables = jax_student(gelu_approximate)
    enc_vars = {"params": variables["params"]["image_encoder"],
                "batch_stats": variables["batch_stats"]["image_encoder"]}
    x = _frames().reshape(-1, SIZE, SIZE, 3)
    cfg = dataclasses.replace(TINY_ENC, gelu_approximate=gelu_approximate)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jtinyvit.TinyViT(cfg).apply)(enc_vars, jnp.asarray(x))

    port = TinyViT(port_encoder_config(gelu_approximate), input_size=SIZE)
    prefix = "image_encoder.model."
    sd = {k[len(prefix):]: v for k, v in student_state_dict_from_jax(
        {"image_encoder": enc_vars["params"]},
        {"image_encoder": enc_vars["batch_stats"]}).items()}
    port.load_state_dict(sd, strict=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=f"stage {s}")


def test_forward_decoder_matches_jax(students):
    jmodel, variables, port = students
    x = _frames()
    y = np.array([[101, 5, 7, 11, 0], [101, 3, 0, 0, 0]], np.int32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jmodel.apply)(variables, jnp.asarray(x),
                                     jnp.asarray(y))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    keep = y != 0  # torch and JAX both compute padded queries; compare real
    np.testing.assert_allclose(got[-1].numpy()[keep],
                               np.asarray(want[-1])[keep], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("vocab_w8", [False, True])
def test_decode_step_logits_match_jax(students, vocab_w8):
    """Per-step logits over a preallocated cache, with the greedy key mask
    (pos <= i) & (tokens != 0) and a pad id inside the sequence."""
    jmodel, variables, port = students
    tokens = np.array([[101, 5, 0, 9, 102], [101, 3, 102, 4, 8]], np.int32)
    total = tokens.shape[1]
    jpack = jax_vocab_pack(variables) if vocab_w8 else None
    ppack = quantize_vocab_head(port.linear) if vocab_w8 else None
    x = _frames(5)

    jax_prefill, jax_step = jax_decode_fns(jmodel, 2, total)
    with jax.default_matmul_precision("highest"):
        memory, caches = jax_prefill(variables, jnp.asarray(x))
    with torch.no_grad():
        _, pmemory = port.forward_image_enc(torch.from_numpy(x))
        pcaches = port.init_cache(2, total, pmemory)
    np.testing.assert_allclose(pmemory.numpy(), np.asarray(memory), atol=TOL,
                               rtol=TOL)
    pos = np.arange(total)[None, :]
    for i in range(total - 1):
        mask = (pos <= i) & (tokens != 0)
        with jax.default_matmul_precision("highest"):
            want, caches = jax_step(variables, jnp.asarray(tokens[:, i]), i,
                                    caches, jnp.asarray(mask), jpack)
        with torch.no_grad():
            got, pcaches = port.decode_step(
                torch.from_numpy(tokens[:, i]), i, pcaches,
                torch.from_numpy(mask), vocab_w8=ppack)
        assert got.shape == (2, 211)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=f"step {i}")


def _assert_same_tree(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for key in a:
        if isinstance(a[key], Mapping):
            _assert_same_tree(a[key], b[key], f"{path}/{key}")
        else:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.shape == y.shape and x.dtype == y.dtype, f"{path}/{key}"
            assert np.array_equal(x, y), f"{path}/{key}"


def test_weight_bridge_round_trip_is_exact(students):
    """JAX init → student_state_dict_from_jax → the port module →
    its state_dict → rtvc_tpu's student_params_from_torch gives the same
    tree back, bit for bit."""
    _, variables, port = students
    sd = port.state_dict()
    params, stats, unused = jconvert.student_params_from_torch(
        sd, num_decoder_layers=2, encoder_depths=TINY_ENC.depths)
    assert unused == []
    _assert_same_tree(params, variables["params"])
    _assert_same_tree(stats, variables["batch_stats"])


def test_config_defaults_equal_jax():
    jcfg = jconfig.Config()
    assert (dataclasses.asdict(pconfig.StudentConfig())
            == dataclasses.asdict(jcfg.student))
    assert (dataclasses.asdict(pconfig.TeacherConfig())
            == dataclasses.asdict(jcfg.teacher))
    assert (dataclasses.asdict(pconfig.DataConfig())
            == dataclasses.asdict(jcfg.data))
    assert (dataclasses.asdict(pconfig.LoggerConfig())
            == dataclasses.asdict(jcfg.logger))

    def same_fields(jc, pc):
        assert ({f.name for f in dataclasses.fields(jc)}
                == {f.name for f in dataclasses.fields(pc)})
        for f in dataclasses.fields(jc):
            j, p = getattr(jc, f.name), getattr(pc, f.name)
            if f.name == "dtype":
                assert jnp.dtype(j).name == str(p).removeprefix("torch.")
            elif f.name == "clip":
                same_fields(j, p)
            else:
                assert j == p, f.name

    same_fields(jtinyvit.tiny_vit_21m_config(), pconfig.tiny_vit_21m_config())
    same_fields(jclip_vit.clip_vit_l14_config(), pconfig.clip_vit_l14_config())
    same_fields(jgit_teacher.GITConfig(), pconfig.GITConfig())
    pcfg = pconfig.Config()
    assert pcfg.compute_dtype == jcfg.tpu.compute_dtype
    assert pcfg.quantize_teacher == jcfg.tpu.quantize_teacher
    assert pcfg.data == pconfig.DataConfig()
    assert pcfg.logger == pconfig.LoggerConfig()
    assert pcfg.train.eval_beam_size == jcfg.train.eval_beam_size
    assert pcfg.seed == jcfg.seed
