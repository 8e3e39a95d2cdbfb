"""The port's frozen GIT teacher against the JAX package's.

A tiny teacher (``TINY_GIT`` of tests/test_models.py: CLIP width 32 with
3 blocks, a 2-layer joint decoder of width 16) gets random weights in the
reference ``model.pt`` layout (``make_git_sd`` of
tests/test_convert_fullsize.py); the JAX side reads them through
``git_teacher_params_from_torch``, the port loads them as they are. Inputs
come from numpy seeds; the JAX side runs under
``default_matmul_precision("highest")``, the port its plain versions in
float32 on the CPU. Tolerances:

- 1e-4 for the float teacher's outputs, logits and log-probabilities: a
  few float32 layers whose sums run in another order;
- 1e-2 (of the largest logit) for the quantized teacher: an activation
  that differs by 1e-7 between the two float paths can round to the
  neighbouring int8 value, which moves a sum by one step of that row's
  scale (at this seed none does, and the gap is ~2e-7);
- beam predictions token for token: the output layer is sharpened, and the
  test first asserts that each step's top candidates on the JAX side are
  more than 1e-3 apart, far above the ~1e-5 the two paths differ by.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu import decode as jdecode
from rtvc_tpu.models import clip_vit as jclip
from rtvc_tpu.models import convert as jconvert
from rtvc_tpu.models.git_teacher import GITTeacher as JaxTeacher
from rtvc_tpu.models.git_teacher import quantize_teacher_variables
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch import decode
from rtvc_tpu_torch.models.clip_vit import CLIPViT
from rtvc_tpu_torch.models.convert import teacher_state_dict_from_jax
from rtvc_tpu_torch.models.git_teacher import GITTeacher, _built
from rtvc_tpu_torch.ops.quantization import QuantLinear, quantize_teacher_

from test_convert_fullsize import MID, make_git_sd
from test_models import TINY_GIT

TOL = 1e-4
QUANT_TOL = 1e-2
MIN_MARGIN = 1e-3
TAPS = (0, 2)
FRAMES, SIZE = TINY_GIT.num_image_with_embedding, TINY_GIT.clip.image_size


def port_config(jcfg) -> pconfig.GITConfig:
    """The port's GITConfig with the JAX config's fields (float32)."""
    def fields(c, skip):
        return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
                if f.name not in skip}
    clip = pconfig.CLIPViTConfig(**fields(jcfg.clip, ("dtype",)))
    return pconfig.GITConfig(clip=clip, **fields(jcfg, ("dtype", "clip")))


def teacher_pair(jcfg, sd):
    """(JAX teacher, its variables, the port's teacher) on state dict sd."""
    params, unused = jconvert.git_teacher_params_from_torch(
        sd, num_layers=jcfg.num_layers, clip_layers=jcfg.clip.layers,
        num_frames=jcfg.num_image_with_embedding)
    assert unused == []
    port = GITTeacher(port_config(jcfg))
    port.load_state_dict(sd, strict=True)
    return JaxTeacher(jcfg), {"params": params}, port.eval()


def sharp_sd(eos_boost: float = 0.0) -> dict:
    """TINY_GIT weights with a sharpened output layer and visual projection
    (random logits are otherwise near-flat); ``eos_boost`` raises the EOS
    logit so that beams end early."""
    sd = make_git_sd(TINY_GIT, random=True)
    sd["textual.output.weight"] = sd["textual.output.weight"] * 15
    sd["textual.visual_projection.0.weight"] = (
        sd["textual.visual_projection.0.weight"] * 10)
    sd["textual.output.bias"] = sd["textual.output.bias"].clone()
    sd["textual.output.bias"][102] += eos_boost
    return sd


@pytest.fixture(scope="module")
def teachers():
    return teacher_pair(TINY_GIT, make_git_sd(TINY_GIT, random=True))


def _frames(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


CAPTIONS = np.array([[101, 9, 55, 7, 3], [101, 30, 2, 0, 0]], np.int32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _forward(jmodel, variables, port, frames):
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, f, c: jmodel.apply(
            v, f, c, TAPS, method=JaxTeacher.forward_output_logits))(
            variables, jnp.asarray(frames), jnp.asarray(CAPTIONS))
    with torch.no_grad():
        got = port.forward_output_logits(torch.from_numpy(frames),
                                         torch.from_numpy(CAPTIONS), TAPS)
    return got, want


def test_clip_vit_tokens_and_taps_match_jax(teachers):
    _, variables, port = teachers
    x = _frames(1).reshape(-1, SIZE, SIZE, 3)
    enc = {"params": variables["params"]["image_encoder"]}
    with jax.default_matmul_precision("highest"):
        want, want_taps = jax.jit(lambda v, x: jclip.CLIPViT(
            TINY_GIT.clip).apply(v, x, TAPS))(enc, jnp.asarray(x))
    clip = port.image_encoder
    assert isinstance(clip, CLIPViT)
    with torch.no_grad():
        got, taps = clip(torch.from_numpy(x), TAPS)
        nchw, _ = clip(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2 * FRAMES, 5, TINY_GIT.clip.width)
    _close(got, want, TOL, "tokens")
    _close(nchw, want, TOL, "tokens from NCHW frames")
    assert len(taps) == len(want_taps) == len(TAPS)
    for i, (g, w) in enumerate(zip(taps, want_taps)):
        _close(g, w, TOL, f"tap {i}")


def test_forward_output_logits_match_jax(teachers):
    jmodel, variables, port = teachers
    (logits, visual, hidden, taps), want = _forward(jmodel, variables, port,
                                                    _frames())
    assert logits.shape == (2, 5, TINY_GIT.vocab_size)
    assert visual.shape == (2, FRAMES * 5, TINY_GIT.visual_feature_size)
    _close(logits, want[0], TOL, "logits")
    _close(visual, want[1], TOL, "visual")
    assert len(hidden) == TINY_GIT.num_layers
    for i, (g, w) in enumerate(zip(hidden, want[2])):
        _close(g, w, TOL, f"hidden {i}")
    assert [tuple(t.shape) for t in taps] == [(2, FRAMES, 32)] * len(TAPS)
    for i, (g, w) in enumerate(zip(taps, want[3])):
        _close(g, w, TOL, f"cls tap {i}")


def test_quantized_teacher_matches_jax():
    sd = make_git_sd(TINY_GIT, random=True)
    jcfg = dataclasses.replace(
        TINY_GIT, quantized=True,
        clip=dataclasses.replace(TINY_GIT.clip, quantized=True))
    jmodel, variables, port = teacher_pair(TINY_GIT, sd)
    jmodel = JaxTeacher(jcfg)
    variables = quantize_teacher_variables(variables)
    quantize_teacher_(port)
    linears = [m for m in port.modules() if isinstance(m, torch.nn.Linear)]
    packs = [m for m in port.modules() if isinstance(m, QuantLinear)]
    assert linears == [] and len(packs) == 4 * 3 + 1 + 4 * 2 + 1
    (logits, visual, _, _), want = _forward(jmodel, variables, port,
                                            _frames())
    scale = float(np.abs(np.asarray(want[0])).max())
    _close(visual, want[1], QUANT_TOL, "visual")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]),
                               atol=QUANT_TOL * scale, rtol=0)


@pytest.mark.parametrize("clip_q,head_q", [(True, False), (False, True),
                                           (True, True)])
def test_quantized_flags_pack_the_same_parts_as_jax(clip_q, head_q):
    """``clip.quantized`` packs the CLIP tower, ``quantized`` the textual
    head, each on its own, as they pick QuantDense in JAX."""
    jcfg = dataclasses.replace(
        TINY_GIT, quantized=head_q,
        clip=dataclasses.replace(TINY_GIT.clip, quantized=clip_q))
    shapes = jax.eval_shape(
        JaxTeacher(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, FRAMES, SIZE, SIZE, 3)), jnp.zeros((1, 5), jnp.int32))
    want = {part: sum("kernel_q" in jax.tree_util.keystr(path)
                      for path, _ in jax.tree_util.tree_flatten_with_path(
                          shapes["params"][part])[0])
            for part in ("image_encoder", "textual")}
    port = _built(port_config(jcfg))
    got = {part: sum(isinstance(m, QuantLinear)
                     for m in getattr(port, part).modules())
           for part in ("image_encoder", "textual")}
    assert got == want
    assert (got["image_encoder"] > 0) == clip_q
    assert (got["textual"] > 0) == head_q


def _assert_margins(jout, m):
    """Each computed row of the JAX logit buffer has its top m + 1 raw
    logits more than MIN_MARGIN apart, so the per-beam top-m cannot flip."""
    rows = np.asarray(jout.logits)[:int(jout.num_steps)]
    top = np.sort(rows.reshape(-1, rows.shape[-1]), axis=-1)[:, -(m + 1):]
    assert np.diff(top, axis=-1).min() > MIN_MARGIN


@pytest.mark.parametrize("eos_boost,penalty", [(0.0, 1.0), (0.0, 1.3),
                                               (8.0, 1.0)])
def test_teacher_beam_matches_jax(eos_boost, penalty):
    """Token rows exact, log-probabilities and every step's logits at 1e-4;
    the EOS boost makes hypotheses end early and the loop stop before
    max_steps."""
    jmodel, variables, port = teacher_pair(TINY_GIT, sharp_sd(eos_boost))
    frames = _frames(2)
    kw = dict(beam_size=4, max_steps=8, repetition_penalty=penalty)
    with jax.default_matmul_precision("highest"):
        want = jdecode.teacher_beam(jmodel, variables, jnp.asarray(frames),
                                    **kw)
    _assert_margins(want, 8)
    got = decode.teacher_beam(port, torch.from_numpy(frames), **kw)
    assert got.num_steps == int(want.num_steps)
    assert got.predictions.dtype == torch.int32
    np.testing.assert_array_equal(got.predictions.numpy(),
                                  np.asarray(want.predictions))
    _close(got.logprobs, want.logprobs, TOL, "logprobs")
    assert got.logits.shape == want.logits.shape
    _close(got.logits, want.logits, TOL, "logits")
    if eos_boost:
        assert got.num_steps < kw["max_steps"] - 1


def test_teacher_kd_targets_equal_jax():
    """The same beam output through both packages' kd targets: equal."""
    rng = np.random.default_rng(3)
    steps, b, nb, vocab = 6, 3, 4, 50
    logits = rng.normal(size=(steps, b, nb, vocab)).astype(np.float32)
    logits[:, :, 1] = logits[:, :, 0]  # a tie between beams: first wins
    preds = rng.integers(0, vocab, size=(b, steps + 1)).astype(np.int32)
    lens = np.array([2, 9, 0], np.int32)
    jout = jdecode.TeacherBeamOutput(
        predictions=jnp.asarray(preds), logprobs=jnp.zeros(b),
        logits=jnp.asarray(logits), num_steps=jnp.int32(steps))
    pout = decode.TeacherBeamOutput(
        predictions=torch.from_numpy(preds), logprobs=torch.zeros(b),
        logits=torch.from_numpy(logits), num_steps=steps)
    want_t, want_v = jdecode.teacher_kd_targets(jout, jnp.asarray(lens))
    got_t, got_v = decode.teacher_kd_targets(pout, torch.from_numpy(lens))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_teacher_bridge_round_trip_is_exact():
    """model.pt state dict → git_teacher_params_from_torch →
    teacher_state_dict_from_jax gives the source back, key for key and bit
    for bit (q/k/v split again), and it loads into the port strictly; the
    port's own state dict is in the same keys."""
    sd = make_git_sd(MID, random=True)
    params, unused = jconvert.git_teacher_params_from_torch(
        sd, num_layers=MID.num_layers, clip_layers=MID.clip.layers,
        num_frames=MID.num_image_with_embedding)
    back = teacher_state_dict_from_jax(params)
    source = {k: v for k, v in sd.items() if k not in unused}
    assert sorted(back) == sorted(source)
    for key, value in source.items():
        assert back[key].shape == value.shape, key
        assert torch.equal(back[key], value), key
    port = GITTeacher(port_config(MID))
    port.load_state_dict(back, strict=True)
    mine = port.state_dict()
    assert sorted(mine) == sorted(source)
    for key, value in source.items():
        assert torch.equal(mine[key], value), key
