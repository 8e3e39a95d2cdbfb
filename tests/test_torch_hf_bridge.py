"""The port's transformers weight bridge (``clip_params_from_hf``,
``git_teacher_params_from_hf``, ``git_config_from_hf``) and
``load_teacher_param_yaml``, against transformers' own models and the JAX
package's bridge.

Random-config ``CLIPVisionModel`` and ``GitForCausalLM`` are built in
process, as tests/test_parity_hf.py builds them (nothing is downloaded).
The port, loaded from their state dicts, must give transformers' float32
logits within 3e-5, and its ``decode_step`` must give the logits of
transformers' cached greedy ``generate`` within 3e-5, token for token; its
teacher must equal the JAX teacher loaded through JAX's bridge from the
same state dict, within 3e-5. Nothing is left unused.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.models import convert as jconvert
from rtvc_tpu.models import git_teacher as jgit
from rtvc_tpu.models.clip_vit import CLIPViTConfig as JaxCLIPConfig
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch.models import convert, git_teacher
from rtvc_tpu_torch.models.clip_vit import CLIPViT
from rtvc_tpu_torch.models.git_teacher import GITTeacher

# transformers' model classes import TensorFlow where it is installed
# (~7 s), which these tests never use
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

TOL = 3e-5
FRAMES, WIDTH, LAYERS = 3, 64, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def test_clip_vit_loaded_from_hf_matches_hf_clip_vision():
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=WIDTH, intermediate_size=4 * WIDTH,
        num_hidden_layers=3, num_attention_heads=4, image_size=32,
        patch_size=16, hidden_act="quick_gelu", layer_norm_eps=1e-5,
        attention_dropout=0.0)).eval()
    sd, unused = convert.clip_params_from_hf(hf.state_dict(),
                                             prefix="vision_model.")
    assert unused == []
    ours = CLIPViT(pconfig.CLIPViTConfig(image_size=32, patch_size=16,
                                         width=WIDTH, layers=3, heads=4))
    ours.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 32, 32)
                         .astype(np.float32))
    with torch.no_grad():
        out = hf(pixel_values=x, output_hidden_states=True)
        want = hf.vision_model.post_layernorm(out.last_hidden_state)
        got, taps = ours.eval()(x, block_indices=[0, 1, 2])
    _close(got, want, "tokens")
    for i, tap in enumerate(taps):
        _close(tap, out.hidden_states[i + 1], f"block {i}")


def _hf_git(temporal_spelling: str = "temporal", tied: bool = False):
    """A random GitForCausalLM and its state dict, in one of the two
    spellings of the temporal embedding, with or without its own
    ``output.weight`` (a tied dump carries only the word embedding)."""
    torch.manual_seed(0)
    cfg = transformers.GitConfig(
        vision_config=dict(hidden_size=WIDTH, intermediate_size=4 * WIDTH,
                           num_hidden_layers=LAYERS, num_attention_heads=4,
                           image_size=32, patch_size=16,
                           hidden_act="quick_gelu", layer_norm_eps=1e-5),
        vocab_size=99, hidden_size=48, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=192,
        max_position_embeddings=64, hidden_act="gelu",
        layer_norm_eps=1e-12, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, num_image_with_embedding=FRAMES)
    hf = transformers.GitForCausalLM(cfg).eval()
    with torch.no_grad():
        for emb in hf.git.img_temporal_embedding:
            emb.copy_(torch.randn_like(emb) * 0.1)
        if tied:
            hf.output.weight.copy_(hf.git.embeddings.word_embeddings.weight)
    sd = dict(hf.state_dict())
    if temporal_spelling == "temperal":
        sd = {k.replace("img_temporal_embedding", "img_temperal_embedding"): v
              for k, v in sd.items()}
    if tied:
        del sd["output.weight"]
    return hf, cfg, sd


def _port_teacher(cfg, sd) -> GITTeacher:
    kw = convert.git_config_from_hf(cfg)
    clip = pconfig.CLIPViTConfig(**kw.pop("clip_kwargs"))
    model = GITTeacher(pconfig.GITConfig(clip=clip, dropout=0.0, **kw))
    state, unused = convert.git_teacher_params_from_hf(sd)
    assert unused == []
    model.load_state_dict(state, strict=True)
    return model.eval()


def _inputs():
    rng = np.random.RandomState(2)
    pixel = rng.randn(2, FRAMES, 3, 32, 32).astype(np.float32)
    tokens = rng.randint(0, 99, size=(2, 7))
    return pixel, tokens


@pytest.mark.parametrize("spelling,tied", [("temporal", False),
                                           ("temperal", False),
                                           ("temporal", True)])
def test_git_teacher_loaded_from_hf_matches_hf(spelling, tied):
    hf, cfg, sd = _hf_git(spelling, tied)
    ours = _port_teacher(cfg, sd)
    pixel, tokens = _inputs()
    n_visual = FRAMES * ((32 // 16) ** 2 + 1)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(tokens),
                  pixel_values=torch.from_numpy(pixel)).logits[:, n_visual:]
        got = ours(torch.from_numpy(pixel), torch.from_numpy(tokens).int())
    _close(got, want, "logits")


def test_decode_steps_match_hf_cached_generate():
    hf, cfg, sd = _hf_git()
    ours = _port_teacher(cfg, sd)
    pixel, _ = _inputs()
    cls_id, steps = 1, 5
    with torch.no_grad():
        gen = hf.generate(
            pixel_values=torch.from_numpy(pixel),
            input_ids=torch.full((2, 1), cls_id, dtype=torch.long),
            do_sample=False, num_beams=1, max_new_tokens=steps,
            eos_token_id=None, pad_token_id=0, use_cache=True,
            output_scores=True, return_dict_in_generate=True)
        visual = ours.encode_only(torch.from_numpy(pixel))
        caches = ours.init_cache(visual, steps + 1)
        tok = torch.full((2,), cls_id, dtype=torch.int32)
        for t in range(steps):
            logits, caches = ours.decode_step(tok, t, caches,
                                              visual.shape[1])
            _close(logits, gen.scores[t], f"step {t}")
            tok = logits.argmax(-1).int()
            np.testing.assert_array_equal(tok.numpy(),
                                          gen.sequences[:, t + 1].numpy())


def test_port_teacher_from_hf_equals_jax_teacher_from_jax_bridge():
    hf, cfg, sd = _hf_git()
    ours = _port_teacher(cfg, sd)
    params, unused = jconvert.git_teacher_params_from_hf(sd)
    assert unused == []
    kw = jconvert.git_config_from_hf(cfg)
    jcfg = jgit.GITConfig(clip=JaxCLIPConfig(**kw.pop("clip_kwargs")),
                          dropout=0.0, **kw)
    pixel, tokens = _inputs()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jgit.GITTeacher(jcfg).apply)(
            {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(pixel),
            jnp.asarray(tokens))
    with torch.no_grad():
        got = ours(torch.from_numpy(pixel), torch.from_numpy(tokens).int())
    _close(got, want, "logits")


def test_git_config_from_hf_equals_jax():
    _, cfg, _ = _hf_git()
    assert convert.git_config_from_hf(cfg) == jconvert.git_config_from_hf(cfg)
    as_dict = cfg.to_dict()
    as_dict["num_image_with_embedding"] = None   # a single-image GIT
    got = convert.git_config_from_hf(as_dict)
    assert got == jconvert.git_config_from_hf(as_dict)
    assert got["num_image_with_embedding"] == 1


def test_load_teacher_param_yaml_equals_jax(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "parameter.yaml"
    path.write_text("image_encoder_type: CLIPViT_L_14\ntest_crop_size: 224\n"
                    "visual_feature_size: 1024\nnum_image_with_embedding: 6\n"
                    "tokenizer: {name: bert-base-uncased}\n")
    got = git_teacher.load_teacher_param_yaml(str(path))
    assert got == jgit.load_teacher_param_yaml(str(path))
    assert got["num_image_with_embedding"] == 6

