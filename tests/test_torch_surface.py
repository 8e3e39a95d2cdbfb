"""The port's small public surface against the JAX package's: the masks
(rtvc_tpu_torch.ops.masking), ``preprocess_clip_batch``, the
reference-style config access (``Config.__getitem__``, ``_DictView``,
``from_dict``), ``tiny_vit_5m_config`` with a TinyViT-5M forward through
the weight bridge, ``profile_trace``, and the deployment modules importing
without jax or grpc.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu import config as jconfig
from rtvc_tpu.models import tinyvit as jtinyvit
from rtvc_tpu.models.convert import tinyvit_params_from_torch
from rtvc_tpu.ops import masking as jmasking
from rtvc_tpu.ops import preprocess as jpreprocess
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch.models.student import random_init_
from rtvc_tpu_torch.models.tinyvit import TinyViT
from rtvc_tpu_torch.ops import masking
from rtvc_tpu_torch.ops.preprocess import preprocess_clip_batch
from rtvc_tpu_torch.utils.profiling import profile_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_padding_mask_equals_jax():
    seq = np.array([[101, 5, 0, 9, 0], [0, 0, 3, 102, 7]], np.int32)
    for pad in (0, 102):
        np.testing.assert_array_equal(
            masking.create_padding_mask(torch.from_numpy(seq), pad).numpy(),
            np.asarray(jmasking.create_padding_mask(jnp.asarray(seq), pad)))


@pytest.mark.parametrize("size", [1, 5, 16])
def test_causal_mask_equals_jax(size):
    got = masking.create_causal_mask(size)
    assert got.dtype == torch.bool and got.shape == (size, size)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmasking.create_causal_mask(size)))
    assert masking.create_casual_mask is masking.create_causal_mask


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (60, 40, 3),
                                   (1, 224, 224, 3)])
@pytest.mark.parametrize("bgr_to_rgb", [True, False])
def test_preprocess_clip_batch_equals_jax(shape, bgr_to_rgb):
    """numpy uint8, 4-D or one 3-D frame, through both wrappers: within
    1e-5, absolute and relative (the two antialiased bicubic resizes sum
    their taps in another order; outputs reach ~2.2 after the CLIP
    normalisation, where float32 keeps ~2.4e-7)."""
    frames = np.random.default_rng(3).integers(
        0, 256, size=shape).astype(np.uint8)
    got = preprocess_clip_batch(frames, bgr_to_rgb=bgr_to_rgb, device="cpu")
    want = np.asarray(jpreprocess.preprocess_clip_batch(
        frames, bgr_to_rgb=bgr_to_rgb))
    assert got.shape == want.shape == (
        (1,) if len(shape) == 3 else shape[:1]) + (224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _shared(jview, pview):
    """The keys both views hold, equal value for value (nested views
    compared the same way)."""
    shared = set(jview) & set(pview)
    assert shared
    for key in shared:
        j, p = jview[key], pview[key]
        if isinstance(j, dict):
            assert isinstance(p, pconfig._DictView), key
            _shared(j, p)
        else:
            assert j == p, key
    return shared


OVERRIDES = [
    {"TRAIN": {"BATCH_SIZE": 16, "LR": 3e-4}},
    {"SEED": 7, "DATA": {"NUM_FRAMES": 4, "videos_path": "v"},
     "TRAIN": {"TRAINER": {"MAX_EPOCHS": 3, "precision": "32"},
               "eval_beam_size": 3},
     "student": {"d_model": 64, "dropout": 0.1},
     "teacher": {"beam_size": 2},
     "TPU": {"compute_dtype": "float32", "remat_encoder": True,
             "mesh_shape": (2, 2), "mesh_axes": ("dp", "tp"),
             "multihost": True},
     "wandb": {"mode": "disabled"}},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_from_dict_and_views_equal_jax(overrides):
    jc = jconfig.from_dict(overrides)
    pc = pconfig.from_dict(overrides)
    for section in ("DATA", "LOGGER", "TRAIN", "WANDB", "CALLBACK", "TPU"):
        view = pc[section]
        assert isinstance(view, pconfig._DictView)
        _shared(jc[section], view)
    assert pc["SEED"] == jc["SEED"]
    for model in ("StudentCandidateV1", "GenerativeImageTextTeacher"):
        assert _shared(jc["MODEL"][model], pc["MODEL"][model]) == set(
            jc["MODEL"][model])
    assert pc["TRAIN"]["BATCH_SIZE"] == pc.train.batch_size
    assert pc["TRAIN"]["TRAINER"]["max_epochs"] == \
        jc["TRAIN"]["TRAINER"]["max_epochs"]
    assert pc["DATA"]["VIDEOS_PATH"] == jc["DATA"]["VIDEOS_PATH"]
    with pytest.raises(KeyError):
        pc["NOT_A_SECTION"]


def test_from_dict_rejects_unknown_keys_as_jax():
    for bad in ({"NOT_A_KEY": 1}, {"TRAIN": {"NOT_A_FIELD": 1}}):
        with pytest.raises(KeyError):
            jconfig.from_dict(bad)
        with pytest.raises(KeyError):
            pconfig.from_dict(bad)
    # a TpuConfig field the port does not keep
    with pytest.raises(KeyError, match="TpuConfig"):
        pconfig.from_dict({"TPU": {"steps_per_dispatch": 4}})
    base = pconfig.from_dict({"SEED": 3})
    assert pconfig.from_dict({"TRAIN": {"LR": 1.0}}, base=base).seed == 3


def test_tiny_vit_5m_config_equals_jax():
    jc, pc = jtinyvit.tiny_vit_5m_config(), pconfig.tiny_vit_5m_config()
    assert {f.name for f in dataclasses.fields(jc)} == \
        {f.name for f in dataclasses.fields(pc)}
    for f in dataclasses.fields(jc):
        j, p = getattr(jc, f.name), getattr(pc, f.name)
        if f.name == "dtype":
            assert jnp.dtype(j).name == str(p).removeprefix("torch.")
        else:
            assert j == p, f.name
    assert pconfig.tiny_vit_5m_config(drop_path_rate=0.1).drop_path_rate \
        == jtinyvit.tiny_vit_5m_config(drop_path_rate=0.1).drop_path_rate


def test_tiny_vit_5m_forward_equals_jax():
    """A port TinyViT-5M (random weights from a seeded generator, BatchNorm
    statistics drawn too) against JAX's TinyViT on the same weights through
    ``tinyvit_params_from_torch``, at 64 pixels: every stage map within
    1e-4."""
    size = 64
    port = TinyViT(pconfig.tiny_vit_5m_config(), input_size=size)
    g = torch.Generator().manual_seed(6)
    random_init_(port, g)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    params, stats, unused = tinyvit_params_from_torch(
        {k: v.numpy() for k, v in port.state_dict().items()},
        depths=pconfig.tiny_vit_5m_config().depths)
    assert unused == []
    x = np.random.default_rng(1).normal(
        size=(2, size, size, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jtinyvit.TinyViT(jtinyvit.tiny_vit_5m_config()).apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for s, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4, err_msg=f"stage {s}")


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    text = (logdir / files[0]).read_text()
    assert "traceEvents" in text and "aten::mm" in text
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_deployment_modules_import_without_jax_or_grpc():
    """``export`` and ``serving_grpc`` import with jax, the JAX package and
    grpc blocked; a gRPC front then raises a clear ImportError."""
    code = """
import sys
for name in ("jax", "rtvc_tpu", "grpc"):
    sys.modules[name] = None
from rtvc_tpu_torch import export, serving_grpc
from rtvc_tpu_torch.ops import masking
from rtvc_tpu_torch.utils.profiling import profile_trace
assert serving_grpc.grpc is None
try:
    serving_grpc.CaptionClient("127.0.0.1:1")
except ImportError as e:
    assert "grpcio" in str(e)
else:
    raise AssertionError("CaptionClient without grpc")
assert not [m for m, mod in sys.modules.items()
            if mod is not None and m.startswith(("jax", "rtvc_tpu."))]
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
