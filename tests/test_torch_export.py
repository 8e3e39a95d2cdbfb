"""The port's deployment artifacts (rtvc_tpu_torch.export) against the JAX
package's (rtvc_tpu/export.py), the cases of tests/test_export.py.

A bundle's exported programs reproduce the live caption step token for
token and equal JAX's bundle on the same weights and windows (greedy on
``lively`` weights, beam 2 on ``scaled`` ones, after a JAX replay asserts
every choice wins by more than 1e-3); bucket padding leaves the rows
alone; a bundle without params works; the loader raises on shapes,
buckets, a newer format and foreign variables; a program file loads in a
process where the model code cannot be imported; the device-side stop
(``host_stop=False``) gives the host stop's rows, also where every row
stops early; the graph keeps K1 and K2 as ``rtvc::`` operator nodes, one
per launch; the program files hold no weights; a compiled AOTInductor
package round-trips with the same rows and launches. Everything runs on
the CPU, where the operators run their plain versions.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rtvc_tpu import export as jexport
from rtvc_tpu_torch import decode, export, serving
from rtvc_tpu_torch.models.student import StudentCandidateV1, random_init_
from rtvc_tpu_torch.ops import attention, layernorm
from rtvc_tpu_torch.serving import make_caption_step

from test_torch_beam import (assert_jax_beam_margins,
                             assert_jax_greedy_margins, jax_preprocessed,
                             scaled)
from test_torch_evaluate import lively
from test_torch_models import (FRAMES, jax_student, port_encoder_config,
                               port_student)

WINDOW = FRAMES  # the tiny student's upsample head is built for it
FRAME = (64, 64, 3)
CROP = 224
MAX_LEN = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny(seed: int = 0, vocab_size: int = 211) -> StudentCandidateV1:
    """test_models.tiny_student's sizes for 224-pixel frames, seeded random
    weights, eval mode."""
    model = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, num_decoder_layers=2,
        vocab_size=vocab_size, max_pos_len=64,
        encoder_config=port_encoder_config(True), input_size=CROP,
        num_frames=WINDOW, teacher_visual_dim=32, teacher_num_tokens=10,
        teacher_hidden=16)
    return random_init_(model, torch.Generator().manual_seed(seed)).eval()


@pytest.fixture(scope="module")
def student():
    model = tiny()
    return model, export.serving_variables(model)


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(n, WINDOW) + FRAME).astype(np.uint8)


def _direct(model, windows, beam=0):
    step = make_caption_step(model, max_len=MAX_LEN, beam=beam)
    return step(torch.from_numpy(windows)).numpy()


def _bundle(out, model, variables, **kw):
    kw.setdefault("window", WINDOW)
    kw.setdefault("frame_shape", FRAME)
    kw.setdefault("max_len", MAX_LEN)
    return export.save_bundle(str(out), model, variables, device="cpu", **kw)


@pytest.mark.parametrize("beam", [0, 2])
def test_bundle_rows_equal_jax(beam, tmp_path):
    """The port's bundle and JAX's, same weights (through the bridge), same
    windows, in a padded bucket: the same rows, equal to the live step's
    and to a JAX replay whose every choice wins by more than 1e-3."""
    jmodel, variables = jax_student(size=CROP)
    variables = scaled(variables) if beam else lively(variables)
    port = port_student(variables, input_size=CROP)
    wins = _windows(3, seed=8)
    proc = jax_preprocessed(wins, CROP)
    if beam:
        replay = assert_jax_beam_margins(jmodel, variables, proc, beam,
                                         MAX_LEN)
    else:
        replay = assert_jax_greedy_margins(jmodel, variables, proc, MAX_LEN)
    with jax.default_matmul_precision("highest"):
        jexport.save_bundle(str(tmp_path / "jax"), jmodel, variables,
                            buckets=(4,), window=WINDOW, frame_shape=FRAME,
                            max_len=MAX_LEN, beam=beam)
        want = jexport.load_bundle(str(tmp_path / "jax")).caption_tokens(wins)
    _bundle(tmp_path / "port", port, export.serving_variables(port),
            buckets=(4,), beam=beam)
    got = export.load_bundle(str(tmp_path / "port")).caption_tokens(wins)
    np.testing.assert_array_equal(want, replay)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _direct(port, wins, beam))


def test_bundle_roundtrip_matches_live_program(student, tmp_path):
    model, variables = student
    manifest = _bundle(tmp_path / "b", model, variables, buckets=(1, 2, 4))
    assert manifest["buckets"] == [1, 2, 4]
    assert set(manifest["programs"]) == {"1", "2", "4"}
    assert manifest["device"] == "cpu"
    assert manifest["variables"] == list(variables)
    assert os.path.exists(tmp_path / "b" / export.MANIFEST)
    cap = export.load_bundle(str(tmp_path / "b"))
    for n in (1, 2, 4):
        w = _windows(n, seed=n)
        np.testing.assert_array_equal(cap.caption_tokens(w),
                                      _direct(model, w))


def test_bucket_padding_is_output_invariant(student, tmp_path):
    """A 3-row request runs in the 4-bucket; its rows equal direct B=3."""
    model, variables = student
    _bundle(tmp_path / "b", model, variables, buckets=(4,))
    cap = export.load_bundle(str(tmp_path / "b"))
    w = _windows(3, seed=7)
    assert cap.bucket_for(3) == 4
    got = cap.caption_tokens(w)
    assert got.shape[0] == 3
    np.testing.assert_array_equal(got, _direct(model, w))


def test_bundle_without_params(student, tmp_path):
    model, variables = student
    _bundle(tmp_path / "b", model, variables, buckets=(2,),
            save_params=False)
    assert not os.path.exists(tmp_path / "b" / export.PARAMS_DIR)
    with pytest.raises(ValueError, match="no params"):
        export.load_bundle(str(tmp_path / "b"))
    cap = export.load_bundle(str(tmp_path / "b"), variables=variables)
    w = _windows(2, seed=3)
    np.testing.assert_array_equal(cap.caption_tokens(w), _direct(model, w))


def test_beam_bundle(student, tmp_path):
    model, variables = student
    _bundle(tmp_path / "b", model, variables, buckets=(2,), beam=2)
    cap = export.load_bundle(str(tmp_path / "b"))
    assert cap.beam == 2
    w = _windows(2, seed=11)
    np.testing.assert_array_equal(cap.caption_tokens(w),
                                  _direct(model, w, beam=2))


def test_loader_validates_shapes_buckets_and_variables(student, tmp_path):
    model, variables = student
    _bundle(tmp_path / "b", model, variables, buckets=(1, 2))
    cap = export.load_bundle(str(tmp_path / "b"))
    with pytest.raises(ValueError, match="exceeds largest"):
        cap.caption_tokens(_windows(3))
    with pytest.raises(ValueError, match="expected"):
        cap.caption_tokens(np.zeros((1, WINDOW, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="no exported bucket"):
        cap(torch.zeros((3, WINDOW) + FRAME, dtype=torch.uint8))
    # the program's variables in another order are put in its order ...
    shuffled = dict(reversed(list(variables.items())))
    w = _windows(2, seed=6)
    np.testing.assert_array_equal(
        export.load_bundle(str(tmp_path / "b"),
                           variables=shuffled).caption_tokens(w),
        _direct(model, w))
    # ... and variables that are not the program's are named, not misread
    partial = dict(variables)
    partial.pop("linear.bias")
    with pytest.raises(ValueError, match="missing.*linear.bias"):
        export.load_bundle(str(tmp_path / "b"), variables=partial)
    with pytest.raises(ValueError, match="unexpected.*stray"):
        export.load_bundle(str(tmp_path / "b"),
                           variables=dict(variables, stray=torch.zeros(1)))
    with pytest.raises(ValueError, match="missing"):
        export.export_caption_program(model, partial, batch=1,
                                      window=WINDOW, frame_shape=FRAME,
                                      max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="export device"):
        export.export_caption_program(model, variables, batch=1,
                                      window=WINDOW, frame_shape=FRAME,
                                      max_len=MAX_LEN, device="meta")
    # a future format version must be refused, not silently misread
    man_path = tmp_path / "b" / export.MANIFEST
    man = json.loads(man_path.read_text())
    man["format_version"] = export._FORMAT_VERSION + 1
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="newer"):
        export.load_bundle(str(tmp_path / "b"))


_STANDALONE = """
import sys
for name in ("rtvc_tpu_torch.models", "rtvc_tpu_torch.decode",
             "rtvc_tpu_torch.serving", "jax", "rtvc_tpu"):
    sys.modules[name] = None
import numpy as np
from rtvc_tpu_torch import export
rng = np.random.default_rng(5)
w = rng.integers(0, 255, size=(2, {window}) + {frame}).astype(np.uint8)
np.save(sys.argv[2], export.load_bundle(sys.argv[1]).caption_tokens(w))
blocked = [m for m in ("rtvc_tpu_torch.models.student",
                       "rtvc_tpu_torch.decode") if sys.modules.get(m)]
assert not blocked, blocked
"""


def test_program_loads_without_the_model_code(student, tmp_path):
    """A bundle loads and runs in a process where ``models``, ``decode``
    and ``serving`` (and jax) cannot be imported: the program file carries
    the computation, ``rtvc_tpu_torch.ops`` the operators."""
    model, variables = student
    _bundle(tmp_path / "b", model, variables, buckets=(2,))
    out = tmp_path / "rows.npy"
    code = _STANDALONE.format(window=WINDOW, frame=FRAME)
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "b"),
                    str(out)], cwd=REPO, check=True, timeout=300,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    rng = np.random.default_rng(5)
    w = rng.integers(0, 255, size=(2, WINDOW) + FRAME).astype(np.uint8)
    np.testing.assert_array_equal(np.load(out), _direct(model, w))


# the first-argmax ids each row emits at each step; SEP = 102. Row 0 stops
# at step 2, row 1 at steps 1 and 2: every row emits SEP at step 2, so the
# host stop breaks there and the later ids must not appear.
_SCRIPT = np.array([[5, 7, 102, 11, 13, 17],
                    [9, 102, 102, 19, 23, 29]])


@pytest.mark.parametrize("scripted", [False, True])
def test_device_stop_rows_equal_host_stop(student, monkeypatch, scripted):
    """``student_greedy(host_stop=False)`` gives the host stop's rows
    exactly: on random weights (no stop), and on a scripted decode where
    every row emits SEP at one step before ``max_len``."""
    model, _ = student
    frames = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, WINDOW, CROP, CROP, 3)).astype(np.float32))
    if scripted:
        real = model.decode_step

        def decode_step(token, index, caches, kv_mask=None, **kw):
            logits, caches = real(token, index, caches, kv_mask, **kw)
            forced = torch.full_like(logits, -1e4)
            forced[torch.arange(2), torch.from_numpy(_SCRIPT[:, index])] = 0
            return forced, caches

        monkeypatch.setattr(model, "decode_step", decode_step)
    host = decode.student_greedy(model, frames, max_len=6)
    device = decode.student_greedy(model, frames, max_len=6,
                                   host_stop=False)
    np.testing.assert_array_equal(device.numpy(), host.numpy())
    if scripted:
        np.testing.assert_array_equal(
            host.numpy(), [[101, 5, 7, 102, 0, 0, 0],
                           [101, 9, 102, 102, 0, 0, 0]])


def _ops(program) -> dict:
    found = {}
    for node in program.graph_module.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "rtvc."):
            found[str(node.target)] = found.get(str(node.target), 0) + 1
    return found


@pytest.mark.parametrize("beam", [0, 2])
def test_graph_holds_kernel_operators(student, beam):
    """The exported graph keeps K1 and K2 as ``rtvc::`` operator nodes:
    K1 once a TinyViT attention block, K2 twice a block and three times a
    decoder layer at each decode step (greedy: ``max_len``; beam:
    ``max_len - 1``)."""
    model, variables = student
    program = export.export_caption_program(
        model, variables, batch=2, window=WINDOW, frame_shape=FRAME,
        max_len=MAX_LEN, beam=beam, device="cpu")
    blocks = sum(model.image_encoder["model"].config.depths[1:])
    steps = MAX_LEN - 1 if beam else MAX_LEN
    assert _ops(program) == {
        "rtvc.window_attention.default": blocks,
        "rtvc.layer_norm.default": 2 * blocks + 3 * 2 * steps}


def test_program_files_hold_no_weights(tmp_path):
    """The weights are an argument: no program holds a parameter, and each
    file is under a tenth of the params' bytes (a student whose weights
    outweigh its graph: the full 30522-word vocabulary)."""
    model = tiny(vocab_size=30522)
    variables = export.serving_variables(model)
    manifest = _bundle(tmp_path / "b", model, variables, buckets=(1, 2),
                       max_len=2)
    params_bytes = sum(t.numel() * t.element_size()
                       for t in variables.values())
    for name in manifest["programs"].values():
        program = torch.export.load(str(tmp_path / "b" / name))
        assert len(program.state_dict) == 0
        assert program.example_inputs is None
        size = os.path.getsize(tmp_path / "b" / name)
        assert size < params_bytes / 10, (name, size, params_bytes)


def test_compiled_package_roundtrip(student, tmp_path, monkeypatch):
    """save_compiled / load_compiled on the CPU (bucket 1, max_len 2): the
    package's rows equal the live step's, and it launches K1 and K2 as
    often as the exported program (counted at their plain versions, which
    the operators run on the CPU)."""
    model, variables = student
    path = str(tmp_path / "b1.pt2")
    export.save_compiled(path, model, variables, batch=1, window=WINDOW,
                         frame_shape=FRAME, max_len=2, device="cpu")
    calls = {"k1": 0, "k2": 0}
    for mod, name, key in ((attention, "window_attention_plain", "k1"),
                           (layernorm, "layer_norm_plain", "k2")):
        def counting(*a, _real=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counting)
    fn, meta = export.load_compiled(path)
    assert {k: meta[k] for k in ("batch", "window", "max_len", "beam")} == {
        "batch": 1, "window": WINDOW, "max_len": 2, "beam": 0}
    assert meta["frame_shape"] == FRAME
    w = torch.from_numpy(_windows(1, seed=9))
    got = fn(variables, w)
    blocks = sum(model.image_encoder["model"].config.depths[1:])
    assert calls == {"k1": blocks, "k2": 2 * blocks + 3 * 2 * 2}
    monkeypatch.undo()
    np.testing.assert_array_equal(
        got.numpy(), make_caption_step(model, max_len=2)(w).numpy())


def test_cli_writes_a_bundle(student, tmp_path, monkeypatch):
    """``python -m rtvc_tpu_torch.export`` builds through
    ``build_serving_student`` (patched to the tiny student) and writes a
    loadable bundle for the buckets it is given."""
    model, _ = student
    monkeypatch.setattr(serving, "build_serving_student",
                        lambda ckpt=None, device="cuda": model)
    monkeypatch.setattr("rtvc_tpu_torch.real_time_inference.WINDOW",
                        WINDOW)
    monkeypatch.setattr(export, "save_bundle",
                        lambda *a, **kw: _bundle_cli(*a, **kw))
    export.main(["--out", str(tmp_path / "b"), "--buckets", "2,1",
                 "--max-len", "3", "--device", "cpu"])
    cap = export.load_bundle(str(tmp_path / "b"))
    assert cap.buckets == (1, 2) and cap.max_len == 3
    w = _windows(2, seed=4)
    np.testing.assert_array_equal(
        cap.caption_tokens(w), make_caption_step(model, max_len=3)(
            torch.from_numpy(w)).numpy())


_save_bundle = export.save_bundle


def _bundle_cli(out, student, variables, **kw):
    """The CLI's save_bundle at the tiny student's frame shape (the CLI
    itself takes 224-pixel frames)."""
    kw["frame_shape"] = FRAME
    return _save_bundle(out, student, variables, **kw)
