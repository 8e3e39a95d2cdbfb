"""The port's batched caption server and checkpoint I/O
(rtvc_tpu_torch.serving, rtvc_tpu_torch.data.io) against the JAX
package's.

The contracts of tests/test_serving.py hold on the port's server: buckets,
truncation at SEP, batched == solo, inert padding, per-stream supersession,
distinct streams, concurrent threads, shape validation, a closed server,
errors reaching the future, a pending future resolved by ``close()``, and
the decompression-bomb check. Then the port's server, its weights written
by the port's ``save_checkpoint`` and read back by
``load_kd_student_params``, captions the same windows as JAX's
``BatchCaptionServer`` with the same weights, greedy and ``beam=2``: the
same token rows and texts, in process and through both HTTP fronts. The
tiny student of tests/test_models.py is built for 224-pixel frames (the
preprocess output) in float32, its vocab projection scaled up, and the
JAX replay first asserts that every choice wins by more than 1e-3
(tests/test_torch_beam.py). Every ``result()`` has a timeout and every
HTTP server binds port 0.
"""

import base64
import dataclasses
import json
import os
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from rtvc_tpu import serving as jserving
from rtvc_tpu.data import io as jio
from rtvc_tpu.serving_http import CaptionHTTPFrontend as JaxFrontend
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
from rtvc_tpu_torch import config as pconfig
from rtvc_tpu_torch import serving
from rtvc_tpu_torch.data import io
from rtvc_tpu_torch.models.convert import student_state_dict_from_jax
from rtvc_tpu_torch.models.student import student_matching_checkpoint
from rtvc_tpu_torch.serving import (BatchCaptionServer, default_buckets,
                                    truncate_at_sep)
from rtvc_tpu_torch.serving_http import CaptionHTTPFrontend
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

from test_torch_beam import (assert_jax_beam_margins,
                             assert_jax_greedy_margins, jax_preprocessed,
                             scaled)
from test_torch_models import FRAMES, jax_student, port_student

WINDOW = FRAMES  # the tiny student's upsample head is built for it
FRAME = (64, 64, 3)
CROP = 224
MAX_LEN = 8
TIMEOUT = 120


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX model, its variables, the port's student read back from a
    checkpoint the port wrote)."""
    jmodel, variables = jax_student(size=CROP)
    variables = scaled(variables)
    ckpt = str(tmp_path_factory.mktemp("run") / "ckpt_00")
    io.save_checkpoint(ckpt, {"state_dict": port_student(
        variables, input_size=CROP).state_dict()})
    port = port_student(variables, input_size=CROP)
    # the heads stay at their init: load_kd_student_params drops them
    missing, unexpected = port.load_state_dict(
        io.load_kd_student_params(ckpt)["state_dict"], strict=False)
    assert unexpected == [] and missing and all(
        k.split(".")[0] in io.DISTILL_HEADS for k in missing)
    return jmodel, variables, port


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(WINDOW,) + FRAME).astype(np.uint8)
            for _ in range(n)]


def _server(student, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_ms", 30.0)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("frame_shape", FRAME)
    kw.setdefault("window", WINDOW)
    return BatchCaptionServer(student, BertWordPieceTokenizer(), **kw)


# ---------------------------------------------------------------- contracts

def test_default_buckets():
    assert default_buckets(1) == (1,)
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(6) == (1, 2, 4, 6)


def test_truncate_at_sep():
    row = np.array([101, 7, 9, 102, 4, 0])
    np.testing.assert_array_equal(truncate_at_sep(row), [101, 7, 9])
    row = np.array([101, 7, 9])
    np.testing.assert_array_equal(truncate_at_sep(row), row)


def test_largest_bucket_must_cover_max_batch(served):
    with pytest.raises(ValueError, match="largest bucket"):
        _server(served[2], max_batch=4, buckets=(1, 2), warmup=False)


@pytest.mark.parametrize("beam", [0, 2])
def test_batched_equals_single_request(served, beam):
    """Any window captioned through a shared batch gets the same text and
    row as a dedicated batch-1 submission."""
    port = served[2]
    wins = _windows(5)
    with _server(port, max_wait_ms=0.0, beam=beam) as solo:
        futs = [solo.submit(w) for w in wins]
        singles = [(f.result(timeout=TIMEOUT), f.tokens(timeout=TIMEOUT))
                   for f in futs]
    with _server(port, max_wait_ms=50.0, max_batch=4, beam=beam) as batched:
        futs = [batched.submit(w) for w in wins]  # 5 -> batch 4 + batch 1
        texts = [f.result(timeout=TIMEOUT) for f in futs]
        rows = [f.tokens(timeout=TIMEOUT) for f in futs]
        sizes = list(batched.batch_sizes)
    assert texts == [t for t, _ in singles]
    for got, (_, want) in zip(rows, singles):
        np.testing.assert_array_equal(got, want)
    assert sum(sizes) == 5
    assert max(sizes) > 1  # the linger actually coalesced


@pytest.mark.parametrize("vocab_int8", [False, True])
def test_dp_mesh_serving_matches_single_device(served, vocab_int8):
    """tests/test_serving.py's case on the port: ``mesh=`` makes one
    replica per dp device (int8-packed each under ``vocab_int8``), rounds
    max_batch and the buckets up to dp multiples and splits each batch
    over the replicas; the captions equal the single-device server's."""
    from rtvc_tpu_torch.parallel import make_mesh

    port = served[2]
    mesh = make_mesh((4, 1), devices=["cpu"] * 4)
    wins = _windows(5, seed=3)
    with _server(port, max_wait_ms=0.0, vocab_int8=vocab_int8) as solo:
        singles = [solo.submit(w).result(timeout=TIMEOUT) for w in wins]
    with _server(port, max_wait_ms=50.0, max_batch=6, mesh=mesh,
                 vocab_int8=vocab_int8) as dp_srv:
        assert dp_srv.max_batch == 8          # 6 rounded up to dp multiple
        assert dp_srv.buckets == (4, 8)       # every bucket divisible by 4
        assert len(dp_srv.replicas) == 4 and dp_srv.replicas[0] is port
        assert len({id(r) for r in dp_srv.replicas}) == 4
        if vocab_int8:
            assert all(hasattr(r, "vocab_w8") for r in dp_srv.replicas)
        futs = [dp_srv.submit(w) for w in wins]
        texts = [f.result(timeout=TIMEOUT) for f in futs]
        sizes = list(dp_srv.batch_sizes)
    assert texts == singles
    assert max(sizes) > 1  # coalesced across the replicas


def test_beam_serving_matches_direct_beam(served):
    """beam=K serves the beam step: a served caption equals the direct
    beam step's row ([B, max_len], not greedy's [B, 1 + max_len])
    truncated at SEP."""
    port = served[2]
    wins = _windows(3, seed=7)
    step = serving.make_caption_step(port, max_len=MAX_LEN, beam=2)
    direct = step(torch.from_numpy(np.stack(wins))).numpy()
    tok = BertWordPieceTokenizer()
    expected = [tok.decode(truncate_at_sep(r), skip_special_tokens=True)
                for r in direct]
    with _server(port, max_wait_ms=50.0, max_batch=4, beam=2) as srv:
        futs = [srv.submit(w) for w in wins]
        texts = [f.result(timeout=TIMEOUT) for f in futs]
        rows = [f.tokens(timeout=TIMEOUT) for f in futs]
        sizes = list(srv.batch_sizes)
    assert texts == expected
    for got, want in zip(rows, direct):
        np.testing.assert_array_equal(got, truncate_at_sep(want))
    assert max(sizes) > 1  # exactness held through a shared batch
    greedy = serving.make_caption_step(port, max_len=MAX_LEN)(
        torch.from_numpy(np.stack(wins))).numpy()
    assert direct.shape == (3, MAX_LEN) and greedy.shape == (3, 1 + MAX_LEN)


def test_bucket_padding_is_inert(served):
    """3 requests pad to bucket 4; pad rows must not perturb real rows."""
    port = served[2]
    wins = _windows(3, seed=1)
    with _server(port, max_wait_ms=0.0) as solo:
        singles = [solo.submit(w).result(timeout=TIMEOUT) for w in wins]
    with _server(port, max_wait_ms=500.0, max_batch=4) as srv:
        futs = [srv.submit(w) for w in wins]
        texts = [f.result(timeout=TIMEOUT) for f in futs]
        assert list(srv.batch_sizes) == [3]
    assert texts == singles


def test_latest_window_supersedes(served):
    """A newer window from the same stream replaces a queued older one."""
    w1, w2 = _windows(2, seed=2)
    srv = _server(served[2], max_wait_ms=1500.0, max_batch=2)
    try:
        # the 1.5 s linger holds the scheduler open so both submits land
        # before any batch forms; the second replaces the first in-queue
        f1 = srv.submit(w1, stream_id="cam0")
        f2 = srv.submit(w2, stream_id="cam0")
        assert f1.result(timeout=TIMEOUT) is None
        assert f1.superseded and f1.tokens(timeout=TIMEOUT) is None
        assert f2.result(timeout=TIMEOUT) is not None
        assert not f2.superseded
        assert srv.stats()["superseded"] == 1.0
    finally:
        srv.close()


def test_distinct_streams_both_served(served):
    w1, w2 = _windows(2, seed=3)
    with _server(served[2]) as srv:
        f1 = srv.submit(w1, stream_id="a")
        f2 = srv.submit(w2, stream_id="b")
        assert f1.result(timeout=TIMEOUT) is not None
        assert f2.result(timeout=TIMEOUT) is not None
        stats = srv.stats()
        assert stats["served"] == 2.0
        assert stats["latency_p50_ms"] > 0 and stats["latency_p95_ms"] > 0


def test_concurrent_stream_threads(served):
    """N threads x M windows each all complete and text matches solo."""
    port = served[2]
    wins = _windows(4, seed=4)
    with _server(port, max_wait_ms=0.0) as solo:
        singles = {i: solo.submit(w).result(timeout=TIMEOUT)
                   for i, w in enumerate(wins)}

    results = {}
    lock = threading.Lock()
    with _server(port, max_wait_ms=5.0) as srv:
        def worker(sid):
            for j in range(3):
                w_idx = (sid + j) % len(wins)
                fut = srv.submit(wins[w_idx], stream_id=f"s{sid}")
                text = fut.result(timeout=TIMEOUT)
                with lock:
                    results[(sid, j)] = (w_idx, text)

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats()

    # a worker waits on each submit before the next, so nothing here can
    # legally supersede
    assert stats["superseded"] == 0.0
    assert stats["served"] == 12.0
    for (sid, j), (w_idx, text) in results.items():
        assert text == singles[w_idx], (sid, j)


def test_submit_shape_validation(served):
    with _server(served[2]) as srv:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((WINDOW, 16, 16, 3), np.uint8))


def test_closed_server_rejects(served):
    srv = _server(served[2])
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(_windows(1)[0])


def test_error_propagates_to_future(served):
    """A failing step resolves futures with the error instead of hanging."""
    srv = _server(served[2], warmup=False)
    try:
        srv._step = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("boom"))
        fut = srv.submit(_windows(1, seed=5)[0])
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=TIMEOUT)
    finally:
        srv.close()


def test_close_resolves_pending_futures(served):
    """close() errors out a request still queued behind a stuck batch, and
    returns after its join timeout instead of hanging."""
    srv = _server(served[2], warmup=False, max_batch=1, max_wait_ms=0.0)
    entered, release = threading.Event(), threading.Event()
    step = srv._step

    def stuck(frames):
        entered.set()
        release.wait(TIMEOUT)
        return step(frames)

    srv._step = stuck
    w1, w2 = _windows(2, seed=6)
    f1 = srv.submit(w1)
    assert entered.wait(TIMEOUT)
    f2 = srv.submit(w2)
    t0 = time.perf_counter()
    srv.close(timeout=0.2)
    assert time.perf_counter() - t0 < 5
    with pytest.raises(RuntimeError, match="server closed"):
        f2.result(timeout=TIMEOUT)
    release.set()
    assert isinstance(f1.result(timeout=TIMEOUT), str)
    srv._thread.join(TIMEOUT)
    assert not srv._thread.is_alive()


def test_decode_compressed_rejects_bomb_before_full_decode():
    """A constant-colour PNG compresses >1000:1; with the server's expected
    shape, decode must stop at the first wrong-shaped frame, and a wrong
    blob count before any decode. The port's codec gives the JAX codec's
    bytes and frames."""
    import cv2

    from rtvc_tpu_torch.serving import (compress_window,
                                        decode_compressed_frames)

    big = np.zeros((2048, 2048, 3), np.uint8)
    ok, buf = cv2.imencode(".png", big)
    assert ok and len(buf) < 50_000
    bomb = [buf.tobytes()] * 3
    with pytest.raises(ValueError, match="decodes to"):
        decode_compressed_frames(bomb, expect_shape=(3, 64, 64, 3))
    with pytest.raises(ValueError, match="server window"):
        decode_compressed_frames(bomb[:2], expect_shape=(3, 2048, 2048, 3))
    with pytest.raises(ValueError, match="zero-length"):
        decode_compressed_frames([b""], expect_shape=(1, 64, 64, 3))
    win = np.arange(3 * 64 * 64 * 3, dtype=np.uint8).reshape(3, 64, 64, 3)
    for fmt in (".png", ".jpg"):
        blobs = compress_window(win, fmt=fmt)
        assert blobs == jserving.compress_window(win, fmt=fmt)
        out = decode_compressed_frames(blobs, expect_shape=(3, 64, 64, 3))
        np.testing.assert_array_equal(
            out, jserving.decode_compressed_frames(blobs))
        if fmt == ".png":
            np.testing.assert_array_equal(out, win)


# ------------------------------------------------------------ against JAX

def _post(port, win):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/caption", data=json.dumps({
            "frames_b64": base64.b64encode(win.tobytes()).decode(),
            "shape": list(win.shape)}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())["caption"]


@pytest.mark.parametrize("beam", [0, 2])
def test_server_rows_and_texts_equal_jax(served, beam):
    """The port's server (weights from the port's checkpoint) and JAX's,
    same weights, same windows in one padded batch: the same rows, the
    same texts, in process and over HTTP."""
    jmodel, variables, port = served
    wins = _windows(3, seed=8)
    proc = jax_preprocessed(np.stack(wins), CROP)
    if beam:
        replay = assert_jax_beam_margins(jmodel, variables, proc, beam,
                                         MAX_LEN)
    else:
        replay = assert_jax_greedy_margins(jmodel, variables, proc, MAX_LEN)
    kw = dict(max_batch=4, buckets=(4,), max_wait_ms=300.0, max_len=MAX_LEN,
              beam=beam, frame_shape=FRAME, window=WINDOW)
    # the JAX server's scheduler thread reads the global setting, not a
    # context manager's
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        with jserving.BatchCaptionServer(jmodel, variables, JaxTokenizer(),
                                         **kw) as jsrv:
            jfuts = [jsrv.submit(w) for w in wins]
            want = [(f.result(timeout=TIMEOUT), f.tokens(timeout=TIMEOUT))
                    for f in jfuts]
            assert list(jsrv.batch_sizes) == [3]
            with JaxFrontend(jsrv, port=0) as fe:
                jhttp = [_post(fe.port, w) for w in wins]
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    with BatchCaptionServer(port, BertWordPieceTokenizer(), **kw) as srv:
        futs = [srv.submit(w) for w in wins]
        got = [(f.result(timeout=TIMEOUT), f.tokens(timeout=TIMEOUT))
               for f in futs]
        assert list(srv.batch_sizes) == [3]
        with CaptionHTTPFrontend(srv, port=0) as fe:
            http = [_post(fe.port, w) for w in wins]
    for (text, row), (jtext, jrow), rrow in zip(got, want, replay):
        np.testing.assert_array_equal(jrow, truncate_at_sep(rrow))
        np.testing.assert_array_equal(row, jrow)
        assert text == jtext
    assert http == jhttp == [(200, t) for t, _ in want]
    assert all(t for t, _ in want)  # every caption has text


# ------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip(served, tmp_path):
    port = served[2]
    sd = port.state_dict()
    path = str(tmp_path / "ckpt_00")
    io.save_checkpoint(path, {"state_dict": sd, "step": 7})
    tree = io.restore_checkpoint(path)
    assert tree["step"] == 7 and set(tree["state_dict"]) == set(sd)
    for k, v in sd.items():
        assert torch.equal(tree["state_dict"][k], v), k
    with pytest.raises(FileExistsError):
        io.save_checkpoint(path, {"state_dict": sd}, force=False)
    io.save_checkpoint(path, {"step": 8})  # force replaces
    assert io.restore_checkpoint(path) == {"step": 8}


def test_meta_sidecar(tmp_path):
    a, b = str(tmp_path / "ckpt_a"), str(tmp_path / "ckpt_b")
    io.save_checkpoint(a, {"step": 1}, meta={"gelu_approximate": False})
    io.save_checkpoint(b, {"step": 1})
    assert io.checkpoint_meta(a) == {"gelu_approximate": False}
    assert os.path.isfile(a + ".meta.json")
    assert io.checkpoint_meta(b) == {}
    # the JAX package reads the same sidecar
    assert jio.checkpoint_meta(a) == io.checkpoint_meta(a)


def test_stripped_heads_map_onto_jax_distill_heads(served):
    """Stripping the port's state dict leaves exactly the keys of the JAX
    params that JAX's strip_distillation_heads leaves, through the bridge;
    and the dropped keys are those of JAX's _DISTILL_HEADS."""
    _, variables, _ = served
    params, stats = variables["params"], variables["batch_stats"]
    full = student_state_dict_from_jax(params, stats)
    kept = student_state_dict_from_jax(
        jio.strip_distillation_heads(dict(params)), stats)
    assert set(io.strip_distillation_heads(full)) == set(kept)
    heads = student_state_dict_from_jax(
        {k: v for k, v in params.items() if k in jio._DISTILL_HEADS}, {})
    assert set(full) - set(kept) == set(heads)
    assert {k.split(".")[0] for k in heads} == set(io.DISTILL_HEADS)


def test_load_kd_student_params_strips_heads(served, tmp_path):
    port = served[2]
    path = str(tmp_path / "ckpt_00")
    io.save_checkpoint(path, {"state_dict": port.state_dict(), "step": 3})
    out = io.load_kd_student_params(path)
    assert out["step"] == 3
    assert set(out["state_dict"]) == set(
        io.strip_distillation_heads(port.state_dict()))
    assert not any(k.startswith(("projectors.", "upsample.", "project."))
                   for k in out["state_dict"])
    # a bare state dict loads too
    io.save_checkpoint(path, port.state_dict())
    assert set(io.load_kd_student_params(path)) == {"state_dict"}


def test_latest_checkpoint_ignores_sidecars(tmp_path):
    run = tmp_path / "run"
    assert io.latest_checkpoint(str(run)) is None
    run.mkdir()
    assert io.latest_checkpoint(str(run)) is None
    io.save_checkpoint(str(run / "ckpt_00"), {"step": 0})
    io.save_checkpoint(str(run / "ckpt_01"), {"step": 1},
                       meta={"gelu_approximate": True})
    os.utime(run / "ckpt_00", (1, 1))
    (run / "ckpt_99.meta.json").write_text("{}")   # newest, but a file
    (run / "other").mkdir()
    assert io.latest_checkpoint(str(run)) == str(run / "ckpt_01")
    assert jio.latest_checkpoint(str(run)) == str(run / "ckpt_01")


@pytest.mark.parametrize("recorded", [None, False, True])
def test_student_matching_checkpoint_honours_the_sidecar(tmp_path, recorded):
    path = str(tmp_path / "ckpt_00")
    io.save_checkpoint(path, {"step": 0},
                       meta=None if recorded is None else
                       {"gelu_approximate": recorded})
    for default in (True, False):
        cfg = dataclasses.replace(pconfig.cfg, student=dataclasses.replace(
            pconfig.cfg.student, gelu_approximate=default))
        student = student_matching_checkpoint(cfg, path, device="cpu")
        want = default if recorded is None else recorded
        assert student.image_encoder["model"].config.gelu_approximate == want


def test_build_serving_student(tmp_path):
    """Random weights from config.seed, or a checkpoint's weights and GELU
    variant with the heads of the seeded init; config.dtype, eval mode."""
    cfg = dataclasses.replace(
        pconfig.cfg, compute_dtype="float32",
        student=dataclasses.replace(pconfig.cfg.student, d_model=32,
                                    n_head=4, d_ffn=64, vocab_size=211,
                                    num_decoder_layers=1))
    a = serving.build_serving_student(device="cpu", config=cfg)
    b = serving.build_serving_student(device="cpu", config=cfg)
    assert not a.training and a.linear.weight.dtype == torch.float32
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    trained = serving.build_serving_student(device="cpu", config=dataclasses
                                            .replace(cfg, seed=cfg.seed + 1))
    path = str(tmp_path / "ckpt_00")
    io.save_checkpoint(path, {"state_dict": trained.state_dict()},
                       meta={"gelu_approximate": False})
    c = serving.build_serving_student(path, device="cpu", config=cfg)
    assert c.image_encoder["model"].config.gelu_approximate is False
    for k, v in c.state_dict().items():
        src = a if k.split(".")[0] in io.DISTILL_HEADS else trained
        assert torch.equal(v, src.state_dict()[k]), k
    half = serving.build_serving_student(device="cpu", config=dataclasses
                                         .replace(cfg, compute_dtype="bfloat16"))
    assert half.linear.weight.dtype == torch.bfloat16
    for drop, add in (("linear.weight", None), (None, "bogus.weight")):
        sd = dict(trained.state_dict())
        if drop:
            del sd[drop]
        if add:
            sd[add] = torch.zeros(1)
        io.save_checkpoint(path, {"state_dict": sd})
        with pytest.raises(ValueError, match="does not fit"):
            serving.build_serving_student(path, device="cpu", config=cfg)



# ------------------------------------------------------------ entry points

def test_server_from_frontend_args(served, monkeypatch):
    """The front's CLI flags reach the server; the student comes from
    build_serving_student with --ckpt and --device."""
    import argparse

    seen = {}

    def fake_build(ckpt=None, device="cuda", config=None):
        seen.update(ckpt=ckpt, device=device)
        return served[2]

    monkeypatch.setattr(serving, "build_serving_student", fake_build)
    p = argparse.ArgumentParser()
    serving.add_frontend_cli_args(p)
    a = p.parse_args(["--max-batch", "2", "--max-wait-ms", "1", "--beam",
                      "2", "--frame-size", "64", "--device", "cpu"])
    srv = serving.server_from_frontend_args(a)
    try:
        assert seen == {"ckpt": None, "device": "cpu"}
        assert (srv.max_batch, srv.beam, srv.frame_shape, srv.window) == (
            2, 2, (64, 64, 3), 6)
        win = np.zeros((6, 64, 64, 3), np.uint8)
        assert isinstance(srv.submit(win).result(timeout=TIMEOUT), str)
    finally:
        srv.close()


def test_simulate_streams_replays_a_clip(served, monkeypatch, tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (80, 60))
    if not w.isOpened():
        pytest.skip("no mp4 codec")
    rng = np.random.default_rng(1)
    for _ in range(24):
        w.write(rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8))
    w.release()
    monkeypatch.setattr(serving, "build_serving_student",
                        lambda **kw: served[2])
    stats = serving.simulate_streams(path, n_streams=3, windows_per_stream=2,
                                     max_batch=2, max_wait_ms=5.0,
                                     device="cpu")
    assert stats["served"] + stats["superseded"] == 6.0
    assert stats["streams"] == 3.0 and stats["windows_per_s_wall"] > 0
