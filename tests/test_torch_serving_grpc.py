"""The port's gRPC front (rtvc_tpu_torch.serving_grpc), the cases of
tests/test_serving_grpc.py, and its answers against the JAX package's
front on the same weights.

Drives a real grpc.server over a loopback socket with the stub-free
CaptionClient, in front of the port's BatchCaptionServer on a tiny student
(tests/test_torch_serving_http.py's, seeded random weights, float32, on
the CPU): unary caption equality with the in-process API, the
bidirectional CaptionStream RPC (ordering, seq echo, per-RPC
supersession, per-window error replies), stats, and input validation
(INVALID_ARGUMENT / UNAVAILABLE status codes). Then JAX's server and front
and the port's, one set of weights through the bridge, answer the same
unary requests with the same captions, their servers with the same rows.
The two packages' generated messages are one set of classes.
"""

import threading

import jax
import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from rtvc_tpu import serving as jserving
from rtvc_tpu import serving_grpc as jserving_grpc
from rtvc_tpu.proto import caption_pb2 as jpb
from rtvc_tpu.tokenization import BertWordPieceTokenizer as JaxTokenizer
from rtvc_tpu_torch.proto import caption_pb2
from rtvc_tpu_torch.serving import BatchCaptionServer, truncate_at_sep
from rtvc_tpu_torch.serving_grpc import (CaptionClient, CaptionGRPCFrontend,
                                         encode_window)
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

from test_torch_beam import assert_jax_greedy_margins, jax_preprocessed
from test_torch_evaluate import lively
from test_torch_models import FRAMES, jax_student, port_student
from test_torch_serving_http import WINDOW, tiny_port_student

FRAME = (64, 64, 3)


def _make_server(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("max_len", 8)
    kw.setdefault("frame_shape", FRAME)
    kw.setdefault("window", WINDOW)
    return BatchCaptionServer(tiny_port_student(), BertWordPieceTokenizer(),
                              **kw)


@pytest.fixture(scope="module")
def stack():
    server = _make_server()
    with CaptionGRPCFrontend(server, port=0) as fe:
        with CaptionClient(f"127.0.0.1:{fe.port}") as client:
            yield fe, server, client
    server.close()


def _window(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(WINDOW,) + FRAME).astype(np.uint8)


def test_unary_caption_matches_inprocess(stack):
    fe, server, client = stack
    win = _window(0)
    expect = server.submit(win).result(timeout=120)
    reply = client.caption(win, timeout_s=120.0, seq=42)
    assert reply.caption == expect
    assert reply.seq == 42
    assert not reply.superseded
    assert reply.latency_ms > 0.0


def test_stats_rpc(stack):
    fe, server, client = stack
    client.caption(_window(1), timeout_s=120.0)
    stats = client.stats()
    assert stats["served"] >= 1.0
    assert stats == {k: float(v) for k, v in server.stats().items()}


def test_stream_orders_and_echoes_seq(stack):
    """One CaptionStream RPC carrying 3 DISTINCT stream_ids (so nothing
    can supersede): replies arrive in arrival order, seq echoes, and each
    caption equals the in-process result for that window."""
    fe, server, client = stack
    wins = [_window(s) for s in (10, 11, 12)]
    expect = [server.submit(w).result(timeout=120) for w in wins]

    reqs = [encode_window(w, stream_id=f"cam{i}", seq=100 + i)
            for i, w in enumerate(wins)]
    replies = list(client.caption_stream(reqs))
    assert [r.seq for r in replies] == [100, 101, 102]
    assert [r.caption for r in replies] == expect
    assert not any(r.superseded for r in replies)


def test_stream_per_rpc_supersession():
    """Default stream_id is per-RPC: windows pushed faster than the
    scheduler drains resolve all-but-the-last as superseded. A dedicated
    server with a long linger holds the queue open so the race is
    deterministic."""
    server = _make_server(max_wait_ms=1500.0)
    try:
        with CaptionGRPCFrontend(server, port=0) as fe:
            with CaptionClient(f"127.0.0.1:{fe.port}") as client:
                wins = [_window(s) for s in (20, 21)]
                reqs = [encode_window(w, seq=i) for i, w in enumerate(wins)]
                replies = list(client.caption_stream(reqs))
        assert [r.seq for r in replies] == [0, 1]
        assert replies[0].superseded and not replies[0].caption
        assert replies[1].caption and not replies[1].superseded
    finally:
        server.close()


def test_stream_bad_window_gets_error_reply(stack):
    """A malformed window inside a stream yields an error REPLY for that
    seq; the RPC keeps serving subsequent windows."""
    fe, server, client = stack
    good = _window(30)
    expect = server.submit(good).result(timeout=120)
    from rtvc_tpu_torch.proto import caption_pb2 as pb
    bad = pb.CaptionRequest(frames=b"xx", window=WINDOW, height=64,
                            width=64, stream_id="bad", seq=1)
    reqs = [bad, encode_window(good, stream_id="good", seq=2)]
    replies = list(client.caption_stream(reqs))
    assert [r.seq for r in replies] == [1, 2]
    assert "bytes" in replies[0].error
    assert replies[1].caption == expect


def test_stream_transport_failure_is_stream_error(stack):
    """A request iterator that dies mid-stream yields a reply flagged
    stream_error=True (not attributable to any window's seq), after the
    windows read before the failure were served normally."""
    fe, server, client = stack
    good = _window(60)
    expect = server.submit(good).result(timeout=120)

    def dying_iterator():
        yield encode_window(good, stream_id="pre-fail", seq=7)
        raise OSError("transport dropped")

    # drive the handler generator directly: grpc transports a client-side
    # generator failure as CANCELLED instead of handing the iterator's
    # exception to the servicer, so the reader's failure path is only
    # reachable deterministically in-process
    replies = list(fe._caption_stream(dying_iterator(), context=None))
    assert [r.seq for r in replies] == [7, 0]
    assert replies[0].caption == expect and not replies[0].stream_error
    assert replies[1].stream_error
    assert "transport dropped" in replies[1].error
    assert not replies[1].caption


def test_stream_client_cancel_keeps_server_alive(stack):
    """A client cancelling its CaptionStream RPC mid-flight must not take
    the scheduler or other RPCs with it: the held-open stream is cancelled
    after its first reply and a fresh unary still serves."""
    fe, server, client = stack
    hold = threading.Event()

    def gen():
        yield encode_window(_window(70), stream_id="cancel-me", seq=1)
        hold.wait(30)  # keep the RPC open until the test cancels it

    call = client.caption_stream(gen())
    it = iter(call)
    first = next(it)
    assert first.caption and first.seq == 1
    call.cancel()
    hold.set()
    reply = client.caption(_window(71), stream_id="after", timeout_s=120.0)
    assert reply.caption


def test_unary_bad_shape_is_invalid_argument(stack):
    fe, server, client = stack
    with pytest.raises(grpc.RpcError) as exc:
        client.caption(np.zeros((WINDOW, 16, 16, 3), np.uint8),
                       timeout_s=30.0)
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_unary_closed_server_is_unavailable():
    server = _make_server()
    with CaptionGRPCFrontend(server, port=0) as fe:
        with CaptionClient(f"127.0.0.1:{fe.port}") as client:
            server.close()
            with pytest.raises(grpc.RpcError) as exc:
                client.caption(_window(40), timeout_s=30.0)
            assert exc.value.code() == grpc.StatusCode.UNAVAILABLE


def test_concurrent_stream_rpcs_coalesce():
    """Two CaptionStream RPCs running concurrently share one scheduler:
    both complete with correct captions and at least one batch coalesced
    rows from both RPCs."""
    server = _make_server(max_wait_ms=60.0, max_batch=4)
    try:
        wins = [_window(s) for s in (50, 51)]
        expect = [server.submit(w).result(timeout=120) for w in wins]

        with CaptionGRPCFrontend(server, port=0) as fe:
            results = {}
            lock = threading.Lock()
            barrier = threading.Barrier(2)

            def rpc_worker(idx):
                with CaptionClient(f"127.0.0.1:{fe.port}") as client:
                    def gen():
                        barrier.wait(timeout=30)  # submits race the linger
                        yield encode_window(wins[idx],
                                            stream_id=f"rpc{idx}", seq=idx)
                    replies = list(client.caption_stream(gen()))
                    with lock:
                        results[idx] = replies

            threads = [threading.Thread(target=rpc_worker, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            stats = server.stats()

        for i in range(2):
            assert len(results[i]) == 1
            assert results[i][0].caption == expect[i]
        # the 60 ms linger must have coalesced the two racing windows
        assert stats["mean_batch"] > 1.0 or max(
            server.batch_sizes, default=1) > 1
    finally:
        server.close()


def test_unary_compressed_png_matches_raw(stack):
    """encoded_frames with PNG (lossless) must caption identically to the
    raw-bytes request for the same window."""
    pytest.importorskip("cv2")
    fe, server, client = stack
    win = _window(33)
    expect = server.submit(win).result(timeout=120)
    reply = client.caption(win, timeout_s=120.0, seq=7, compress=".png")
    assert reply.caption == expect
    assert reply.seq == 7


def test_unary_compressed_window_count_mismatch(stack):
    pytest.importorskip("cv2")
    from rtvc_tpu_torch.proto import caption_pb2 as pb
    from rtvc_tpu_torch.serving import compress_window
    fe, server, client = stack
    blobs = compress_window(_window(34), fmt=".png")
    req = pb.CaptionRequest(encoded_frames=blobs, window=WINDOW + 1)
    with pytest.raises(grpc.RpcError) as ei:
        client._caption(req, timeout=30)
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_unary_compressed_garbage_blob(stack):
    pytest.importorskip("cv2")
    from rtvc_tpu_torch.proto import caption_pb2 as pb
    fe, server, client = stack
    req = pb.CaptionRequest(encoded_frames=[b"not an image"] * WINDOW)
    with pytest.raises(grpc.RpcError) as ei:
        client._caption(req, timeout=30)
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_stream_compressed_windows(stack):
    """Compressed windows ride CaptionStream identically: distinct
    stream_ids, PNG-exact captions, seq echo."""
    pytest.importorskip("cv2")
    fe, server, client = stack
    wins = [_window(s) for s in (40, 41)]
    expect = [server.submit(w).result(timeout=120) for w in wins]
    reqs = [encode_window(w, stream_id=f"jcam{i}", seq=200 + i,
                          compress=".png")
            for i, w in enumerate(wins)]
    replies = list(client.caption_stream(reqs))
    assert [r.seq for r in replies] == [200, 201]
    assert [r.caption for r in replies] == expect


def test_unary_compressed_bomb_rejected_with_shape_message(stack):
    """A PNG decoding to a huge constant frame (decompression bomb) must
    fail INVALID_ARGUMENT after one frame decode, naming the shapes
    (ADVICE r3: the shape gate now runs inside decode, not after stacking
    the whole window)."""
    cv2 = pytest.importorskip("cv2")
    import numpy as _np

    from rtvc_tpu_torch.proto import caption_pb2 as pb
    fe, server, client = stack
    ok, buf = cv2.imencode(".png", _np.zeros((2048, 2048, 3), _np.uint8))
    assert ok
    req = pb.CaptionRequest(encoded_frames=[buf.tobytes()] * WINDOW)
    with pytest.raises(grpc.RpcError) as ei:
        client._caption(req, timeout=30)
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "decodes to" in ei.value.details()


def test_fuzz_hostile_protos_never_kill_the_server(stack):
    """Deterministic proto fuzz over the live stack: hostile
    CaptionRequests (garbage frame bytes, absurd/negative-ish dims,
    window/blob-count mismatches, junk encoded frames, huge-dim products)
    must map to INVALID_ARGUMENT on the unary RPC and per-seq error
    replies on the stream RPC — never INTERNAL, never a wedged server."""
    import grpc

    from rtvc_tpu_torch.proto import caption_pb2 as pb

    fe, server, client = stack
    rng = np.random.default_rng(99)

    def junk(n):
        return rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()

    hostile = [
        pb.CaptionRequest(),                                    # all-default
        pb.CaptionRequest(frames=junk(7)),                      # no dims
        pb.CaptionRequest(frames=b"", window=WINDOW,
                          height=FRAME[0], width=FRAME[1]),     # empty body
        pb.CaptionRequest(frames=junk(100), window=WINDOW,
                          height=2 ** 30, width=2 ** 30),       # dim product huge
        pb.CaptionRequest(frames=junk(100), window=2 ** 31 - 1,
                          height=1, width=1),                   # absurd window
        pb.CaptionRequest(encoded_frames=[junk(16)] * WINDOW),  # undecodable
        pb.CaptionRequest(encoded_frames=[b""] * WINDOW),       # empty blobs
        pb.CaptionRequest(encoded_frames=[junk(16)],
                          window=WINDOW),                       # count mismatch
        pb.CaptionRequest(frames=junk(64), encoded_frames=[junk(8)],
                          window=WINDOW, height=FRAME[0],
                          width=FRAME[1]),                      # both paths set
    ] + [
        pb.CaptionRequest(frames=junk(rng.integers(0, 512)),
                          window=int(rng.integers(0, 8)),
                          height=int(rng.integers(0, 256)),
                          width=int(rng.integers(0, 256)),
                          seq=i)
        for i in range(30)
    ]

    for req in hostile:
        try:
            client._caption(req, timeout=30.0)
        except grpc.RpcError as e:
            assert e.code() == grpc.StatusCode.INVALID_ARGUMENT, (
                e.code(), e.details())

    # the same storm through ONE stream RPC: every window gets a per-seq
    # error reply and the RPC survives to serve a real window at the end
    good = _window(77)
    expect = server.submit(good).result(timeout=120)
    reqs = []
    for i, req in enumerate(hostile):
        req.seq = i + 1
        req.stream_id = "fuzz"
        reqs.append(req)
    reqs.append(encode_window(good, stream_id="fuzz", seq=len(reqs) + 1))
    replies = list(client.caption_stream(reqs))
    assert replies[-1].caption == expect
    tail_errors = [r for r in replies[:-1] if r.error]
    assert len(tail_errors) >= len(hostile) - 5  # supersession may coalesce a few
    # and the unary path still serves normally afterwards
    assert client.caption(good, timeout_s=120.0).caption == expect


def test_messages_are_the_jax_packages():
    """Both copies of caption_pb2 declare caption.proto in package rtvc:
    in one process they are one set of classes, so either front's clients
    talk to the other."""
    assert caption_pb2.CaptionRequest is jpb.CaptionRequest
    assert caption_pb2.DESCRIPTOR is jpb.DESCRIPTOR


def test_unary_rows_equal_jax_front():
    """JAX's server and gRPC front and the port's, the same weights (the
    bridge, ``lively`` so that the rows depend on the window; a JAX replay
    asserts every argmax wins by more than 1e-3): the same captions over
    gRPC, and their servers the same rows."""
    jmodel, variables = jax_student(size=224)
    variables = lively(variables)
    port = port_student(variables, input_size=224)
    rng = np.random.default_rng(12)
    wins = [rng.integers(0, 255, size=(FRAMES,) + FRAME).astype(np.uint8)
            for _ in range(3)]
    replay = assert_jax_greedy_margins(
        jmodel, variables, jax_preprocessed(np.stack(wins), 224), 8)
    kw = dict(max_batch=1, max_wait_ms=0.0, max_len=8, frame_shape=FRAME,
              window=FRAMES)
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        with jserving.BatchCaptionServer(jmodel, variables, JaxTokenizer(),
                                         **kw) as jsrv:
            with jserving_grpc.CaptionGRPCFrontend(jsrv, port=0) as fe:
                with jserving_grpc.CaptionClient(
                        f"127.0.0.1:{fe.port}") as client:
                    want = [client.caption(w, timeout_s=120.0, seq=i)
                            for i, w in enumerate(wins)]
            jrows = [jsrv.submit(w).tokens(timeout=120) for w in wins]
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    with BatchCaptionServer(port, BertWordPieceTokenizer(), **kw) as srv:
        with CaptionGRPCFrontend(srv, port=0) as fe:
            with CaptionClient(f"127.0.0.1:{fe.port}") as client:
                got = [client.caption(w, timeout_s=120.0, seq=i)
                       for i, w in enumerate(wins)]
        rows = [srv.submit(w).tokens(timeout=120) for w in wins]
    for row, jrow, rrow in zip(rows, jrows, replay):
        np.testing.assert_array_equal(jrow, truncate_at_sep(rrow))
        np.testing.assert_array_equal(row, jrow)
    assert [(r.caption, r.seq) for r in got] == \
        [(r.caption, r.seq) for r in want]
    assert all(r.caption for r in want)
