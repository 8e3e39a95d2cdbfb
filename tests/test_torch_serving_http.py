"""The port's HTTP front (rtvc_tpu_torch.serving_http), the cases of
tests/test_serving_http.py.

Drives a real ThreadingHTTPServer over a loopback socket with urllib, in
front of the port's BatchCaptionServer on a tiny student (the sizes of
tests/test_models.py, seeded random weights, float32, on the CPU):
octet-stream and JSON request formats, caption equality with the
in-process API, PNG frames captioned exactly as raw ones, supersession ->
409, stats/healthz endpoints, input validation -> 400, a failing step ->
500, and a deterministic fuzz of garbage requests. Every HTTP server binds
port 0.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rtvc_tpu_torch.models.student import StudentCandidateV1, random_init_
from rtvc_tpu_torch.serving import BatchCaptionServer
from rtvc_tpu_torch.serving_http import CaptionHTTPFrontend
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

from test_torch_models import port_encoder_config

WINDOW = 3
FRAME = (64, 64, 3)


def tiny_port_student(seed: int = 0) -> StudentCandidateV1:
    """test_models.tiny_student's sizes, for 224-pixel frames (the
    preprocess output), seeded random weights, eval mode."""
    model = StudentCandidateV1(
        d_model=32, n_head=4, d_ffn=64, num_decoder_layers=2,
        vocab_size=211, max_pos_len=64,
        encoder_config=port_encoder_config(True), input_size=224,
        num_frames=WINDOW, teacher_visual_dim=32, teacher_num_tokens=10,
        teacher_hidden=16)
    return random_init_(model, torch.Generator().manual_seed(seed)).eval()


@pytest.fixture(scope="module")
def frontend():
    server = BatchCaptionServer(tiny_port_student(), BertWordPieceTokenizer(),
                                max_batch=2, max_wait_ms=5.0, max_len=8,
                                frame_shape=FRAME, window=WINDOW)
    with CaptionHTTPFrontend(server, port=0) as fe:
        yield fe, server
    server.close()


def _window(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(WINDOW,) + FRAME).astype(np.uint8)


def _post(fe, path, data, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{fe.port}{path}",
                                 data=data, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _get(fe, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{fe.port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def test_healthz_and_stats(frontend):
    fe, _ = frontend
    assert _get(fe, "/healthz") == (200, {"ok": True})
    status, stats = _get(fe, "/v1/stats")
    assert status == 200 and "served" in stats


def test_octet_stream_caption_matches_inprocess(frontend):
    fe, server = frontend
    win = _window(1)
    expected = server.submit(win).result(timeout=120)
    shape_hdr = ",".join(str(s) for s in win.shape)
    status, payload = _post(fe, "/v1/caption", win.tobytes(), {
        "Content-Type": "application/octet-stream",
        "X-Frames-Shape": shape_hdr,
    })
    assert status == 200
    assert payload["caption"] == expected
    assert payload["latency_ms"] > 0


def test_json_caption_matches_inprocess(frontend):
    fe, server = frontend
    win = _window(2)
    expected = server.submit(win).result(timeout=120)
    body = json.dumps({
        "frames_b64": base64.b64encode(win.tobytes()).decode(),
        "shape": list(win.shape),
    }).encode()
    status, payload = _post(fe, "/v1/caption", body,
                            {"Content-Type": "application/json"})
    assert status == 200
    assert payload["caption"] == expected


def test_supersession_maps_to_409(frontend):
    fe, server = frontend
    # Stall the scheduler briefly so two same-stream windows are pending
    # together: submit both before the first can dispatch.
    results = {}

    def post_one(tag, seed):
        win = _window(seed)
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/v1/caption", data=win.tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Frames-Shape": ",".join(str(s) for s in win.shape),
                     "X-Stream-Id": "cam0"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                results[tag] = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            results[tag] = (e.code, json.loads(e.read()))

    threads = [threading.Thread(target=post_one, args=(i, 10 + i))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    codes = [c for c, _ in results.values()]
    # At least one request must complete; any superseded one returns 409
    # with the marker payload. (Timing decides how many get superseded.)
    assert 200 in codes
    for code, payload in results.values():
        if code == 409:
            assert payload == {"superseded": True}
        else:
            assert code == 200 and isinstance(payload["caption"], str)


@pytest.mark.parametrize("body,headers,why", [
    (b"", {"Content-Type": "application/octet-stream",
           "X-Frames-Shape": "3,64,64,3"}, "empty body"),
    (b"\x00" * 17, {"Content-Type": "application/octet-stream",
                    "X-Frames-Shape": "3,64,64,3"}, "size mismatch"),
    (b"\x00" * 64, {"Content-Type": "application/octet-stream"},
     "missing shape header"),
    (json.dumps({"shape": [3, 64, 64, 3]}).encode(),
     {"Content-Type": "application/json"}, "missing frames_b64"),
    # negative dims whose product still matches the byte count: without a
    # positivity check this reaches reshape and the error would escape as
    # a connection reset instead of a 400
    (b"\x00" * (3 * 64 * 64 * 3),
     {"Content-Type": "application/octet-stream",
      "X-Frames-Shape": "3,64,-64,-3"}, "negative dims"),
    (json.dumps({"shape": [3, 64, 64, 3], "timeout_s": {"oops": 1},
                 "frames_b64": base64.b64encode(
                     b"\x00" * (3 * 64 * 64 * 3)).decode()}).encode(),
     {"Content-Type": "application/json"}, "non-numeric timeout_s"),
])
def test_bad_requests_return_400(frontend, body, headers, why):
    fe, _ = frontend
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(fe, "/v1/caption", body, headers)
    assert ei.value.code == 400, why


def test_bad_content_length_returns_400(frontend):
    """A non-numeric Content-Length must produce an HTTP 400, not an
    unhandled ValueError that resets the connection (urllib always sends a
    correct header, so drive a raw socket)."""
    import socket
    fe, _ = frontend
    with socket.create_connection(("127.0.0.1", fe.port), timeout=30) as s:
        s.sendall(b"POST /v1/caption HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: abc\r\n\r\n")
        status_line = s.recv(4096).split(b"\r\n", 1)[0]
    assert b" 400 " in status_line + b" "


def test_wrong_window_shape_returns_400(frontend):
    fe, _ = frontend
    win = np.zeros((WINDOW, 32, 32, 3), np.uint8)  # server expects 64x64
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(fe, "/v1/caption", win.tobytes(), {
            "Content-Type": "application/octet-stream",
            "X-Frames-Shape": ",".join(str(s) for s in win.shape),
        })
    assert ei.value.code == 400


def test_unknown_path_404(frontend):
    fe, _ = frontend
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(fe, "/v2/nope")
    assert ei.value.code == 404


def test_compressed_png_octet_stream_matches_raw(frontend):
    """PNG is lossless: the compressed body must yield the EXACT caption
    of the raw-bytes submission of the same window."""
    pytest.importorskip("cv2")
    from rtvc_tpu_torch.serving import compress_window
    from rtvc_tpu_torch.serving_http import pack_encoded_frames
    fe, server = frontend
    win = _window(21)
    expected = server.submit(win).result(timeout=120)
    body = pack_encoded_frames(compress_window(win, fmt=".png"))
    status, payload = _post(fe, "/v1/caption", body, {
        "Content-Type": "application/octet-stream",
        "X-Frames-Encoding": "image",
    })
    assert status == 200
    assert payload["caption"] == expected


def test_compressed_jpeg_json_serves_and_shrinks(frontend):
    """JPEG (lossy) must serve a caption; on a smooth window the payload
    is much smaller than raw (the feature's point: MJPEG-sized uploads)."""
    cv2 = pytest.importorskip("cv2")
    from rtvc_tpu_torch.serving import compress_window
    fe, _ = frontend
    # smooth gradient compresses well (random noise wouldn't)
    col = np.linspace(0, 255, FRAME[1], dtype=np.uint8)
    win = np.broadcast_to(col[None, None, :, None],
                          (WINDOW,) + FRAME).copy()
    blobs = compress_window(win, fmt=".jpg", quality=90)
    assert sum(len(b) for b in blobs) < win.nbytes // 10
    body = json.dumps({
        "encoded_frames_b64": [base64.b64encode(b).decode() for b in blobs],
    }).encode()
    status, payload = _post(fe, "/v1/caption", body,
                            {"Content-Type": "application/json"})
    assert status == 200
    assert isinstance(payload["caption"], str)


@pytest.mark.parametrize("body,why", [
    (b"\x00\x00\x00\x05abc", "length prefix overruns body"),
    (b"\x00\x00\x00\x03abc", "blob is not a decodable image"),
    (b"", "empty body"),
])
def test_compressed_bad_bodies_return_400(frontend, body, why):
    pytest.importorskip("cv2")
    fe, _ = frontend
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(fe, "/v1/caption", body, {
            "Content-Type": "application/octet-stream",
            "X-Frames-Encoding": "image",
        })
    assert ei.value.code == 400, why


def _http_error_message(err: urllib.error.HTTPError) -> str:
    return json.loads(err.read())["error"]


def test_compressed_wrong_frame_size_400_with_precise_message(frontend):
    """A blob decoding to a different H,W than the server's frame_shape is
    a 400 whose message names the shapes — the bomb guard (ADVICE r3) and
    the unwrapped-_BadRequest fix in one: the JSON path must NOT re-wrap
    it as 'bad JSON caption request'."""
    pytest.importorskip("cv2")
    from rtvc_tpu_torch.serving import compress_window
    from rtvc_tpu_torch.serving_http import pack_encoded_frames
    fe, _ = frontend
    big = np.zeros((WINDOW, 512, 512, 3), np.uint8)  # server expects 64x64
    blobs = compress_window(big, fmt=".png")
    # octet-stream path
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(fe, "/v1/caption", pack_encoded_frames(blobs), {
            "Content-Type": "application/octet-stream",
            "X-Frames-Encoding": "image",
        })
    assert ei.value.code == 400
    assert "decodes to" in _http_error_message(ei.value)
    # JSON path: same precise message, no 'bad JSON caption request' wrap
    body = json.dumps({
        "encoded_frames_b64": [base64.b64encode(b).decode() for b in blobs],
    }).encode()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(fe, "/v1/caption", body,
              {"Content-Type": "application/json"})
    assert ei.value.code == 400
    msg = _http_error_message(ei.value)
    assert "decodes to" in msg and "bad JSON caption request" not in msg


def test_zero_length_encoded_frame_message(frontend):
    fe, _ = frontend
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(fe, "/v1/caption", b"\x00\x00\x00\x00", {
            "Content-Type": "application/octet-stream",
            "X-Frames-Encoding": "image",
        })
    assert ei.value.code == 400
    assert "zero-length encoded frame" in _http_error_message(ei.value)


def test_fuzz_decoder_helpers_raise_valueerror_only():
    """Deterministic fuzz of the two shared body parsers: any byte soup
    either parses or raises ValueError/_BadRequest — never IndexError,
    cv2.error, MemoryError, or an allocation proportional to a forged
    length prefix (both network fronts route untrusted bodies here)."""
    from rtvc_tpu_torch.serving import decode_compressed_frames
    from rtvc_tpu_torch.serving_http import _BadRequest, _split_length_prefixed

    rng = np.random.default_rng(7)
    crafted = [
        b"",
        b"\x00\x00\x00\x00",                      # zero-length frame
        b"\xff\xff\xff\xff" + b"x" * 8,           # 4 GB forged prefix
        (8).to_bytes(4, "big") + b"short",        # overruns body
        (3).to_bytes(4, "big") + b"abc" + b"\x00",  # trailing partial prefix
    ]
    bodies = crafted + [
        rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
        for n in rng.integers(1, 96, size=200)
    ]
    parsed = 0
    for raw in bodies:
        try:
            blobs = _split_length_prefixed(raw)
        except _BadRequest:
            continue
        parsed += 1
        try:
            decode_compressed_frames(blobs, expect_shape=(len(blobs), 8, 8, 3))
        except ValueError:
            pass
    assert parsed >= 1  # the fuzz actually exercised the decode stage


def test_fuzz_garbage_http_requests_never_crash(frontend):
    """Deterministic request fuzz over the live loopback server: random
    bodies under every framing mode must yield clean HTTP statuses (400
    for garbage, 200 only if a mutation accidentally forms a valid
    window) — never 5xx, never a hang, and the server must still caption
    normally afterwards."""
    fe, server = frontend
    rng = np.random.default_rng(1234)
    shape_hdr = f"{WINDOW},{FRAME[0]},{FRAME[1]},3"
    url = f"http://127.0.0.1:{fe.port}/v1/caption"

    def post(body, headers):
        req = urllib.request.Request(url, data=body, headers=headers,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                r.read()
                return r.status
        except urllib.error.HTTPError as e:
            e.read()
            return e.code

    valid = _window(9).tobytes()
    codes = []
    for i in range(120):
        kind = i % 6
        n = int(rng.integers(0, 512))
        junk = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        if kind == 0:        # raw junk, no framing headers at all
            codes.append(post(junk, {}))
        elif kind == 1:      # junk with a syntactically valid shape header
            codes.append(post(junk, {"Content-Type": "application/octet-stream",
                                     "X-Frames-Shape": shape_hdr}))
        elif kind == 2:      # junk declared as length-prefixed images
            codes.append(post(junk, {"X-Frames-Encoding": "image"}))
        elif kind == 3:      # junk declared as JSON
            codes.append(post(junk, {"Content-Type": "application/json"}))
        elif kind == 4:      # well-formed JSON, hostile field values
            payload = rng.choice([
                '{"shape": "not-a-list", "frames_b64": "AAAA"}',
                '{"shape": [3, -1, 64, 3], "frames_b64": "AAAA"}',
                '{"shape": [1e99], "frames_b64": "AAAA"}',
                '{"frames_b64": "####"}',
                '{"encoded_frames_b64": [42]}',
                '{"encoded_frames_b64": ["", "", ""]}',  # empty blobs
                '{"encoded_frames_b64": ["%s"]}' % base64.b64encode(
                    junk[:32]).decode(),
                '{"shape": [%d, %d, %d, 3], "frames_b64": "%s", '
                '"timeout_s": "soon"}' % (
                    WINDOW, FRAME[0], FRAME[1],
                    base64.b64encode(valid).decode()),
                '[]', 'null', '{"shape": [3,64,64,3]}',
            ])
            codes.append(post(payload.encode(), {"Content-Type":
                                                 "application/json"}))
        else:                # mutate a VALID raw body (truncate / grow)
            cut = int(rng.integers(0, len(valid) + 64))
            body = (valid[:cut] if cut <= len(valid)
                    else valid + junk[:cut - len(valid)])
            codes.append(post(body, {"Content-Type":
                                     "application/octet-stream",
                                     "X-Frames-Shape": shape_hdr}))
    assert all(c in (200, 400) for c in codes), sorted(set(codes))
    assert codes.count(400) > 60  # the fuzz mostly produced rejections

    # clients that lie about Content-Length or hang up mid-request must
    # not wedge the handler thread or the acceptor
    import socket
    for payload in (
            b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 1000\r\n\r\nabc",     # body shorter than declared
            b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n",  # headers cut short
            b"\x16\x03\x01junk"):                   # TLS hello at an HTTP port
        s = socket.create_connection(("127.0.0.1", fe.port), timeout=10)
        s.sendall(payload)
        s.close()

    # server is alive and still serves real captions after the storm
    status, health = _get(fe, "/healthz")
    assert status == 200 and health["ok"]
    win = _window(10)
    status, out = _post(fe, "/v1/caption", win.tobytes(),
                        {"Content-Type": "application/octet-stream",
                         "X-Frames-Shape": shape_hdr})
    assert status == 200 and isinstance(out["caption"], str)


def test_failing_step_returns_500():
    """A step that raises resolves the request's future with the error,
    which the front answers with a 500; a closed server with a 503."""
    server = BatchCaptionServer(tiny_port_student(), BertWordPieceTokenizer(),
                                max_batch=1, max_wait_ms=0.0, max_len=4,
                                frame_shape=FRAME, window=WINDOW,
                                warmup=False)
    server._step = lambda *a: (_ for _ in ()).throw(RuntimeError("boom"))
    win = _window(3)
    headers = {"Content-Type": "application/octet-stream",
               "X-Frames-Shape": ",".join(str(s) for s in win.shape)}
    with CaptionHTTPFrontend(server, port=0) as fe:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(fe, "/v1/caption", win.tobytes(), headers)
        assert ei.value.code == 500
        assert "boom" in _http_error_message(ei.value)
        server.close()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(fe, "/v1/caption", win.tobytes(), headers)
        assert ei.value.code == 503


def test_timeout_returns_408():
    """A request whose caption is not ready within its timeout_s gets a
    408."""
    server = BatchCaptionServer(tiny_port_student(), BertWordPieceTokenizer(),
                                max_batch=1, max_wait_ms=0.0, max_len=4,
                                frame_shape=FRAME, window=WINDOW,
                                warmup=False)
    release = threading.Event()
    step = server._step
    server._step = lambda frames: (release.wait(60), step(frames))[1]
    win = _window(4)
    body = json.dumps({"frames_b64": base64.b64encode(win.tobytes()).decode(),
                       "shape": list(win.shape), "timeout_s": 0.2}).encode()
    try:
        with CaptionHTTPFrontend(server, port=0) as fe:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(fe, "/v1/caption", body,
                      {"Content-Type": "application/json"})
            assert ei.value.code == 408
    finally:
        release.set()
        server.close()


def test_pack_encoded_frames_layout():
    from rtvc_tpu_torch.serving_http import (_split_length_prefixed,
                                             pack_encoded_frames)
    blobs = [b"abc", b"\x00" * 300, b"z"]
    body = pack_encoded_frames(blobs)
    assert body[:4] == (3).to_bytes(4, "big")
    assert _split_length_prefixed(body) == blobs
