"""HTTP front-end for the batched caption server.

A copy of ``rtvc_tpu/serving_http.py`` (stdlib only) over the port's
``BatchCaptionServer``: the same routes, request formats and status codes.
It puts a network boundary in front of ``submit`` so remote clients
(cameras, edge boxes, load generators) can share one card:

    POST /v1/caption      caption one frame window
    GET  /v1/stats        scheduler/batching statistics
    GET  /healthz         liveness

Stdlib-only (``http.server.ThreadingHTTPServer``): one OS thread per
in-flight request, each parked on its ``CaptionFuture`` — the actual
batching/coalescing stays in the server's single scheduler thread, so
the concurrency model is unchanged from the in-process API, and no
handler thread touches the card.

Request formats:

- ``application/octet-stream`` body = raw ``window*H*W*3`` uint8 bytes
  (C-order) with header ``X-Frames-Shape: <window>,<H>,<W>,3``; optional
  ``X-Stream-Id``.
- ``application/octet-stream`` + ``X-Frames-Encoding: image`` body =
  per-frame JPEG/PNG blobs, each prefixed by a 4-byte big-endian length
  (what MJPEG cameras emit — ~10-30x smaller at JPEG q90; PNG is
  lossless and caption-exact vs raw). No ``X-Frames-Shape`` needed.
- ``application/json`` body = ``{"frames_b64": ..., "shape": [w,h,wd,3],
  "stream_id": ..., "timeout_s": ...}`` — or
  ``{"encoded_frames_b64": [<b64 JPEG/PNG>, ...], ...}``.

Responses: 200 ``{"caption", "latency_ms"}``; 409 if a newer window from
the same stream superseded this one; 400/408/503 for bad input / timeout
/ closed server; 500 if the step failed.

    python -m rtvc_tpu_torch.serving_http --port 0 [--ckpt DIR] [--beam 3]
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .serving import BatchCaptionServer, decode_compressed_frames

DEFAULT_TIMEOUT_S = 60.0
MAX_BODY_BYTES = 64 * 1024 * 1024


class CaptionHTTPFrontend:
    """Serve one ``BatchCaptionServer`` over HTTP.

    >>> with CaptionHTTPFrontend(server, port=0) as fe:   # doctest: +SKIP
    ...     print(fe.port)
    """

    def __init__(self, server: BatchCaptionServer, *, host: str = "127.0.0.1",
                 port: int = 8080):
        self.server = server
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # Quiet by default: the BaseHTTPRequestHandler stderr log is
            # per-request noise in production; stats live at /v1/stats.
            def log_message(self, fmt: str, *args: Any) -> None:
                pass

            def _send_json(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                if self.path == "/healthz":
                    self._send_json(200, {"ok": True})
                elif self.path == "/v1/stats":
                    self._send_json(200, frontend.server.stats())
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self) -> None:  # noqa: N802
                if self.path != "/v1/caption":
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    window, stream_id, timeout_s = self._parse_caption_body()
                except _BadRequest as e:
                    self._send_json(400, {"error": str(e)})
                    return
                except Exception as e:
                    # any other malformed-input failure (bad headers,
                    # reshape errors, ...) must still answer 400, never
                    # kill the handler thread with no HTTP response
                    self._send_json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    fut = frontend.server.submit(window, stream_id=stream_id)
                except RuntimeError as e:  # server closed
                    self._send_json(503, {"error": str(e)})
                    return
                except ValueError as e:  # wrong window shape for server
                    self._send_json(400, {"error": str(e)})
                    return
                try:
                    text = fut.result(timeout=timeout_s)
                except TimeoutError:
                    self._send_json(408, {"error": "caption timed out"})
                    return
                except Exception as e:  # scheduler-side failure
                    self._send_json(500, {"error": str(e)})
                    return
                if text is None:  # resolved-but-None == superseded
                    self._send_json(409, {"superseded": True})
                    return
                lat = fut.latency_s
                self._send_json(200, {
                    "caption": text,
                    "latency_ms": None if lat is None else lat * 1e3,
                })

            def _parse_caption_body(
                    self) -> Tuple[np.ndarray, Optional[str], float]:
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    raise _BadRequest("bad Content-Length")
                if length <= 0:
                    raise _BadRequest("empty body")
                if length > MAX_BODY_BYTES:
                    raise _BadRequest("body too large")
                raw = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                timeout_s = DEFAULT_TIMEOUT_S
                expect = ((frontend.server.window,)
                          + frontend.server.frame_shape)
                if ctype == "application/json":
                    try:
                        payload = json.loads(raw)
                        timeout_s = float(payload.get("timeout_s", timeout_s))
                        if "encoded_frames_b64" in payload:
                            blobs = [base64.b64decode(b)
                                     for b in payload["encoded_frames_b64"]]
                            window = _decode_blobs(blobs, expect)
                            return (window, payload.get("stream_id"),
                                    timeout_s)
                        shape = tuple(int(s) for s in payload["shape"])
                        buf = base64.b64decode(payload["frames_b64"])
                    except _BadRequest:
                        raise  # already a precise message — don't re-wrap
                    except (KeyError, ValueError, TypeError) as e:
                        raise _BadRequest(f"bad JSON caption request: {e}")
                    stream_id = payload.get("stream_id")
                else:
                    stream_id = self.headers.get("X-Stream-Id")
                    if (self.headers.get("X-Frames-Encoding") or ""
                        ).lower() in ("image", "jpeg", "jpg", "png"):
                        window = _decode_blobs(_split_length_prefixed(raw),
                                               expect)
                        return window, stream_id, timeout_s
                    hdr = self.headers.get("X-Frames-Shape")
                    if not hdr:
                        raise _BadRequest(
                            "octet-stream needs X-Frames-Shape: w,h,wd,3 "
                            "(or X-Frames-Encoding: image with "
                            "length-prefixed JPEG/PNG frames)")
                    try:
                        shape = tuple(int(s) for s in hdr.split(","))
                    except ValueError:
                        raise _BadRequest(f"bad X-Frames-Shape {hdr!r}")
                    buf = raw
                if any(s <= 0 for s in shape):
                    raise _BadRequest(f"non-positive dim in shape {shape}")
                expected = int(np.prod(shape))
                if len(buf) != expected:
                    raise _BadRequest(
                        f"frame buffer is {len(buf)} bytes, shape {shape} "
                        f"needs {expected}")
                window = np.frombuffer(buf, np.uint8).reshape(shape)
                return window, stream_id, timeout_s

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "CaptionHTTPFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "CaptionHTTPFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class _BadRequest(ValueError):
    pass


def _split_length_prefixed(raw: bytes) -> list:
    """Body of [4-byte BE length][blob]... -> list of blobs."""
    blobs, off = [], 0
    while off < len(raw):
        if off + 4 > len(raw):
            raise _BadRequest("truncated length prefix in encoded frames")
        n = int.from_bytes(raw[off:off + 4], "big")
        off += 4
        if n == 0:
            raise _BadRequest(f"zero-length encoded frame at offset {off}")
        if off + n > len(raw):
            raise _BadRequest(
                f"encoded frame length {n} overruns body at offset {off}")
        blobs.append(raw[off:off + n])
        off += n
    return blobs


def _decode_blobs(blobs: list,
                  expect_shape: Optional[tuple] = None) -> np.ndarray:
    try:
        return decode_compressed_frames(blobs, expect_shape=expect_shape)
    except ValueError as e:  # decode_compressed_frames signals via ValueError
        raise _BadRequest(str(e))


def pack_encoded_frames(blobs: list) -> bytes:
    """Client helper: JPEG/PNG blobs (``serving.compress_window``) -> the
    length-prefixed octet-stream body for ``X-Frames-Encoding: image``."""
    return b"".join(len(b).to_bytes(4, "big") + b for b in blobs)


def main(argv: Optional[list] = None) -> None:
    """Serve captions over HTTP (random weights unless --ckpt is given)."""
    import argparse

    from .serving import add_frontend_cli_args, server_from_frontend_args

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--port", type=int, default=8080)
    add_frontend_cli_args(p)
    a = p.parse_args(argv)

    server = server_from_frontend_args(a)
    with CaptionHTTPFrontend(server, host=a.host, port=a.port) as fe:
        print(f"serving on http://{a.host}:{fe.port}  "
              f"(POST /v1/caption, GET /v1/stats)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
    server.close()


if __name__ == "__main__":
    main()
