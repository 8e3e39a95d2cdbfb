"""gRPC front for the batched caption server.

Counterpart of ``rtvc_tpu/serving_grpc.py`` over the port's
``BatchCaptionServer``. gRPC adds what the HTTP front
(``serving_http``) cannot express: **one long-lived bidirectional
``CaptionStream`` RPC per camera**. The client pushes frame windows as fast
as it likes; the server batches across every live RPC (and any HTTP or
in-process traffic: they all share one ``BatchCaptionServer`` scheduler)
and pushes a reply per window in arrival order, marking windows that a
newer one from the same stream superseded.

Service definition: ``rtvc_tpu_torch/proto/caption.proto``, the JAX
package's service and messages (a client of either server talks to the
other). Only the protobuf messages are generated (``proto/caption_pb2.py``);
the service is registered through
``grpc.method_handlers_generic_handler``, wire-identical to
plugin-generated stubs.

RPCs (package ``rtvc``, service ``CaptionService``):

- ``Caption``        unary: one window -> one caption (like POST /v1/caption)
- ``CaptionStream``  bidi: stream windows -> stream captions, per-RPC
                     supersession by default (``stream_id`` overrides)
- ``Stats``          unary: scheduler/batching statistics

The module imports without grpcio installed; constructing the front or a
client then raises a clear error.

CLI (random weights unless ``--ckpt``; ``--device cpu`` without a card)::

    python -m rtvc_tpu_torch.serving_grpc --port 50051 [--ckpt DIR]
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np

from .proto import caption_pb2 as pb
from .serving import (BatchCaptionServer, compress_window,
                      decode_compressed_frames)

try:  # pragma: no cover - exercised implicitly by every test
    import grpc
except ImportError:  # pragma: no cover
    grpc = None

DEFAULT_TIMEOUT_S = 60.0
# Streaming replies wait at most this long per window before reporting an
# error reply (a stuck scheduler must not wedge the RPC forever).
STREAM_WINDOW_TIMEOUT_S = 120.0
SERVICE_NAME = "rtvc.CaptionService"
MAX_MESSAGE_BYTES = 64 * 1024 * 1024  # matches serving_http MAX_BODY_BYTES


def _require_grpc() -> None:
    if grpc is None:
        raise ImportError(
            "grpcio is required for rtvc_tpu_torch.serving_grpc (the "
            "in-process and HTTP fronts in serving.py / serving_http.py "
            "work without it)")


def _decode_window(req: "pb.CaptionRequest",
                   expect_shape: tuple) -> np.ndarray:
    """CaptionRequest -> [window, H, W, 3] uint8 array (validated).

    ``expect_shape`` is the server's ``(window, H, W, 3)``; the compressed
    path forwards it so a decompression-bomb blob is rejected after ONE
    frame decode (see serving.decode_compressed_frames)."""
    if req.encoded_frames:  # compressed path: one JPEG/PNG blob per frame
        if req.window and int(req.window) != len(req.encoded_frames):
            raise ValueError(
                f"window={int(req.window)} but {len(req.encoded_frames)} "
                f"encoded frames")
        return decode_compressed_frames(req.encoded_frames,
                                        expect_shape=expect_shape)
    window = int(req.window) or expect_shape[0]
    shape = (window, int(req.height), int(req.width), 3)
    if any(s <= 0 for s in shape):
        raise ValueError(f"non-positive dim in frame shape {shape}")
    expected = int(np.prod(shape))
    if len(req.frames) != expected:
        raise ValueError(
            f"frames is {len(req.frames)} bytes, shape {shape} needs "
            f"{expected}")
    return np.frombuffer(req.frames, np.uint8).reshape(shape)


def encode_window(window: np.ndarray, *, stream_id: str = "",
                  timeout_s: float = 0.0, seq: int = 0,
                  compress: Optional[str] = None,
                  quality: int = 90) -> "pb.CaptionRequest":
    """[window, H, W, 3] uint8 array -> CaptionRequest (client helper).

    ``compress=".jpg"`` (lossy, ~10-30x smaller at q90) or ``".png"``
    (lossless — caption-exact vs raw, pinned by tests) sends one encoded
    blob per frame instead of raw pixels.
    """
    window = np.ascontiguousarray(window, np.uint8)
    if window.ndim != 4 or window.shape[-1] != 3:
        raise ValueError(f"expected [window, H, W, 3], got {window.shape}")
    if compress is not None:
        return pb.CaptionRequest(
            encoded_frames=compress_window(window, fmt=compress,
                                           quality=quality),
            window=window.shape[0], stream_id=stream_id,
            timeout_s=timeout_s, seq=seq)
    return pb.CaptionRequest(
        frames=window.tobytes(), window=window.shape[0],
        height=window.shape[1], width=window.shape[2],
        stream_id=stream_id, timeout_s=timeout_s, seq=seq)


class CaptionGRPCFrontend:
    """Serve one ``BatchCaptionServer`` over gRPC.

    >>> with CaptionGRPCFrontend(server, port=0) as fe:   # doctest: +SKIP
    ...     print(fe.port)
    """

    def __init__(self, server: BatchCaptionServer, *,
                 host: str = "127.0.0.1", port: int = 50051,
                 max_workers: int = 64):
        """``max_workers`` is the CONCURRENT-RPC cap: every live
        CaptionStream RPC pins one (mostly sleeping) worker thread for
        its whole lifetime, so size it above the expected camera count
        plus unary headroom — an exhausted pool queues new RPCs
        indefinitely with no error."""
        _require_grpc()
        from concurrent import futures

        self.server = server
        executor = futures.ThreadPoolExecutor(max_workers=max_workers)
        self._grpc_server = grpc.server(
            executor,
            options=[
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ])
        self._grpc_server.add_generic_rpc_handlers((self._handlers(),))
        self.port = self._grpc_server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            # release the never-started server's executor instead of
            # leaking its idle threads for the process lifetime
            self._grpc_server.stop(0)
            executor.shutdown(wait=False)
            raise RuntimeError(f"could not bind gRPC port on {host}:{port}")
        self._anon_rpc_counter = itertools.count(1)

    # ------------------------------------------------------------- handlers

    def _handlers(self) -> Any:
        rpcs = {
            "Caption": grpc.unary_unary_rpc_method_handler(
                self._caption,
                request_deserializer=pb.CaptionRequest.FromString,
                response_serializer=pb.CaptionReply.SerializeToString),
            "CaptionStream": grpc.stream_stream_rpc_method_handler(
                self._caption_stream,
                request_deserializer=pb.CaptionRequest.FromString,
                response_serializer=pb.CaptionReply.SerializeToString),
            "Stats": grpc.unary_unary_rpc_method_handler(
                self._stats,
                request_deserializer=pb.StatsRequest.FromString,
                response_serializer=pb.StatsReply.SerializeToString),
        }
        return grpc.method_handlers_generic_handler(SERVICE_NAME, rpcs)

    def _caption(self, req: "pb.CaptionRequest", context: Any
                 ) -> "pb.CaptionReply":
        try:
            window = _decode_window(
                req, (self.server.window,) + self.server.frame_shape)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        try:
            fut = self.server.submit(window,
                                     stream_id=req.stream_id or None)
        except RuntimeError as e:  # server closed
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except ValueError as e:  # wrong window shape for this server
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        timeout = float(req.timeout_s) or DEFAULT_TIMEOUT_S
        try:
            text = fut.result(timeout=timeout)
        except TimeoutError:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                          "caption timed out")
        except Exception as e:  # scheduler-side failure
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        if text is None:  # resolved-but-None == superseded
            return pb.CaptionReply(superseded=True, seq=req.seq)
        lat = fut.latency_s
        return pb.CaptionReply(caption=text, seq=req.seq,
                               latency_ms=0.0 if lat is None else lat * 1e3)

    def _caption_stream(self, request_iterator: Iterator["pb.CaptionRequest"],
                        context: Any) -> Iterator["pb.CaptionReply"]:
        """Bidi streaming: a reader thread drains the request iterator and
        submits each window (so client pushes are never blocked behind a
        pending decode — that's what makes supersession reachable); the
        handler generator awaits the futures IN ARRIVAL ORDER and yields a
        reply per window. One queue entry per request, ``None`` terminates.
        """
        default_sid = f"_grpc_rpc_{next(self._anon_rpc_counter)}"
        out_q: "queue.Queue[Optional[tuple]]" = queue.Queue()

        def reader() -> None:
            try:
                for req in request_iterator:
                    seq = int(req.seq)
                    try:
                        window = _decode_window(
                req, (self.server.window,) + self.server.frame_shape)
                        fut = self.server.submit(
                            window, stream_id=req.stream_id or default_sid)
                    except (ValueError, RuntimeError) as e:
                        out_q.put((seq, None, str(e)))
                        continue
                    out_q.put((seq, fut, None))
            except Exception as e:  # client cancel / transport error
                # seq=None: a STREAM-level failure belongs to no window —
                # the reply carries stream_error so a client correlating
                # by seq can't misattribute it to a real window
                out_q.put((None, None, f"stream read failed: {e}"))
            finally:
                out_q.put(None)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        while True:
            item = out_q.get()
            if item is None:
                break
            seq, fut, err = item
            if fut is None:
                if seq is None:  # stream-level transport failure
                    yield pb.CaptionReply(error=err, stream_error=True)
                else:            # per-window failure: echo its seq
                    yield pb.CaptionReply(error=err, seq=seq)
                continue
            try:
                text = fut.result(timeout=STREAM_WINDOW_TIMEOUT_S)
            except Exception as e:
                yield pb.CaptionReply(error=str(e), seq=seq)
                continue
            if text is None:
                yield pb.CaptionReply(superseded=True, seq=seq)
                continue
            lat = fut.latency_s
            yield pb.CaptionReply(
                caption=text, seq=seq,
                latency_ms=0.0 if lat is None else lat * 1e3)

    def _stats(self, req: "pb.StatsRequest", context: Any) -> "pb.StatsReply":
        reply = pb.StatsReply()
        for k, v in self.server.stats().items():
            reply.stats[k] = float(v)
        return reply

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "CaptionGRPCFrontend":
        self._grpc_server.start()
        return self

    def close(self, grace: float = 2.0) -> None:
        self._grpc_server.stop(grace).wait()

    def __enter__(self) -> "CaptionGRPCFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ client

class CaptionClient:
    """Minimal stub-free client for CaptionService (tests, load gens,
    Python edge boxes). External non-Python clients should codegen stubs
    from proto/caption.proto instead."""

    def __init__(self, target: str):
        _require_grpc()
        self._channel = grpc.insecure_channel(
            target, options=[
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ])
        self._caption = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Caption",
            request_serializer=pb.CaptionRequest.SerializeToString,
            response_deserializer=pb.CaptionReply.FromString)
        self._stream = self._channel.stream_stream(
            f"/{SERVICE_NAME}/CaptionStream",
            request_serializer=pb.CaptionRequest.SerializeToString,
            response_deserializer=pb.CaptionReply.FromString)
        self._stats = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Stats",
            request_serializer=pb.StatsRequest.SerializeToString,
            response_deserializer=pb.StatsReply.FromString)

    def caption(self, window: np.ndarray, *, stream_id: str = "",
                timeout_s: float = DEFAULT_TIMEOUT_S, seq: int = 0,
                compress: Optional[str] = None,
                quality: int = 90) -> "pb.CaptionReply":
        req = encode_window(window, stream_id=stream_id,
                            timeout_s=timeout_s, seq=seq,
                            compress=compress, quality=quality)
        return self._caption(req, timeout=timeout_s + 5.0)

    def caption_stream(self, windows: Iterable["pb.CaptionRequest"],
                       ) -> Iterator["pb.CaptionReply"]:
        """Open one CaptionStream RPC; yields one reply per sent window
        (arrival order). Build requests with ``encode_window``."""
        return self._stream(iter(windows))

    def stats(self) -> Dict[str, float]:
        return dict(self._stats(pb.StatsRequest(), timeout=10.0).stats)

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "CaptionClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv: Optional[list] = None) -> None:
    """Serve captions over gRPC (random weights unless --ckpt is given)."""
    import argparse

    from .serving import add_frontend_cli_args, server_from_frontend_args

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--max-workers", type=int, default=64,
                   help="concurrent-RPC cap; every live CaptionStream "
                        "pins one worker thread, so size above the "
                        "expected camera count plus unary headroom")
    add_frontend_cli_args(p)
    a = p.parse_args(argv)

    server = server_from_frontend_args(a)
    with CaptionGRPCFrontend(server, host=a.host, port=a.port,
                             max_workers=a.max_workers) as fe:
        print(f"serving gRPC on {a.host}:{fe.port}  "
              f"(rtvc.CaptionService/Caption|CaptionStream|Stats)",
              flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
    server.close()


if __name__ == "__main__":
    main()
