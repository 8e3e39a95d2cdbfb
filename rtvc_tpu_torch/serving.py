"""The caption step and the batched multi-stream caption server.

Counterpart of ``rtvc_tpu/serving.py``:

- :func:`make_caption_step` maps a uint8 window batch to caption token rows:
  CLIP preprocess on the device, the TinyViT encode, and greedy decode
  (``beam=0``) or the student's beam search (``beam=K``), with the vocab
  projection on kernel K3 under ``vocab_int8``. It is the program behind
  every serving surface;
- :class:`BatchCaptionServer`: N streams share one card. ``submit(window,
  stream_id=...)`` returns a :class:`CaptionFuture`; a newer window from the
  same stream replaces its not-yet-scheduled predecessor (which resolves
  ``superseded``). One scheduler thread waits up to ``max_wait_ms`` after
  the first pending request for others, takes up to ``max_batch`` FIFO,
  pads the batch with zero windows to the next bucket size and runs the
  step at that shape. Greedy rows are independent and the all-rows-SEP stop
  only runs longer with more rows, so a row truncated at its first SEP is
  the same at any batch size; beam rows are fixed-shape. JAX compiles one
  program per bucket; here the buckets keep the shapes fixed, the
  condition for batched == solo and for a later CUDA graph;
- :func:`compress_window` / :func:`decode_compressed_frames`: JPEG/PNG
  frames for the network fronts (``serving_http``, ``serving_grpc``),
  with the decompression-bomb check; ``cv2`` is imported inside them;
- :func:`build_serving_student` (with :func:`load_student_weights`, also
  the evaluation entry points' model load), :func:`server_from_frontend_args`
  and the CLI demo (:func:`simulate_streams`, :func:`main`).

CLI demo (simulates N streams replaying one clip):

    python -m rtvc_tpu_torch.serving clip.mp4 --streams 8 --windows 32
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config, cfg as default_cfg
from .decode import student_beam, student_greedy, vlm_greedy
from .models.kimi_vl import KimiVLCaptioner
from .models.student import StudentCandidateV1
from .ops.preprocess import clip_preprocess
from .ops.quantization import quantize_vocab_head
from .utils.profiling import span

SEP_TOKEN_ID = 102  # BERT [SEP], the reference's stop token
STATS_WINDOW = 4096  # recent samples kept for latency/batch percentiles


def truncate_at_sep(row: np.ndarray, sep_id: int = SEP_TOKEN_ID) -> np.ndarray:
    """Tokens up to (excluding) the first SEP: the part of a greedy row that
    does not depend on which other rows shared its batch."""
    hits = np.nonzero(row == sep_id)[0]
    return row[: hits[0]] if hits.size else row


def with_vocab_w8(student: StudentCandidateV1) -> StudentCandidateV1:
    """Attach the weight-only int8 pack of the vocab projection
    (``student.vocab_w8``) for the ``vocab_int8`` caption step. The pack is
    made here, once per weight set, from the current ``linear`` weights."""
    student.vocab_w8 = quantize_vocab_head(student.linear)
    return student


def make_caption_step(student: StudentCandidateV1, *, max_len: int = 25,
                      beam: int = 0, crop_size: int = 224,
                      vocab_int8: bool = False, host_stop: bool = True
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step(frames_u8)`` maps uint8 ``[B, W, H, Wd, 3]`` frames (BGR, on
    the student's device) to int32 token rows: greedy ``[B, 1 + max_len]``
    (``beam=0``), or the best of ``beam`` beams, ``[B, max_len]``. Both
    start with CLS.

    ``vocab_int8`` runs the decode loop's vocab projection on kernel K3;
    the student must have been through :func:`with_vocab_w8`. Its logits
    move by about the int8 rounding, so its rows need not equal the default
    step's. ``host_stop`` goes to :func:`student_greedy`: the exported
    program (``export.py``) sets it to False, so that greedy reads nothing
    back. The step runs under its own ``torch.inference_mode()``, which
    is per thread, so any thread may call it."""
    if isinstance(student, KimiVLCaptioner):
        return _vlm_caption_step(student, max_len=max_len, beam=beam,
                                 vocab_int8=vocab_int8, host_stop=host_stop)
    if vocab_int8 and getattr(student, "vocab_w8", None) is None:
        raise ValueError("vocab_int8 needs a student from with_vocab_w8()")

    @torch.inference_mode()
    def step(frames_u8: torch.Tensor) -> torch.Tensor:
        with span("rtvc.caption.step"):
            b, w = frames_u8.shape[:2]
            with span("rtvc.caption.preprocess"):
                proc = clip_preprocess(
                    frames_u8.reshape((b * w,) + frames_u8.shape[2:]),
                    crop_size=crop_size)
                proc = proc.reshape((b, w) + proc.shape[1:])
            vocab_w8 = student.vocab_w8 if vocab_int8 else None
            if beam > 0:
                return student_beam(student, proc, max_len=max_len, k=beam,
                                    vocab_w8=vocab_w8)
            return student_greedy(student, proc, max_len=max_len,
                                  vocab_w8=vocab_w8, host_stop=host_stop)

    return step


def _vlm_caption_step(model: KimiVLCaptioner, *, max_len: int, beam: int,
                      vocab_int8: bool, host_stop: bool
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """:func:`make_caption_step` for the vision-language captioner: the
    frames preprocessed at the model's size and normalisation, then
    :func:`decode.vlm_greedy` to ``max_len`` new tokens. Rows are the
    generated ids alone, ``[B, max_len]`` (no leading CLS). One call at a
    time: on a card, calls of one batch size share that shape's latent
    caches and decode graphs."""
    if beam or vocab_int8 or not host_stop:
        raise ValueError("the vision-language captioner decodes greedily, "
                         "with the bf16 head and a host stop")

    @torch.inference_mode()
    def step(frames_u8: torch.Tensor) -> torch.Tensor:
        with span("rtvc.caption.step"):
            b, w = frames_u8.shape[:2]
            with span("rtvc.caption.preprocess"):
                proc = clip_preprocess(
                    frames_u8.reshape((b * w,) + frames_u8.shape[2:]),
                    crop_size=model.image_size, mean=model.pixel_mean,
                    std=model.pixel_std)
                proc = proc.reshape((b, w) + proc.shape[1:])
            return vlm_greedy(model, proc, max_new_tokens=max_len)

    return step


class CaptionFuture:
    """Result handle for one submitted window."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._resolve_lock = threading.Lock()
        self._text: Optional[str] = None
        self._tokens: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self.superseded = False
        self.submit_time = time.perf_counter()
        self.done_time: Optional[float] = None

    def _resolve(self, text: Optional[str], tokens: Optional[np.ndarray],
                 *, superseded: bool = False,
                 error: Optional[BaseException] = None) -> None:
        # the first resolution wins: if close() errors a future out after
        # its join timed out, a still-running scheduler pass cannot change
        # a result a client already read
        with self._resolve_lock:
            if self._event.is_set():
                return
            self._text = text
            self._tokens = tokens
            self.superseded = superseded
            self._error = error
            self.done_time = time.perf_counter()
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Optional[str]:
        """Caption text; ``None`` if superseded by a newer same-stream
        window. Raises on server-side errors / timeout."""
        if not self._event.wait(timeout):
            raise TimeoutError("caption not ready")
        if self._error is not None:
            raise self._error
        return self._text

    def tokens(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        if not self._event.wait(timeout):
            raise TimeoutError("caption not ready")
        if self._error is not None:
            raise self._error
        return self._tokens

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_time is None:
            return None
        return self.done_time - self.submit_time


class _Request:
    __slots__ = ("window", "future", "stream_id")

    def __init__(self, window: np.ndarray, stream_id: Optional[str]):
        self.window = window
        self.future = CaptionFuture()
        self.stream_id = stream_id


def compress_window(window: np.ndarray, *, fmt: str = ".jpg",
                    quality: int = 90) -> List[bytes]:
    """[window, H, W, 3] uint8 -> one JPEG/PNG blob per frame (client side).
    ``fmt=".png"`` is lossless, so a PNG submission captions exactly as the
    raw one. Decode side: :func:`decode_compressed_frames`."""
    import cv2
    window = np.ascontiguousarray(window, np.uint8)
    if window.ndim != 4 or window.shape[-1] != 3:
        raise ValueError(f"expected [window, H, W, 3], got {window.shape}")
    params = ([int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
              if fmt in (".jpg", ".jpeg") else [])
    blobs = []
    for frame in window:
        ok, buf = cv2.imencode(fmt, frame, params)
        if not ok:
            raise ValueError(f"cv2.imencode({fmt!r}) failed")
        blobs.append(buf.tobytes())
    return blobs


def decode_compressed_frames(
        blobs: Sequence[bytes],
        expect_shape: Optional[Tuple[int, ...]] = None) -> np.ndarray:
    """JPEG/PNG per-frame blobs -> [window, H, W, 3] uint8 (server side),
    BGR as ``cv2.imdecode`` gives it, like the raw path's frames.

    ``expect_shape`` — the server's ``(window, H, W, 3)`` — makes this
    decompression-bomb safe: a tiny constant-colour PNG can decode at more
    than 1000:1, so a wrong blob count is rejected before decoding anything
    and a wrong frame shape after decoding ONE frame, never the whole
    window."""
    import cv2
    if not blobs:
        raise ValueError("no frames in compressed window")
    expect_frame = None
    if expect_shape is not None:
        if len(blobs) != expect_shape[0]:
            raise ValueError(
                f"{len(blobs)} encoded frames but server window is "
                f"{expect_shape[0]}")
        expect_frame = tuple(expect_shape[1:])
    frames = []
    for i, blob in enumerate(blobs):
        if not blob:
            # cv2.imdecode asserts (cv2.error, not ValueError) on an empty
            # buffer; the fronts answer ValueError with a 400
            raise ValueError(f"frame {i}: zero-length encoded frame")
        try:
            img = cv2.imdecode(np.frombuffer(blob, np.uint8),
                               cv2.IMREAD_COLOR)
        except cv2.error as e:
            raise ValueError(f"frame {i}: not a decodable JPEG/PNG image "
                             f"({e})")
        if img is None:
            raise ValueError(f"frame {i}: not a decodable JPEG/PNG image")
        if expect_frame is not None and img.shape != expect_frame:
            raise ValueError(
                f"frame {i} decodes to {img.shape}, server expects "
                f"{expect_frame}")
        frames.append(img)
    shapes = {f.shape for f in frames}
    if len(shapes) != 1:
        raise ValueError(
            f"frames in one window disagree on shape: {sorted(shapes)}")
    return np.stack(frames)


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return tuple(out)


class BatchCaptionServer:
    """Batches caption requests from many streams into one caption step.

    Parameters
    ----------
    student, tokenizer:
        the student (its weights, on its device) and the tokenizer that
        turns token rows into text; or the vision-language captioner
        (``models.kimi_vl``), whose rows are cut at its EOS, and None for
        the tokenizer while its files are not at hand: futures then give
        ``tokens()`` and no text.
    max_batch:
        largest batch one step processes.
    max_wait_ms:
        scheduler linger after the first pending request, the
        latency/throughput knob. 0 = dispatch immediately; a few ms lets
        concurrent streams coalesce into full batches.
    beam:
        0 decodes greedily; K>0 runs the fixed-shape beam search
        (``decode.student_beam``) in the same bucketed step.
    buckets:
        batch sizes the step runs at; requests are padded up to the next.
    frame_shape:
        (H, W, 3) of incoming uint8 frames; all streams must agree (resize
        on the client side, ``real_time_inference.shrink_frame``).
    vocab_int8:
        the vocab projection on K3; the int8 pack is made here, once (for
        each replica).
    mesh:
        optional ``parallel.make_mesh(..., devices=[...])`` over devices of
        this process, with a ``dp`` axis: the student is copied once to
        each of its dp devices (a replica per device, the first the
        student itself where it lies there), ``max_batch`` and every
        bucket are rounded up to multiples of dp, and each batch is split
        into dp equal chunks, chunk i run through replica i's caption
        step and the rows concatenated (rows are independent, so N
        devices serve ~N× the streams). Replicas on distinct devices run
        concurrently, one thread each; replicas that share a device run
        in turn.
    """

    def __init__(self, student: StudentCandidateV1, tokenizer: Any, *,
                 max_batch: int = 8, max_wait_ms: float = 4.0,
                 max_len: int = 25, beam: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 frame_shape: Tuple[int, int, int] = (224, 224, 3),
                 window: int = 6, warmup: bool = True,
                 vocab_int8: bool = False, mesh: Any = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.student = student
        self.tokenizer = tokenizer
        self.stop_id = int(getattr(student, "eos_token_id", SEP_TOKEN_ID))
        self.vocab_int8 = bool(vocab_int8)
        self.mesh = mesh
        self._dp = int(mesh.shape.get("dp", 1)) if mesh is not None else 1
        if self._dp > 1:
            from .parallel.mesh import replicate
            # round max_batch up so the largest bucket splits evenly
            max_batch = -(-int(max_batch) // self._dp) * self._dp
            self.replicas = replicate(student, mesh)
        else:
            self.replicas = [student]
        if self.vocab_int8:
            for replica in self.replicas:
                with_vocab_w8(replica)
        self.device = next(student.parameters()).device
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_len = int(max_len)
        self.beam = int(beam)  # 0 = greedy; K>0 = fixed-shape beam search
        self.buckets = tuple(sorted(buckets)) if buckets else \
            default_buckets(self.max_batch)
        if self._dp > 1:
            # every bucket must split evenly over dp
            self.buckets = tuple(sorted(
                {-(-b // self._dp) * self._dp for b in self.buckets}))
        if self.buckets[-1] < self.max_batch:
            raise ValueError("largest bucket must cover max_batch")
        self.frame_shape = tuple(frame_shape)
        self.window = int(window)

        # [B, W, H, Wd, 3] uint8 -> caption rows, at a bucket's batch size
        # (a replica's: the bucket / dp)
        self._steps = [make_caption_step(
            replica, max_len=self.max_len, beam=self.beam,
            vocab_int8=self.vocab_int8) for replica in self.replicas]
        self._step = self._steps[0]
        devices = {str(next(r.parameters()).device) for r in self.replicas}
        self._pool = None
        if len(devices) > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=len(self.replicas))

        self._lock = threading.Condition()
        # FIFO arrival with O(1) per-stream replacement; anonymous requests
        # get a key of their own
        self._pending: "OrderedDict[Any, _Request]" = OrderedDict()
        self._anon_counter = 0
        self._closed = False
        self._stats_lock = threading.Lock()
        # bounded windows of recent samples; totals are scalar counters
        self.batch_sizes: "deque[int]" = deque(maxlen=STATS_WINDOW)
        self.latencies_s: "deque[float]" = deque(maxlen=STATS_WINDOW)
        # submit → taken by the scheduler, a sample a request
        self.queue_waits_s: "deque[float]" = deque(maxlen=STATS_WINDOW)
        self._n_batches = 0
        self._batch_rows_total = 0
        self._served = 0
        self._superseded = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

        if warmup:
            self.warmup()

        self._thread = threading.Thread(target=self._scheduler_loop,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ API

    def _place(self, frames_np: np.ndarray):
        """Host batch -> the student's device, or one chunk on each
        replica's device."""
        if self._dp > 1:
            from .parallel.mesh import shard_batch
            return shard_batch(frames_np, self.mesh)
        return torch.from_numpy(frames_np).to(self.device)

    def _run(self, frames_np: np.ndarray) -> np.ndarray:
        """A padded host batch -> its caption rows on the host."""
        with span("rtvc.serve.place"):
            placed = self._place(frames_np)
        if self._dp == 1:
            rows = self._step(placed)
            with span("rtvc.serve.readback"):
                return rows.cpu().numpy()

        def run(i):
            rows = self._steps[i](placed[i])
            with span("rtvc.serve.readback"):
                return rows.cpu().numpy()

        if self._pool is not None:
            parts = list(self._pool.map(run, range(self._dp)))
        else:
            parts = [run(i) for i in range(self._dp)]
        return np.concatenate(parts)

    def warmup(self) -> None:
        """Run every bucket once, so that no live request pays for the
        first call at a shape (cuDNN plans, the allocator, kernel builds)."""
        for b in self.buckets:
            dummy = np.zeros((b, self.window) + self.frame_shape, np.uint8)
            self._run(dummy)

    def submit(self, window: np.ndarray,
               stream_id: Optional[str] = None) -> CaptionFuture:
        """Enqueue one [window, H, W, 3] uint8 clip. Thread-safe."""
        window = np.asarray(window)
        expect = (self.window,) + self.frame_shape
        if window.shape != expect:
            raise ValueError(f"window shape {window.shape} != {expect}")
        req = _Request(window, stream_id)
        with self._lock:
            if self._closed:
                raise RuntimeError("server closed")
            if stream_id is not None:
                old = self._pending.pop(stream_id, None)
                if old is not None:
                    old.future._resolve(None, None, superseded=True)
                    with self._stats_lock:
                        self._superseded += 1
                key: Any = stream_id
            else:
                self._anon_counter += 1
                key = ("_anon", self._anon_counter)
            self._pending[key] = req
            self._lock.notify()
        return req.future

    def stats(self) -> Dict[str, float]:
        """Counters, and percentiles over the last ``STATS_WINDOW``
        requests of the latency (submit → resolved) and the queue wait
        (submit → taken by the scheduler); for a captioner with routed
        experts, ``expert_load_max_over_mean`` (its counters, read from the
        card here)."""
        extra: Dict[str, float] = {}
        if hasattr(self.student, "expert_load"):
            load = self.student.expert_load().double()
            if load.sum() > 0:
                extra["expert_load_max_over_mean"] = float(
                    (load.max(1).values / load.mean(1)).max())
        with self._stats_lock:
            out: Dict[str, float] = {
                "served": float(self._served),
                "superseded": float(self._superseded),
                "batches": float(self._n_batches),
                "mean_batch": (self._batch_rows_total /
                               max(self._n_batches, 1)),
            }
            for name, window in (("latency", self.latencies_s),
                                 ("queue_wait", self.queue_waits_s)):
                if window:
                    ordered = sorted(window)
                    out[f"{name}_p50_ms"] = ordered[len(ordered) // 2] * 1e3
                    out[f"{name}_p95_ms"] = ordered[
                        int(len(ordered) * 0.95) if len(ordered) > 1
                        else 0] * 1e3
            if (self._t_first is not None and self._t_last is not None
                    and self._t_last > self._t_first):
                out["throughput_windows_per_s"] = (
                    self._served / (self._t_last - self._t_first))
            out.update(extra)
            return out

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        with self._lock:
            for req in self._pending.values():
                req.future._resolve(None, None,
                                    error=RuntimeError("server closed"))
            self._pending.clear()

    def __enter__(self) -> "BatchCaptionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ scheduler

    def _take_batch(self) -> List[_Request]:
        """Block until work exists, linger max_wait_ms for coalescing, then
        take up to max_batch requests FIFO."""
        with self._lock:
            if not self._pending and not self._closed:
                with span("rtvc.serve.wait"):
                    while not self._pending and not self._closed:
                        self._lock.wait(0.1)
            if self._closed and not self._pending:
                return []
            if (self.max_wait_s > 0 and len(self._pending) < self.max_batch
                    and not self._closed):
                with span("rtvc.serve.linger"):
                    deadline = time.perf_counter() + self.max_wait_s
                    while (len(self._pending) < self.max_batch
                           and not self._closed):
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._lock.wait(remaining)
            batch: List[_Request] = []
            while self._pending and len(batch) < self.max_batch:
                _, req = self._pending.popitem(last=False)
                batch.append(req)
        taken = time.perf_counter()
        with self._stats_lock:
            self.queue_waits_s.extend(taken - req.future.submit_time
                                      for req in batch)
        return batch

    def _scheduler_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                with self._lock:
                    if self._closed and not self._pending:
                        return
                continue
            try:
                # the batch's work stays inline: moved into a method, whose
                # locals (the host batch) go at each return, the server ran
                # at half speed under torch.profiler, for reasons not found
                with span("rtvc.serve.batch"):
                    n = len(batch)
                    bucket = next(b for b in self.buckets if b >= n)
                    with span("rtvc.serve.assemble"):
                        frames = np.zeros(
                            (bucket, self.window) + self.frame_shape,
                            np.uint8)
                        for i, req in enumerate(batch):
                            with span("rtvc.serve.row"):
                                frames[i] = req.window
                    tokens = self._run(frames)
                    now = time.perf_counter()
                    with self._stats_lock:
                        self.batch_sizes.append(n)
                        self._n_batches += 1
                        self._batch_rows_total += n
                        if self._t_first is None:
                            self._t_first = now
                        self._t_last = now
                        self._served += n
                    with span("rtvc.serve.resolve"):
                        for i, req in enumerate(batch):
                            row = truncate_at_sep(tokens[i], self.stop_id)
                            text = None if self.tokenizer is None else \
                                self.tokenizer.decode(
                                    row, skip_special_tokens=True)
                            req.future._resolve(text, row)
                            with self._stats_lock:
                                lat = req.future.latency_s
                                if lat is not None:
                                    self.latencies_s.append(lat)
            except Exception as e:  # resolve rather than wedge clients
                for req in batch:
                    if not req.future.done():
                        req.future._resolve(None, None, error=e)


# ---------------------------------------------------------------- CLI demo

def add_frontend_cli_args(p) -> None:
    """The CLI surface of the network front's main (which adds its own
    --port)."""
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (rtvc_tpu_torch.data.io layout); "
                        "random init if omitted")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=4.0)
    p.add_argument("--beam", type=int, default=0,
                   help="0 = greedy; K>0 = batch beam search width K")
    p.add_argument("--frame-size", type=int, default=224,
                   help="expected square frame edge of incoming windows")
    p.add_argument("--device", default="cuda",
                   help="the student's device (cpu for a run without a "
                        "card)")


def load_student_weights(student: StudentCandidateV1,
                         ckpt: str) -> StudentCandidateV1:
    """Load the checkpoint's weights without its distillation heads
    (``data.io.load_kd_student_params``) into ``student``, in place. Every
    entry must fit the student, and every entry of the student but the
    heads' must be in the checkpoint."""
    from .data.io import DISTILL_HEADS, load_kd_student_params

    sd = load_kd_student_params(ckpt)["state_dict"]
    missing, unexpected = student.load_state_dict(sd, strict=False)
    stray = [k for k in missing if k.split(".", 1)[0] not in DISTILL_HEADS]
    if unexpected or stray:
        raise ValueError(f"checkpoint {ckpt!r} does not fit the student: "
                         f"missing {stray}, unexpected {unexpected}")
    return student


def build_serving_student(ckpt: Optional[str] = None, device="cuda",
                          config: Config = default_cfg
                          ) -> StudentCandidateV1:
    """The serving student in ``config.dtype``, in eval mode, on
    ``device``: random weights from ``torch.Generator().manual_seed(
    config.seed)``, then, with ``ckpt``, the checkpoint's weights
    (:func:`load_student_weights`) in a student built with the GELU
    variant its sidecar records (``student_matching_checkpoint``). The one
    model-load block of every serving and evaluation surface."""
    from .models.student import (random_init_, student_from_config,
                                 student_matching_checkpoint)

    if ckpt:
        student = student_matching_checkpoint(config, ckpt, device="cpu")
    else:
        student = student_from_config(config, device="cpu")
    random_init_(student, torch.Generator().manual_seed(config.seed))
    if ckpt:
        load_student_weights(student, ckpt)
    return student.to(device, config.dtype).eval()


def server_from_frontend_args(a) -> BatchCaptionServer:
    """build_serving_student + the BatchCaptionServer behind a network
    front (serving_http.main, serving_grpc.main)."""
    from .real_time_inference import WINDOW
    from .tokenization import BertWordPieceTokenizer

    student = build_serving_student(a.ckpt, device=a.device)
    return BatchCaptionServer(
        student, BertWordPieceTokenizer(),
        max_batch=a.max_batch, max_wait_ms=a.max_wait_ms, beam=a.beam,
        frame_shape=(a.frame_size, a.frame_size, 3), window=WINDOW)


def simulate_streams(source: str, *, n_streams: int = 8,
                     windows_per_stream: int = 16, max_batch: int = 8,
                     max_wait_ms: float = 4.0, beam: int = 0,
                     config: Config = default_cfg,
                     device="cuda") -> Dict[str, float]:
    """Replay one clip as N concurrent streams against a fresh server
    (random weights) and report the serving stats."""
    import cv2

    from .real_time_inference import WINDOW, shrink_frame
    from .tokenization import BertWordPieceTokenizer

    student = build_serving_student(device=device, config=config)

    # pull windows from the source once; every stream replays them
    cap = cv2.VideoCapture(source)
    frames: List[np.ndarray] = []
    while len(frames) < WINDOW * windows_per_stream:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(shrink_frame(frame))
    cap.release()
    if len(frames) < WINDOW:
        raise RuntimeError(f"source {source!r} too short")
    wins = [np.stack(frames[i:i + WINDOW])
            for i in range(0, len(frames) - WINDOW + 1, WINDOW)]

    server = BatchCaptionServer(
        student, BertWordPieceTokenizer(),
        max_batch=max_batch, max_wait_ms=max_wait_ms, beam=beam,
        frame_shape=wins[0].shape[1:])

    results: List[Optional[str]] = []
    res_lock = threading.Lock()

    def stream_worker(sid: int) -> None:
        for j in range(windows_per_stream):
            fut = server.submit(wins[j % len(wins)], stream_id=f"s{sid}")
            text = fut.result(timeout=120)
            with res_lock:
                results.append(text)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=stream_worker, args=(s,))
               for s in range(n_streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stats = server.stats()
    server.close()
    stats["wall_s"] = wall
    stats["streams"] = float(n_streams)
    stats["windows_per_s_wall"] = len(results) / wall
    return stats


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("source", help="video file replayed by every stream")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--windows", type=int, default=16,
                   help="windows per stream")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=4.0)
    p.add_argument("--beam", type=int, default=0,
                   help="0 = greedy; K>0 = batch beam search width K")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    stats = simulate_streams(a.source, n_streams=a.streams,
                             windows_per_stream=a.windows,
                             max_batch=a.max_batch,
                             max_wait_ms=a.max_wait_ms, beam=a.beam,
                             device=a.device)
    for k, v in sorted(stats.items()):
        print(f"{k:28s} {v:.3f}" if isinstance(v, float) else f"{k} {v}")


if __name__ == "__main__":
    main()
