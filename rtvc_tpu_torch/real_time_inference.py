"""Real-time streaming captioning: ``rtvc_tpu/real_time_inference.py``.

Three threads, as in the JAX package:

- the **grabber** (the caller's thread) reads the camera or video source,
  keeps every 3rd frame (reference :44-54), shrinks it on the host
  (:func:`shrink_frame`) and puts each 6-frame window into a depth-1
  :class:`LatestSlot` (an older window is dropped: the captioner always
  works on the freshest clip);
- the **captioner** runs :class:`StreamingCaptioner`, the caption step of
  ``serving.make_caption_step`` at batch 1, warmed up at start so the
  first real window pays no set-up;
- the **display** loop never waits for a caption; it overlays the latest
  one (reference :64-70).

``run_realtime`` runs headless (``display=False``) on a video file; it
returns timing stats (captions/s, latency percentiles, source fps).
``cv2`` is imported inside the functions that read or show frames.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config import Config, cfg as default_cfg
from .models.student import StudentCandidateV1
from .serving import make_caption_step
from .utils.profiling import StepTimer

FRAME_KEEP_EVERY = 3   # reference real_time_inference.py:48
WINDOW = 6             # frames per caption (reference :56)
MAX_LEN = 25           # reference :58


def shrink_frame(frame: np.ndarray) -> np.ndarray:
    """Grabber-side shorter-edge-224 shrink (antialiased) + center crop
    before the host→device copy. The device preprocess then resizes by the
    identity and crops nothing, so the result is pixel-identical to
    shipping the uncropped shrink, at a quarter fewer bytes. Frames whose
    shorter edge is below 224 ship whole, so the device's upscale sees the
    full field of view."""
    import cv2

    h, w = frame.shape[:2]
    if min(h, w) > 224:
        scale = 224 / min(h, w)
        size = (int(round(w * scale)), int(round(h * scale)))
        frame = cv2.resize(frame, size, interpolation=cv2.INTER_AREA)
    h, w = frame.shape[:2]
    if min(h, w) == 224:
        top, left = (h - 224) // 2, (w - 224) // 2
        frame = frame[top:top + 224, left:left + 224]
    return frame


class LatestSlot:
    """Depth-1 handoff: the captioner always gets the newest window."""

    def __init__(self):
        self._cond = threading.Condition()
        self._item = None
        self._closed = False

    def put(self, item) -> None:
        with self._cond:
            self._item = item
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def get(self, timeout: float = 1.0):
        with self._cond:
            while self._item is None and not self._closed:
                self._cond.wait(timeout)
                if self._item is None and not self._closed:
                    return None
            if self._item is None:
                return None
            item, self._item = self._item, None
            return item


class StreamingCaptioner:
    """The greedy caption step at batch 1 over 6-frame uint8 windows."""

    def __init__(self, student: StudentCandidateV1, tokenizer,
                 max_len: int = MAX_LEN,
                 frame_shape: Optional[tuple] = None):
        self.student = student
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.device = next(student.parameters()).device
        self.timer = StepTimer("caption")
        self._step = make_caption_step(student, max_len=max_len)
        if frame_shape is not None:
            self.warmup(frame_shape)

    def warmup(self, frame_shape: tuple) -> None:
        dummy = torch.zeros((1, WINDOW) + tuple(frame_shape),
                            dtype=torch.uint8, device=self.device)
        self._step(dummy).cpu()

    def caption(self, window: np.ndarray) -> str:
        self.timer.start()
        tokens = self._step(torch.from_numpy(
            np.ascontiguousarray(window)[None]).to(self.device))
        tokens = tokens.cpu().numpy()  # waits for the card
        self.timer.stop()
        return self.tokenizer.decode(tokens[0], skip_special_tokens=True)


def run_realtime(config: Config = default_cfg, source: Any = 0,
                 student: Optional[StudentCandidateV1] = None,
                 tokenizer=None, display: bool = True,
                 max_captions: Optional[int] = None,
                 max_seconds: Optional[float] = None,
                 device="cuda") -> Dict[str, float]:
    """Camera/video streaming loop. Returns timing stats. Without a
    ``student``, the serving student (random weights from ``config.seed``)
    on ``device``."""
    import cv2

    if student is None:
        from .serving import build_serving_student
        student = build_serving_student(device=device, config=config)
    if tokenizer is None:
        from .tokenization import BertWordPieceTokenizer
        tokenizer = BertWordPieceTokenizer()

    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video source {source!r}")
    ret, probe = cap.read()
    if not ret:
        raise RuntimeError("video source yielded no frames")

    probe = shrink_frame(probe)
    captioner = StreamingCaptioner(student, tokenizer,
                                   frame_shape=probe.shape)

    slot = LatestSlot()
    stop = threading.Event()
    captions: List[str] = []
    latest_caption = [""]
    frames_seen = [1]

    def captioner_thread():
        while not stop.is_set():
            window = slot.get(timeout=0.25)
            if window is None:
                continue
            text = captioner.caption(window)
            latest_caption[0] = text
            captions.append(text)
            if max_captions and len(captions) >= max_captions:
                stop.set()

    worker = threading.Thread(target=captioner_thread, daemon=True)
    worker.start()

    window: List[np.ndarray] = [probe]  # probe counts as a kept frame
    counter = 0
    t_start = time.perf_counter()
    try:
        while not stop.is_set():
            ret, frame = cap.read()
            if not ret:
                break
            frames_seen[0] += 1
            counter += 1
            if counter == FRAME_KEEP_EVERY:   # keep every 3rd frame (:48)
                window.append(shrink_frame(frame))
                counter = 0
            if len(window) == WINDOW:         # caption per window (:56)
                slot.put(np.stack(window))
                window.clear()
            if display:
                font = cv2.FONT_HERSHEY_SIMPLEX
                text = latest_caption[0]
                size = cv2.getTextSize(text, font, 2, 6)[0]
                pos = ((frame.shape[1] - size[0]) // 2, frame.shape[0] - 40)
                cv2.putText(frame, text, pos, font, 2, (0, 0, 255), 6)
                cv2.imshow("Webcam Live with Caption", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            if max_seconds and time.perf_counter() - t_start > max_seconds:
                break
    finally:
        stop.set()
        slot.close()
        worker.join(timeout=5)
        cap.release()
        if display:
            cv2.destroyAllWindows()

    elapsed = time.perf_counter() - t_start
    stats = {
        "captions": float(len(captions)),
        "elapsed_s": elapsed,
        "captions_per_s": len(captions) / max(elapsed, 1e-9),
        "source_fps": frames_seen[0] / max(elapsed, 1e-9),
    }
    if captioner.timer.durations:
        stats.update(captioner.timer.summary())
    return stats


if __name__ == "__main__":
    import sys
    args = [a for a in sys.argv[1:] if a != "--headless"]
    headless = "--headless" in sys.argv[1:]
    src: Any = 0 if not args else args[0]
    if isinstance(src, str) and src.isdigit():
        src = int(src)
    print(run_realtime(source=src, display=not headless))
