"""Host-side video frame extraction (reference src/utils/video_handlers.py).

A copy of ``rtvc_tpu/data/video_handlers.py``: importing ``rtvc_tpu``
imports jax. Its code is unchanged but for ``import cv2``, which each
function that decodes video makes where it runs, so the package imports
without OpenCV. tests/test_torch_data.py holds the copy equal to the
original.

Same public surface as the reference's 8-function library, reimplemented:
decode stays on host CPU (OpenCV's C++ core — the right place for codec
work), while all pixel math that used to be per-frame numpy here is batched
and pushed through the preprocessing on the device
(``ops.preprocess.clip_preprocess``) by the dataset layer.

Functions mirror reference names/semantics (video_handlers.py:7-320):
frame grabs, evenly-spaced sampling (sequential-grab and seek variants),
resize/grayscale/downsample variants, and the feature-enhancement filters
(gaussian+laplacian sharpen, histogram equalization, unsharp mask,
contrast stretch). Failure semantics preserved: a failed read truncates the
returned frame list (video_handlers.py:64-67).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np


def get_video_frames(video_path: str) -> np.ndarray:
    """All frames of a video as [N, H, W, 3] BGR uint8."""
    import cv2
    video = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ret, frame = video.read()
        if not ret:
            break
        frames.append(frame)
    video.release()
    return np.array(frames)


def get_evenly_sampled_frames(video_path: str, num_frames: int) -> np.ndarray:
    """``num_frames`` evenly spaced frames via sequential grab/decode.

    Index selection matches the reference (video_handlers.py:56-60):
    stride = frame_count // num_frames, first ``num_frames`` indices.
    Decodes only the selected frames; grabs (no decode) the rest.
    """
    import cv2
    video = cv2.VideoCapture(video_path)
    frame_count = video.get(cv2.CAP_PROP_FRAME_COUNT)
    stride = max(int(frame_count) // num_frames, 1)
    indices = np.arange(0, frame_count, stride, dtype=np.int64)[:num_frames]
    wanted = set(indices.tolist())
    frames = []
    for i in range(int(indices[-1]) + 1):
        if i in wanted:
            ret, frame = video.read()
            if not ret:
                break
            frames.append(frame)
        else:
            if not video.grab():
                break
    video.release()
    return np.array(frames)


def get_evenly_sampled_frames2(video_path: str, num_frames: int) -> np.ndarray:
    """Seek-based variant (video_handlers.py:75-104)."""
    import cv2
    video = cv2.VideoCapture(video_path)
    frame_count = video.get(cv2.CAP_PROP_FRAME_COUNT)
    stride = max(int(frame_count) // num_frames, 1)
    indices = np.arange(0, frame_count, stride, dtype=np.int64)[:num_frames]
    frames = []
    for idx in indices:
        video.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ret, frame = video.read()
        if ret:
            frames.append(frame)
    video.release()
    return np.array(frames)


def get_video_frames_with_resize(video_path: str, width_resize_ratio: float,
                                 height_resize_ratio: float) -> np.ndarray:
    """All frames resized by per-axis ratios (video_handlers.py:107-145)."""
    import cv2
    video = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ret, frame = video.read()
        if not ret:
            break
        h, w = frame.shape[:2]
        frame = cv2.resize(frame, (int(w * width_resize_ratio),
                                   int(h * height_resize_ratio)))
        frames.append(frame)
    video.release()
    return np.array(frames)


def get_video_frames_with_rgb_to_gray(video_path: str) -> np.ndarray:
    """All frames converted to grayscale (video_handlers.py:148-180)."""
    import cv2
    video = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ret, frame = video.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    video.release()
    return np.array(frames)


def get_video_frames_with_downsample(video_path: str,
                                     downsample_rate: int) -> np.ndarray:
    """Every ``downsample_rate``-th frame (video_handlers.py:183-219)."""
    import cv2
    video = cv2.VideoCapture(video_path)
    frames = []
    i = 0
    while True:
        ret, frame = video.read()
        if not ret:
            break
        if i % downsample_rate == 0:
            frames.append(frame)
        i += 1
    video.release()
    return np.array(frames)


def get_video_frames_with_resize_and_downsample(
        video_path: str, width_resize_ratio: float,
        height_resize_ratio: float, downsample_rate: int) -> np.ndarray:
    """Combined resize + temporal downsample (video_handlers.py:222-249)."""
    import cv2
    video = cv2.VideoCapture(video_path)
    frames = []
    i = 0
    while True:
        ret, frame = video.read()
        if not ret:
            break
        if i % downsample_rate == 0:
            h, w = frame.shape[:2]
            frame = cv2.resize(frame, (int(w * width_resize_ratio),
                                       int(h * height_resize_ratio)))
            frames.append(frame)
        i += 1
    video.release()
    return np.array(frames)


def enhance_frame_features(frames: np.ndarray,
                           method: str = "sharpen") -> np.ndarray:
    """Feature-enhancement filters (video_handlers.py:252-320): 'sharpen'
    (gaussian blur + laplacian edge add), 'hist_eq' (per-channel histogram
    equalization), 'unsharp' (unsharp masking), 'contrast' (min-max
    stretch)."""
    import cv2
    out = []
    for frame in frames:
        if method == "sharpen":
            blur = cv2.GaussianBlur(frame, (3, 3), 0)
            lap = cv2.Laplacian(blur, cv2.CV_16S, ksize=3)
            sharp = np.clip(frame.astype(np.int32)
                            - lap.astype(np.int32), 0, 255)
            out.append(sharp.astype(np.uint8))
        elif method == "hist_eq":
            if frame.ndim == 2:
                out.append(cv2.equalizeHist(frame))
            else:
                chans = [cv2.equalizeHist(frame[..., c]) for c in range(3)]
                out.append(np.stack(chans, axis=-1))
        elif method == "unsharp":
            blur = cv2.GaussianBlur(frame, (9, 9), 10.0)
            out.append(cv2.addWeighted(frame, 1.5, blur, -0.5, 0))
        elif method == "contrast":
            lo, hi = float(frame.min()), float(frame.max())
            scale = 255.0 / max(hi - lo, 1.0)
            out.append(((frame.astype(np.float32) - lo) * scale)
                       .clip(0, 255).astype(np.uint8))
        else:
            raise ValueError(f"unknown enhancement {method!r}")
    return np.array(out)


def main(argv: Optional[list] = None) -> np.ndarray:
    """CLI dispatch like the reference's (video_handlers.py:323-399)."""
    parser = argparse.ArgumentParser(description="video frame extraction")
    parser.add_argument("--video_path", required=True)
    parser.add_argument("--function", default="get_video_frames",
                        choices=["get_video_frames",
                                 "get_evenly_sampled_frames",
                                 "get_evenly_sampled_frames2",
                                 "get_video_frames_with_resize",
                                 "get_video_frames_with_rgb_to_gray",
                                 "get_video_frames_with_downsample",
                                 "get_video_frames_with_resize_and_downsample"])
    parser.add_argument("--num_frames", type=int, default=6)
    parser.add_argument("--width_resize_ratio", type=float, default=0.5)
    parser.add_argument("--height_resize_ratio", type=float, default=0.5)
    parser.add_argument("--downsample_rate", type=int, default=2)
    args = parser.parse_args(argv)

    fn = args.function
    if fn == "get_video_frames":
        frames = get_video_frames(args.video_path)
    elif fn == "get_evenly_sampled_frames":
        frames = get_evenly_sampled_frames(args.video_path, args.num_frames)
    elif fn == "get_evenly_sampled_frames2":
        frames = get_evenly_sampled_frames2(args.video_path, args.num_frames)
    elif fn == "get_video_frames_with_resize":
        frames = get_video_frames_with_resize(
            args.video_path, args.width_resize_ratio, args.height_resize_ratio)
    elif fn == "get_video_frames_with_rgb_to_gray":
        frames = get_video_frames_with_rgb_to_gray(args.video_path)
    elif fn == "get_video_frames_with_downsample":
        frames = get_video_frames_with_downsample(args.video_path,
                                                  args.downsample_rate)
    else:
        frames = get_video_frames_with_resize_and_downsample(
            args.video_path, args.width_resize_ratio,
            args.height_resize_ratio, args.downsample_rate)
    print(f"{fn}: {frames.shape}")
    return frames


if __name__ == "__main__":
    main()
