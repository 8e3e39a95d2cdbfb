"""Content-aware frame samplers (reference src/utils/frame_sampling_methods.py).

A copy of ``rtvc_tpu/data/frame_sampling.py``: importing ``rtvc_tpu``
imports jax. Its code is unchanged but for ``import cv2``, which each
function that decodes video makes where it runs, so the package imports
without OpenCV. tests/test_torch_data.py holds the copy equal to the
original.

Six strategies with the reference's semantics (frame_sampling_methods.py:
39-297), reimplemented host-side; the k-means for clustered sampling is a
small numpy Lloyd's loop (no sklearn dependency on the hot path), seeded for
determinism like the reference's RANDOM_STATE=42.

All samplers take a video path and return [N, H, W, 3] uint8 RGB frames
(the reference converted BGR→RGB inside each sampler).
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

import numpy as np

D_TYPE = np.uint8
RANDOM_STATE = 42


def _read_all_rgb(video_path: str) -> np.ndarray:
    import cv2
    video = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ret, frame = video.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    video.release()
    return np.array(frames, dtype=D_TYPE)


def play_video_from_frames(frames: np.ndarray, fps: int) -> None:
    """Playback helper (frame_sampling_methods.py:10-36); requires a GUI."""
    import cv2
    for frame in frames:
        frame = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
        cv2.imshow("Video", frame)
        if cv2.waitKey(1000 // fps) & 0xFF == ord("q"):
            break
    cv2.destroyAllWindows()


def uniform_sampling(video_path: str, retention_rate: float) -> np.ndarray:
    """Keep every ``1/retention_rate``-th frame (:39-77)."""
    import cv2
    video = cv2.VideoCapture(video_path)
    num_frames = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
    num_retained = max(int(num_frames * retention_rate), 1)
    interval = max(num_frames // num_retained, 1)
    retained = []
    for i in range(num_frames):
        ret, frame = video.read()
        if ret and i % interval == 0:
            retained.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    video.release()
    return np.array(retained, dtype=D_TYPE)


def random_sampling_from_bins(video_path: str, num_bins: int) -> np.ndarray:
    """One random frame per temporal bin (:80-132); subsequence-ordered."""
    frames = _read_all_rgb(video_path)
    n = len(frames)
    if n == 0:
        return frames
    rng = np.random.default_rng(RANDOM_STATE)
    edges = np.linspace(0, n, num_bins + 1, dtype=np.int64)
    picks = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi > lo:
            picks.append(int(rng.integers(lo, hi)))
    return frames[np.array(sorted(picks))]


def _kmeans(x: np.ndarray, k: int, iters: int = 25,
            seed: int = RANDOM_STATE) -> np.ndarray:
    """Tiny Lloyd's k-means; returns per-row labels."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    labels = np.zeros(len(x), np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = d.argmin(1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(len(centers)):
            members = x[labels == c]
            if len(members):
                centers[c] = members.mean(0)
    return labels


def clustered_sampling(video_path: str, num_clusters: int,
                       downsample: int = 8) -> np.ndarray:
    """K-means over downsampled flattened frames; emit a frame whenever the
    cluster assignment changes along the timeline (:135-198)."""
    import cv2
    frames = _read_all_rgb(video_path)
    if len(frames) == 0:
        return frames
    small = np.stack([
        cv2.resize(f, (f.shape[1] // downsample, f.shape[0] // downsample))
        for f in frames
    ]).reshape(len(frames), -1).astype(np.float32)
    labels = _kmeans(small, num_clusters)
    keep = [0]
    for i in range(1, len(labels)):
        if labels[i] != labels[i - 1]:
            keep.append(i)
    return frames[np.array(keep)]


def frame_mse_difference_sampling(video_path: str,
                                  mse_threshold: float) -> np.ndarray:
    """Keep frames whose MSE vs the previous KEPT frame exceeds the
    threshold (:201-244)."""
    frames = _read_all_rgb(video_path)
    if len(frames) == 0:
        return frames
    keep = [0]
    last = frames[0].astype(np.float32)
    for i in range(1, len(frames)):
        cur = frames[i].astype(np.float32)
        mse = float(np.mean((cur - last) ** 2))
        if mse > mse_threshold:
            keep.append(i)
            last = cur
    return frames[np.array(keep)]


def scene_change_detection_sampling(video_path: str,
                                    hist_threshold: float) -> np.ndarray:
    """Keep frames whose histogram chi-square distance vs the previous kept
    frame exceeds the threshold (:247-297)."""
    import cv2
    frames = _read_all_rgb(video_path)
    if len(frames) == 0:
        return frames

    def hist(f):
        h = cv2.calcHist([f], [0, 1, 2], None, [8, 8, 8],
                         [0, 256, 0, 256, 0, 256])
        return cv2.normalize(h, h).flatten()

    keep = [0]
    last = hist(frames[0])
    for i in range(1, len(frames)):
        cur = hist(frames[i])
        dist = cv2.compareHist(last, cur, cv2.HISTCMP_CHISQR)
        if dist > hist_threshold:
            keep.append(i)
            last = cur
    return frames[np.array(keep)]


SAMPLERS: Dict[str, Callable] = {
    "uniform": uniform_sampling,
    "bins": random_sampling_from_bins,
    "clustered": clustered_sampling,
    "mse": frame_mse_difference_sampling,
    "scene": scene_change_detection_sampling,
}


def main(argv: Optional[list] = None) -> np.ndarray:
    """CLI dispatch (frame_sampling_methods.py:300-397)."""
    parser = argparse.ArgumentParser(description="content-aware samplers")
    parser.add_argument("--video_path", required=True)
    parser.add_argument("--function", default="uniform",
                        choices=sorted(SAMPLERS))
    parser.add_argument("--retention_rate", type=float, default=0.5)
    parser.add_argument("--num_bins", type=int, default=10)
    parser.add_argument("--num_clusters", type=int, default=5)
    parser.add_argument("--mse_threshold", type=float, default=100.0)
    parser.add_argument("--hist_threshold", type=float, default=0.5)
    parser.add_argument("--play", action="store_true")
    parser.add_argument("--fps", type=int, default=30)
    args = parser.parse_args(argv)

    fn = args.function
    if fn == "uniform":
        frames = uniform_sampling(args.video_path, args.retention_rate)
    elif fn == "bins":
        frames = random_sampling_from_bins(args.video_path, args.num_bins)
    elif fn == "clustered":
        frames = clustered_sampling(args.video_path, args.num_clusters)
    elif fn == "mse":
        frames = frame_mse_difference_sampling(args.video_path,
                                               args.mse_threshold)
    else:
        frames = scene_change_detection_sampling(args.video_path,
                                                 args.hist_threshold)
    print(f"{fn}: {frames.shape}")
    if args.play:
        play_video_from_frames(frames, args.fps)
    return frames


if __name__ == "__main__":
    main()
