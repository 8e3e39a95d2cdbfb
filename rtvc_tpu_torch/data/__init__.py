"""Data plumbing of the port: video decode (``video_handlers``, copies of
the JAX package's, and the content-aware ``frame_sampling`` samplers), the
caption dataset and its device loader (``dataset``), checkpoint I/O
(``io``), the teacher-output caches (``teacher_cache``)."""

from .dataset import CaptionDataset, DeviceLoader, collate_batch
from .frame_sampling import SAMPLERS
from .video_handlers import (
    get_evenly_sampled_frames,
    get_evenly_sampled_frames2,
    get_video_frames,
)

__all__ = [
    "get_video_frames",
    "get_evenly_sampled_frames",
    "get_evenly_sampled_frames2",
    "SAMPLERS",
    "CaptionDataset",
    "collate_batch",
    "DeviceLoader",
]
