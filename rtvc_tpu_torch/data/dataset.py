"""Caption dataset and the loader that feeds it to the card.

Counterpart of ``rtvc_tpu/data/dataset.py``, with the reference's item
semantics (reference src/utils/dataloader.py:35-114):

- :func:`load_labels` reads the labels CSV (``image_id,id,caption,split``)
  with the ``csv`` module into a :class:`LabelsTable`, plus the
  encoded-captions pickle. No pandas: the card's machine has none;
- :class:`CaptionDataset`: one caption per video, chosen as pandas'
  ``Series.sample(n=1, random_state=r)`` chooses it, its pre-encoded ids,
  and ``num_frames`` evenly sampled raw uint8 BGR frames
  (:func:`load_clip_frames`, ``.mp4`` through OpenCV or ``.npy``
  ``[N, H, W, 3]`` uint8 clips). It takes a :class:`LabelsTable` or a
  pandas DataFrame with the same columns;
- :func:`collate_batch`: frames stacked, captions right-padded with 0 to
  a fixed bucket (40), so every full batch has one shape;
- :class:`DeviceLoader`: a producer thread assembles host batches (decode
  + collate, optionally over a spawn process pool); the consumer copies
  each batch to the device and runs ``clip_preprocess`` there, once per
  batch, while the producer works on the next; a consumer that leaves a
  pass early stops and reaps its producer. With a ``mesh`` it hands out
  this rank's dp rows of each batch, on the rank's device.
"""

from __future__ import annotations

import csv
import os
import pickle
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..ops.preprocess import clip_preprocess
from .video_handlers import get_evenly_sampled_frames


def load_clip_frames(data_path: str, vid_id: str,
                     num_frames: int) -> np.ndarray:
    """Decode one clip's evenly-sampled frames (module-level so a process
    pool can run it; touches only cv2/numpy — safe in worker processes)."""
    mp4 = os.path.join(data_path, vid_id + ".mp4")
    npy = os.path.join(data_path, vid_id + ".npy")
    if os.path.exists(mp4):
        raw = get_evenly_sampled_frames(mp4, num_frames)
    elif os.path.exists(npy):
        clip = np.load(npy)
        stride = max(len(clip) // num_frames, 1)
        raw = clip[np.arange(0, len(clip), stride)[:num_frames]]
    else:
        raise FileNotFoundError(f"no clip for {vid_id} in {data_path}")
    # redundant second stride subsample, preserved (dataloader.py:78)
    n = raw.shape[0]
    idx = np.arange(0, n, max(n // num_frames, 1))[:num_frames]
    return raw[idx]


def _typed(values: List[str]) -> list:
    """A CSV column as ints where every value is one (pandas reads such a
    column as int64), else as the strings."""
    try:
        return [int(v) for v in values]
    except ValueError:
        return values


class LabelsTable:
    """The labels CSV in row order: ``columns[name]`` is a column's values
    (``image_id``, ``id``, ``caption``, ``split``), integer columns as
    ints. Answers the two questions the loaders ask of the DataFrame that
    JAX's ``load_labels`` returns."""

    def __init__(self, columns: Dict[str, list]):
        self.columns = columns

    @classmethod
    def read_csv(cls, path: str) -> "LabelsTable":
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
            names = reader.fieldnames or []
        return cls({n: _typed([r[n] for r in rows]) for n in names})

    def __len__(self) -> int:
        return len(self.columns["image_id"])

    def caption_ids(self, vid_id: str) -> list:
        """The ``id`` of every row of ``vid_id``, in row order:
        ``data.loc[data["image_id"] == vid_id, "id"]``."""
        return [c for v, c in zip(self.columns["image_id"],
                                  self.columns["id"]) if v == vid_id]

    def video_ids(self, split: str) -> list:
        """The videos of ``split`` in first-seen order:
        ``data.loc[data["split"] == split, "image_id"].unique()``."""
        seen = {v: None for v, s in zip(self.columns["image_id"],
                                        self.columns["split"]) if s == split}
        return list(seen)


def sample_one(ids: Sequence, random_state: Optional[int]):
    """``pandas.Series(ids).sample(n=1, random_state=random_state)``'s
    value: position ``RandomState(r).choice(len(ids), 1, replace=False)``,
    unseeded (numpy's global state, as pandas) when ``random_state`` is
    None."""
    rs = (np.random if random_state is None
          else np.random.RandomState(random_state))
    return ids[int(rs.choice(len(ids), 1, replace=False)[0])]


class CaptionDataset:
    """Video → (frames, encoded caption) items (dataloader.py:35-82)."""

    def __init__(self, data_path: str, vid_ids: Sequence[str], data,
                 encoded_caption_data: Dict[Any, Sequence[int]],
                 num_frames: int = 6,
                 random_state: Optional[int] = None):
        self.data_path = data_path
        self.vid_ids = list(vid_ids)
        # a LabelsTable, or a pandas DataFrame with columns [image_id, id]
        self.data = data
        self.num_frames = num_frames
        self.random_state = random_state
        self.encoded_caption_data = encoded_caption_data

    def __len__(self) -> int:
        return len(self.vid_ids)

    def _caption_ids(self, vid_id: str) -> list:
        if isinstance(self.data, LabelsTable):
            return self.data.caption_ids(vid_id)
        return list(self.data.loc[self.data["image_id"] == vid_id, "id"])

    def item_meta(self, idx: int) -> Dict[str, Any]:
        """Caption lookup only (no frame decode): the process-pool path
        keeps the seeded caption choice in the parent, so the worker count
        never changes which caption pairs with which video."""
        vid_id = self.vid_ids[idx]
        caption_id = sample_one(self._caption_ids(vid_id), self.random_state)
        encoded = np.asarray(self.encoded_caption_data[caption_id], np.int32)
        return {"caption": encoded, "caption-id": caption_id,
                "vid-id": vid_id}

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        meta = self.item_meta(idx)
        frames = load_clip_frames(self.data_path, meta["vid-id"],
                                  self.num_frames)
        return {"frames": frames, **meta}


def collate_batch(items: List[Dict[str, Any]],
                  max_text_len: int = 40) -> Dict[str, Any]:
    """Static-shape collate: frames stacked [B, F, H, W, 3] uint8, captions
    right-padded with 0 to the FIXED bucket (not batch max). Caption ids /
    vid ids pass through as lists."""
    frames = np.stack([it["frames"] for it in items])
    caps = np.zeros((len(items), max_text_len), np.int32)
    for i, it in enumerate(items):
        ids = np.asarray(it["caption"], np.int32)[:max_text_len]
        caps[i, :len(ids)] = ids
    return {
        "frames": frames,
        "caption": caps,
        "caption-id": [it["caption-id"] for it in items],
        "vid-id": [it["vid-id"] for it in items],
    }


class DeviceLoader:
    """Double-buffered host → device batch feeder.

    A background thread assembles host batches (video decode + collate);
    the consumer copies each to ``device`` and, with ``preprocess``, runs
    ``clip_preprocess`` on its ``[B·F, H, W, 3]`` uint8 frames, giving
    float32 ``[B, F, 224, 224, 3]`` (else the uint8 frames as they are),
    and the captions as an int32 tensor on ``device``.

    - ``shuffle``: each epoch's order is ``np.random.default_rng(seed +
      epoch)``'s shuffle; the epoch counts up per ``__iter__`` unless
      :meth:`set_epoch` pins it;
    - ``drop_last`` (default False, as torch's DataLoader): keep the
      ragged last batch;
    - ``num_workers > 0`` decodes a batch's clips in a spawn process pool;
      captions are still chosen in the parent;
    - ``host_slice=(start, stop)``: ``batch_size`` is the global batch and
      this loader yields rows ``[start:stop)`` of each global batch (needs
      ``drop_last``, so that every host runs the same number of steps);
    - ``mesh`` (``parallel.make_mesh`` over the ranks of a process group):
      each batch's rows are cut to this rank's dp share before the copy
      and the preprocess (``parallel.shard_batch``: ``frames``,
      ``caption`` and the id lists alike), on the rank's device, which
      replaces ``device``; a batch that does not split over dp raises.

    ``wait_s`` is the time the consumer spent blocked on the producer's
    queue during the latest pass.
    """

    def __init__(self, dataset: CaptionDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 max_text_len: int = 40, mesh=None,
                 preprocess: bool = True, prefetch_depth: int = 2,
                 drop_last: bool = False, num_workers: int = 0,
                 host_slice: Optional[tuple] = None, device="cuda"):
        if mesh is not None and not mesh.distributed \
                and mesh.shape.get("dp", 1) > 1:
            raise ValueError("DeviceLoader(mesh=...) feeds one rank of a "
                             "process group; this mesh spans devices of one "
                             "process")
        if host_slice is not None and not drop_last:
            raise ValueError("host_slice (multi-host) requires drop_last: "
                             "every global batch window must be full so all "
                             "hosts agree on the step count")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.max_text_len = max_text_len
        self.preprocess = preprocess
        self.prefetch_depth = prefetch_depth
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.host_slice = host_slice
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else device
        self.wait_s = 0.0
        self._pool = None
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch index the NEXT ``__iter__`` shuffles with (torch
        ``DistributedSampler.set_epoch`` convention); without a call the
        counter goes up by one per pass."""
        self._epoch = int(epoch)

    def _decode_pool(self):
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: the parent holds CUDA state and threads;
            # children run only load_clip_frames (cv2/numpy)
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn"))
        return self._pool

    def close(self) -> None:
        """Shut down the decode process pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "DeviceLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _host_batches(self, epoch: int) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            if self.host_slice is not None:
                idxs = idxs[self.host_slice[0]:self.host_slice[1]]
            if self.num_workers > 0:
                metas = [self.dataset.item_meta(int(i)) for i in idxs]
                futures = [self._decode_pool().submit(
                    load_clip_frames, self.dataset.data_path,
                    self.dataset.vid_ids[int(i)], self.dataset.num_frames)
                    for i in idxs]
                items = [meta | {"frames": fut.result()}
                         for meta, fut in zip(metas, futures)]
            else:
                items = [self.dataset[int(i)] for i in idxs]
            yield collate_batch(items, self.max_text_len)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        errbox: List[BaseException] = []
        # the epoch is read before the producer starts, which shuffles
        # with it
        epoch = self._epoch
        self._epoch += 1

        stop = threading.Event()  # set when the consumer abandons us

        def put_q(item) -> bool:
            """stop-aware bounded put; False = the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._host_batches(epoch):
                    if not put_q(batch):
                        return
            except BaseException as e:  # surfaced on the consumer side
                errbox.append(e)
            finally:
                put_q(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        self.wait_s = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                batch = q.get()
                self.wait_s += time.perf_counter() - t0
                if batch is sentinel:
                    if errbox:
                        raise errbox[0]
                    return
                if self.mesh is not None:
                    from ..parallel.mesh import shard_batch
                    batch = shard_batch(batch, self.mesh)
                out = dict(batch)
                frames = torch.as_tensor(batch["frames"]).to(self.device)
                if self.preprocess:
                    b, f = frames.shape[:2]
                    proc = clip_preprocess(
                        frames.reshape((-1,) + frames.shape[2:]))
                    frames = proc.reshape((b, f) + proc.shape[1:])
                out["frames"] = frames
                out["caption"] = torch.as_tensor(batch["caption"]).to(
                    self.device)
                yield out
        finally:
            # a consumer that stops early (train() reads one batch of a
            # pass before its loop) must not leave the producer blocked
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)


def load_labels(captions_path: str, encoded_path: str):
    """The labels CSV as a :class:`LabelsTable` and the encoded-captions
    pickle (reference train.py:170-172). The pickle is the repository's
    own data file: unpickling runs whatever it holds."""
    data = LabelsTable.read_csv(captions_path)
    with open(encoded_path, "rb") as f:
        encoded = pickle.load(f)
    return data, encoded
