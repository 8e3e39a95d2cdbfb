"""Disk caches of the frozen teacher's outputs, replayed across epochs.

Counterpart of ``rtvc_tpu/data/teacher_cache.py``. The teacher is frozen
and the loaders pair each video with one fixed caption for the whole run
(the caption choice is seeded), so the teacher-forced logits of a (video,
caption) pair, and the teacher's beam search over a video, are the same in
every epoch: computed once, they are replayed from disk after that, and
the teacher leaves the steady-state step.

The files are numpy's, with the JAX package's names and keys, so a cache
directory written by either package replays in the other:

- :class:`TeacherLogitsCache`: one ``.npy`` of float32 logits ``[T, V]``
  per (vid_id, caption_id) key, or with ``top_k = K`` one ``.topK.npz`` of
  each position's K largest logits and their vocab indices;
- :class:`TeacherBeamCache`: one ``.npz`` per vid_id holding the beam's
  ``predictions`` and, with ``store_consensus``, the beam-consensus logit
  rows (``kd``, or ``kd_vals`` / ``kd_idx`` at top-K), the beam's
  hyperparameters in the file name;
- writes go to a temporary name and are renamed into place; an entry that
  cannot be read is a miss; an optional byte budget evicts the least
  recently used entries.

:class:`CacheReplayFeed` reads the next batch's entries on a producer
thread and starts their copy to the card on a side stream while the
current step runs; :func:`densify_topk` rebuilds the dense logits from a
top-K pair on the device, inside the step.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _sanitize(key: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in key)


def _compress_topk(logits: np.ndarray, top_k: int):
    """Dense ``[..., V]`` → (top-k values, indices). One implementation for
    both caches and for their miss and hit paths, so miss- and hit-epoch
    steps see the same truncated distribution."""
    logits = np.asarray(logits, dtype=np.float32)
    k = min(top_k, logits.shape[-1])
    idx = np.argpartition(logits, -k, axis=-1)[..., -k:]
    vals = np.take_along_axis(logits, idx, axis=-1)
    return vals.astype(np.float32), idx.astype(np.int32)


def _atomic_save(path: str, save_fn) -> None:
    """Write to a temporary name, then rename: a reader (the replay feed's
    producer thread) never sees a half-written entry, and a kill mid-write
    leaves no corrupt one. The temporary name carries the process and the
    thread, so two writers of one key never share it."""
    tmp = path + f".tmp{os.getpid()}_{threading.get_ident()}"
    try:
        save_fn(tmp)
        # np.save / np.savez append .npy / .npz to names without them
        written = tmp if os.path.exists(tmp) else next(
            t for t in (tmp + ".npy", tmp + ".npz") if os.path.exists(t))
        os.replace(written, path)
    except BaseException:
        for t in (tmp, tmp + ".npy", tmp + ".npz"):
            try:
                os.remove(t)
            except OSError:
                pass
        raise


def _load_or_none(path: str, loader):
    """An entry that is evicted, still being written or corrupt is a miss
    (recomputed and rewritten), never a crash."""
    import zipfile

    try:
        return loader(path)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _touch(paths: Sequence[str]) -> None:
    for path in paths:  # LRU recency
        try:
            os.utime(path, None)
        except OSError:
            pass


class TeacherLogitsCache:
    """Teacher-forced logits per (video, caption) pair. ``top_k = 0``:
    full-vocab rows, replayed exactly (bfloat16 logits widen to float32
    without loss). ``top_k = K``: each position's K largest logits and
    their indices, replayed as the renormalised top-K distribution
    (:func:`densify_topk`); exact only when K covers the vocabulary."""

    def __init__(self, cache_dir: str, max_bytes: Optional[int] = None,
                 top_k: int = 0):
        self.cache_dir = cache_dir
        self.max_bytes = max_bytes
        self.top_k = int(top_k)
        os.makedirs(cache_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        # K is part of the name: a run at another K misses and recomputes
        # instead of replaying rows cut at the old K
        ext = f".top{self.top_k}.npz" if self.top_k else ".npy"
        return os.path.join(self.cache_dir, _sanitize(key) + ext)

    @staticmethod
    def key(vid_id, caption_id) -> str:
        return f"{vid_id}__{caption_id}"

    def get_batch(self, keys: Sequence[str]):
        """If every key hits (a partial batch recomputes whole): the stacked
        ``[B, T, V]`` float32 logits, or at top-K the pair (values ``[B, T,
        K]``, indices ``[B, T, K]``); else None."""
        rows: List[np.ndarray] = []
        idx_rows: List[np.ndarray] = []
        for key in keys:
            path = self._path(key)
            if self.top_k:
                def _ld(p):
                    with np.load(p) as z:
                        return z["values"], z["indices"]
                pair = _load_or_none(path, _ld)
                if pair is None:
                    self.misses += len(keys)
                    return None
                rows.append(pair[0])
                idx_rows.append(pair[1])
            else:
                row = _load_or_none(path, np.load)
                if row is None:
                    self.misses += len(keys)
                    return None
                rows.append(row)
        self.hits += len(keys)
        _touch([self._path(k) for k in keys])
        if self.top_k:
            return np.stack(rows), np.stack(idx_rows)
        return np.stack(rows)

    def compress(self, logits: np.ndarray):
        """Dense ``[..., V]`` → this cache's top-K pair (no I/O: the miss
        path replays through it, as a hit would)."""
        return _compress_topk(logits, self.top_k)

    def put_batch(self, keys: Sequence[str], logits) -> None:
        logits = np.asarray(logits, dtype=np.float32)
        for key, row in zip(keys, logits):
            if self.top_k:
                vals, idx = self.compress(row)
                _atomic_save(self._path(key),
                             lambda p: np.savez(p, values=vals, indices=idx))
            else:
                _atomic_save(self._path(key), lambda p: np.save(p, row))
        _evict_lru(self.cache_dir, self.max_bytes)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses}


class TeacherBeamCache:
    """The teacher's beam-search targets per video: the beam never sees the
    caption, so the key is the vid_id alone. An entry holds the beam's
    ``predictions`` row (loss 5's teacher tokens) and, with
    ``store_consensus``, the per-word beam-consensus logit rows ``[S, V]``
    (or their top-K pair, as :class:`TeacherLogitsCache`). The beam's
    size, steps and length penalty are part of the file name: another beam
    misses."""

    def __init__(self, cache_dir: str, max_bytes: Optional[int] = None,
                 top_k: int = 0, *, beam_size: int = 4, max_steps: int = 15,
                 length_penalty: float = 0.6, store_consensus: bool = True):
        self.cache_dir = cache_dir
        self.max_bytes = max_bytes
        self.top_k = int(top_k)
        self.beam_size = int(beam_size)
        self.max_steps = int(max_steps)
        self.length_penalty = float(length_penalty)
        self.store_consensus = bool(store_consensus)
        os.makedirs(cache_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        lp = f"{self.length_penalty:g}".replace(".", "p").replace("-", "m")
        tag = (f".beam{self.beam_size}x{self.max_steps}lp{lp}"
               + (f".top{self.top_k}" if self.top_k else "")
               + ("" if self.store_consensus else ".toks"))
        return os.path.join(self.cache_dir, _sanitize(key) + tag + ".npz")

    @staticmethod
    def key(vid_id) -> str:
        return str(vid_id)

    def get_batch(self, keys: Sequence[str]
                  ) -> Optional[Dict[str, np.ndarray]]:
        """If every key hits: ``predictions [B, max_steps]`` and, storing
        consensus targets, ``kd [B, S, V]`` float32 (or ``kd_vals`` /
        ``kd_idx [B, S, K]`` at top-K); else None."""
        preds: List[np.ndarray] = []
        kd: List[np.ndarray] = []
        kd_idx: List[np.ndarray] = []
        for key in keys:
            def _ld(p):
                with np.load(p) as z:
                    if not self.store_consensus:
                        return (z["predictions"],)
                    if self.top_k:
                        return z["predictions"], z["kd_vals"], z["kd_idx"]
                    return z["predictions"], z["kd"]
            entry = _load_or_none(self._path(key), _ld)
            if entry is None:
                self.misses += len(keys)
                return None
            preds.append(entry[0])
            if self.store_consensus:
                kd.append(entry[1])
                if self.top_k:
                    kd_idx.append(entry[2])
        self.hits += len(keys)
        _touch([self._path(k) for k in keys])
        out = {"predictions": np.stack(preds)}
        if self.store_consensus:
            if self.top_k:
                out["kd_vals"] = np.stack(kd)
                out["kd_idx"] = np.stack(kd_idx)
            else:
                out["kd"] = np.stack(kd)
        return out

    def compress(self, kd_logits: np.ndarray):
        """Dense ``[..., V]`` → this cache's top-K pair (see
        :meth:`TeacherLogitsCache.compress`)."""
        return _compress_topk(kd_logits, self.top_k)

    def put_batch(self, keys: Sequence[str], predictions,
                  kd_logits=None) -> None:
        predictions = np.asarray(predictions, dtype=np.int32)
        if self.store_consensus:
            if kd_logits is None:
                raise ValueError(
                    "store_consensus cache needs kd_logits in put_batch")
            kd_logits = np.asarray(kd_logits, dtype=np.float32)
        for i, key in enumerate(keys):
            if not self.store_consensus:
                arrays = {"predictions": predictions[i]}
            elif self.top_k:
                vals, idx = self.compress(kd_logits[i])
                arrays = {"predictions": predictions[i],
                          "kd_vals": vals, "kd_idx": idx}
            else:
                arrays = {"predictions": predictions[i], "kd": kd_logits[i]}
            _atomic_save(self._path(key),
                         lambda p, a=arrays: np.savez(p, **a))
        _evict_lru(self.cache_dir, self.max_bytes)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses}


def _evict_lru(cache_dir: str, max_bytes: Optional[int]) -> None:
    if max_bytes is None:
        return
    entries = []
    total = 0
    for fn in os.listdir(cache_dir):
        if ".tmp" in fn:  # a write in flight on another thread
            continue
        path = os.path.join(cache_dir, fn)
        try:
            st = os.stat(path)
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, path))
        total += st.st_size
    entries.sort()  # oldest first
    for _, size, path in entries:
        if total <= max_bytes:
            break
        try:
            os.remove(path)
            total -= size
        except OSError:
            pass


class CacheReplayFeed:
    """A batch loader's batches, with the teacher caches' entries for each
    read on a producer thread one or more batches ahead.

    On a hit the entries go into page-locked host tensors and are copied to
    ``device`` (the card unless the caller asks for ``"cpu"``) without
    blocking on a side CUDA stream; the batch carries an event recorded
    after those copies, and the consumer's stream waits on it before the
    batch is handed out, so the step never reads a half-copied tensor while
    the copies overlap the running step. On the CPU the entries are handed
    out as they are.

    Each batch dict gains:

    - ``_cache_keys`` (with a logits cache) and, on a hit,
      ``teacher_logits`` (float32), or ``teacher_topk_vals`` /
      ``teacher_topk_idx`` at top-K;
    - ``_beam_cache_keys`` (with a ``beam_cache``) and, on a hit,
      ``teacher_beam_predictions`` (int32) and, storing consensus targets,
      ``teacher_kd_logits`` or ``teacher_kd_vals`` / ``teacher_kd_idx``.

    On a miss nothing is added: the consumer runs the live teacher. A
    consumer that abandons the iteration stops and reaps the producer.

    ``mesh`` (``parallel.make_mesh`` over the ranks of a process group,
    dp > 1), as JAX's feed shards its hits over dp: each hit's rows are
    cut to this rank's dp share before the copy, on the mesh's device,
    where they split evenly over dp; the keys stay the batch's. A loader
    that already yields this rank's rows (a ``DeviceLoader`` with
    ``host_slice`` or ``mesh``) keeps its hits whole, as JAX leaves a
    multi-process run's host-local rows."""

    def __init__(self, loader, cache: Optional[TeacherLogitsCache] = None,
                 depth: int = 2,
                 beam_cache: Optional[TeacherBeamCache] = None,
                 device="cuda", mesh=None):
        self.loader = loader
        self.cache = cache
        self.beam_cache = beam_cache
        self.depth = depth
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        local = (getattr(loader, "host_slice", None) is not None
                 or getattr(loader, "mesh", None) is not None)
        self._dp = (mesh.shape.get("dp", 1)
                    if mesh is not None and mesh.distributed and not local
                    else 1)

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's dp share of a hit's rows (all of them where they do
        not split evenly)."""
        if self._dp == 1 or x.shape[0] % self._dp:
            return x
        per = x.shape[0] // self._dp
        i = self.mesh.index("dp")
        return x[i * per:(i + 1) * per]

    def __iter__(self):
        on_card = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if on_card else None
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        errbox: List[BaseException] = []
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

        def upload(x: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(self._rows(x)))
            if not on_card:
                return t
            with torch.cuda.stream(stream):
                return t.pin_memory().to(self.device, non_blocking=True)

        def producer():
            try:
                for batch in self.loader:
                    out = dict(batch)
                    if self.cache is not None:
                        if "vid-id" not in batch or "caption-id" not in batch:
                            raise ValueError(
                                "teacher_cache needs 'vid-id' and "
                                "'caption-id' in each batch")
                        keys = [self.cache.key(v, c) for v, c in
                                zip(batch["vid-id"], batch["caption-id"])]
                        out["_cache_keys"] = keys
                        cached = self.cache.get_batch(keys)
                        if cached is not None:
                            if self.cache.top_k:
                                vals, idx = cached
                                out["teacher_topk_vals"] = upload(vals)
                                out["teacher_topk_idx"] = upload(idx)
                            else:
                                out["teacher_logits"] = upload(cached)
                    if self.beam_cache is not None:
                        if "vid-id" not in batch:
                            raise ValueError(
                                "teacher_beam_cache needs 'vid-id' in each "
                                "batch")
                        bkeys = [self.beam_cache.key(v)
                                 for v in batch["vid-id"]]
                        out["_beam_cache_keys"] = bkeys
                        bhit = self.beam_cache.get_batch(bkeys)
                        if bhit is not None:
                            out["teacher_beam_predictions"] = upload(
                                bhit["predictions"])
                            if "kd_vals" in bhit:
                                out["teacher_kd_vals"] = upload(
                                    bhit["kd_vals"])
                                out["teacher_kd_idx"] = upload(
                                    bhit["kd_idx"])
                            elif "kd" in bhit:
                                out["teacher_kd_logits"] = upload(bhit["kd"])
                    if on_card:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                        out["_uploaded"] = ready
                    if not put_q(out):
                        return
            except BaseException as e:  # surfaced on the consumer side
                errbox.append(e)
            finally:
                put_q(sentinel)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="cache-replay-producer")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if errbox:
                        raise errbox[0]
                    return
                ready = item.pop("_uploaded", None)
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for v in item.values():
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            # freed only once the consumer's work is done
                            v.record_stream(consumer)
                yield item
        finally:
            # on exhaustion and when the consumer abandons the generator
            # mid-epoch: unblock and reap the producer
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)


def densify_topk(values: torch.Tensor, indices: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Dense ``[B, T, V]`` float32 logits from a top-K pair ``[B, T, K]``:
    every entry not stored sits 100 below its row's max, so its softmax
    probability is below e^-100 (a float32 subnormal) and the losses see
    the renormalised top-K distribution."""
    values = values.float()
    b, t, _ = values.shape
    fill = values.amax(dim=-1, keepdim=True) - 100.0
    dense = fill.expand(b, t, vocab_size).contiguous()
    return dense.scatter_(-1, indices.long(), values)
