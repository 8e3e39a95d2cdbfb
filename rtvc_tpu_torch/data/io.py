"""Checkpoint I/O: the inference half of ``rtvc_tpu/data/io.py``.

A checkpoint is a directory holding ``checkpoint.pt``: a ``torch.save``d
dict whose ``state_dict`` is the student's state dict in the reference's
key layout (``image_encoder.model.*``, ``decoder.layers.*``, ``embed``,
``linear``, the distillation heads), its tensors on the CPU, plus whatever
else the caller stores beside it. Orbax is replaced, not copied: the port
reads none of the JAX package's checkpoints, and the JAX package none of
the port's (both reach the same weights through the weight bridge,
``models.convert``).

- :func:`save_checkpoint` / :func:`restore_checkpoint`, with the
  ``<path>.meta.json`` sidecar (:func:`checkpoint_meta`) the JAX package
  writes beside a checkpoint;
- :func:`strip_distillation_heads` / :func:`load_kd_student_params`: the
  reference's ``load_kd_student_model`` (io.py:8-35), which drops the
  distillation-only heads (``projectors.*``, ``upsample``, ``project``,
  ``project_decoder``: JAX's ``_DISTILL_HEADS``) for inference;
- :func:`load_pruned_params`: the reference's ``load_pruned_model``
  (io.py:38-64); a pruned checkpoint holds its masks applied;
- :func:`latest_checkpoint`: the newest ``ckpt*`` directory of a run;
- :class:`AsyncCheckpointSaver`: the train loop's background writer.
  Unlike JAX arrays, torch tensors change in place, so each ``save`` copies
  every tensor to the host before its thread starts (into page-locked
  buffers it keeps and reuses for the next save), and only the disk write
  runs beside the next steps.

A train-state checkpoint (``train.train_state_tree``) holds the float32
master weights and the BatchNorm statistics as ``state_dict``, so the
evaluation entry points read it as they read any checkpoint, beside
Adam's ``opt_state`` and the ``step``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch

CHECKPOINT_FILE = "checkpoint.pt"
DISTILL_HEADS = ("projectors", "upsample", "project", "project_decoder")


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, tree: Mapping[str, Any], force: bool = True,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``tree`` (e.g. ``{"state_dict": model.state_dict()}``) to the
    directory ``path``, every tensor copied to the CPU first. ``force``
    replaces an existing checkpoint; without it an existing one raises.
    ``meta``: small JSON-able facts about how the weights were produced
    (e.g. which GELU variant the encoder was trained with), stored as the
    sidecar ``<path>.meta.json``."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not force:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(_to_host(dict(tree)), os.path.join(path, CHECKPOINT_FILE))
    if meta:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """Sidecar metadata written by ``save_checkpoint(meta=...)``; ``{}``
    for checkpoints without one."""
    sidecar = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(sidecar):
        return {}
    with open(sidecar) as f:
        return json.load(f)


class AsyncCheckpointSaver:
    """Background checkpoint writer: one save in flight at a time, so
    checkpoints land in order; an error surfaces on the next ``save`` or
    ``wait`` instead of being swallowed. ``wait_s`` sums the seconds the
    caller spent blocked on an earlier save, ``snapshot_s`` those spent
    copying to the host."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._snapshot: Dict[tuple, torch.Tensor] = {}
        self.wait_s = 0.0
        self.snapshot_s = 0.0

    def _host_copy(self, tree: Any, key: tuple = ()) -> Any:
        """``tree`` with every tensor copied into this saver's host buffer
        for its place in the tree (page-locked for a card tensor, the copy
        issued without waiting)."""
        if isinstance(tree, torch.Tensor):
            t = tree.detach()
            buf = self._snapshot.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
                self._snapshot[key] = buf
            buf.copy_(t, non_blocking=t.is_cuda)
            return buf
        if isinstance(tree, Mapping):
            return {k: self._host_copy(v, key + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._host_copy(v, key + (i,))
                              for i, v in enumerate(tree))
        return tree

    def save(self, path: str, tree: Mapping[str, Any], force: bool = True,
             on_done: Optional[Callable[[], None]] = None,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot ``tree`` to the host now, then write it on a worker
        thread; joins any still-running previous write first. ``on_done()``
        runs on the worker after a successful write (e.g. pruning stale
        checkpoints)."""
        self.wait()
        t0 = time.perf_counter()
        host = self._host_copy(dict(tree))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()  # the copies landed
        self.snapshot_s += time.perf_counter() - t0

        def work() -> None:
            try:
                save_checkpoint(path, host, force=force, meta=meta)
                if on_done is not None:
                    on_done()
            except BaseException as e:  # re-raised on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, name="ckpt-save",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) finishes; re-raise its
        error on this thread."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self.wait_s += time.perf_counter() - t0
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The dict :func:`save_checkpoint` wrote, its tensors on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)


def strip_distillation_heads(state_dict: Mapping[str, Any]
                             ) -> Dict[str, Any]:
    """Drop the projector/upsample/project/project_decoder entries
    (reference io.py:27-34 deleted the same attributes for inference)."""
    return {k: v for k, v in state_dict.items()
            if k.split(".", 1)[0] not in DISTILL_HEADS}


def load_kd_student_params(ckpt_path: str) -> Dict[str, Any]:
    """Load a distillation checkpoint and return it with an
    inference-ready ``state_dict`` (distillation heads removed)."""
    tree = restore_checkpoint(ckpt_path)
    sd = tree["state_dict"] if "state_dict" in tree else tree
    out = dict(tree) if "state_dict" in tree else {"state_dict": sd}
    out["state_dict"] = strip_distillation_heads(sd)
    return out


def load_pruned_params(ckpt_path: str) -> Dict[str, Any]:
    """Load a pruned checkpoint (``pruning.main`` wrote it with the masks
    already applied to the weights, reference pruning.py:52-53 + io.py:48-62):
    :func:`load_kd_student_params`' tree."""
    return load_kd_student_params(ckpt_path)


def latest_checkpoint(run_dir: str) -> Optional[str]:
    """The newest checkpoint directory under a run directory (the reference
    globbed ``results/run/<name>/*.ckpt``, inference.py:29-32)."""
    if not os.path.isdir(run_dir):
        return None
    # directories only: a checkpoint's ``.meta.json`` sidecar also starts
    # with "ckpt" and is written last, so a file match would win on mtime
    cands = [os.path.join(run_dir, d) for d in os.listdir(run_dir)
             if d.startswith("ckpt")
             and os.path.isdir(os.path.join(run_dir, d))]
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)
