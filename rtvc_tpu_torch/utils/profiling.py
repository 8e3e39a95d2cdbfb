"""Step timers, trace regions and the program's spans:
``rtvc_tpu/utils/profiling.py``, plus :func:`span`.

``StepTimer.stop(sync_on=...)`` waits for the card before it reads the
clock (``torch.cuda.synchronize`` on the device of each CUDA tensor in
``sync_on``), as JAX's waits on ``block_until_ready``; a timer made with
``window=N`` keeps its newest N samples. ``profile_trace``
wraps a region in a ``torch.profiler`` trace (JAX: a ``jax.profiler``
trace) and writes it into ``logdir`` as a Chrome trace (open it in
``chrome://tracing`` or Perfetto).

:func:`span` marks a part of the program as a ``torch.profiler`` range,
so that it lands in the same trace as the operators and kernels, on the
profiler's clock. It is on exactly while a profiler records, on any
thread: ``profile_trace`` (which records every thread, the server's
scheduler and replica threads included), an operator's own
``torch.profiler.profile`` (the same with ``experimental_config=
_ExperimentalConfig(profile_all_threads=True)``), or a benchmark's
traced slice. Otherwise it returns one shared no-op context, at the cost
of one read of a flag. The gate is ``torch.autograd.profiler.
_is_profiler_enabled``, which the profiler sets for the process:
``torch._C._autograd._profiler_enabled()`` is per thread and reads False
on a second thread while a profile is open. A ``record_function`` costs
about 10 µs of an x86 server core even with no profiler open, hence the
gate. While a profiler records, a range costs the host 12-15 µs
(H100 machine, PyTorch 2.11): under 1% of a caption or train step.
Nothing reaches an exported or compiled graph: ``export.py`` traces with
no profiler open, and an export under one drops the ranges.

The spans, all named ``rtvc.*`` (the operators are ``rtvc::*``), each
inside the one above it:

- ``serving.make_caption_step``: ``rtvc.caption.step`` >
  ``rtvc.caption.preprocess``; ``decode.student_greedy`` /
  ``student_beam``: ``rtvc.decode.encode`` > ``rtvc.encode.graph`` (the
  replay of the encoder's CUDA graph, where the call takes one:
  ``models/encode_graph.py``), one ``rtvc.decode.token`` a
  decoded token > ``rtvc.decode.graph`` (the replay of the position's
  CUDA graph, where the step takes one: ``models/decode_graph.py``) and
  ``rtvc.decode.stop_wait`` (the read-back of the all-rows-SEP test,
  greedy with ``host_stop`` only: eager, the token's own; on a decode
  workspace, the previous position's, after this one is issued);
- the vision-language captioner (``models/kimi_vl.py``, driven by
  ``decode.vlm_greedy`` under the same caption step): ``rtvc.vlm.vision``
  (MoonViT and the projector) inside ``rtvc.decode.encode``;
  ``rtvc.vlm.prefill`` (the language model over the prompt); one
  ``rtvc.decode.token`` a decode step, with its ``rtvc.decode.stop_wait``
  (the first token's stop wait follows the prefill on its own); inside
  either, ``rtvc.vlm.mla_decode`` (one layer's absorbed attention at one
  position) and ``rtvc.vlm.experts`` (one MoE layer's routed experts),
  in a graphed decode step both inside ``rtvc.decode.graph`` (the replay
  of the step's per-layer graphs, ``models/kimi_lm.LatentWorkspace``);
- ``real_time_inference.StreamingCaptioner.caption``:
  ``rtvc.stream.caption`` > ``rtvc.stream.h2d``, the step,
  ``rtvc.stream.readback``, ``rtvc.stream.detokenize``;
- ``serving.BatchCaptionServer``'s scheduler thread: ``rtvc.serve.wait``
  (nothing pending), ``rtvc.serve.linger`` (the ``max_wait_ms``
  coalescing wait), ``rtvc.serve.batch`` > ``rtvc.serve.assemble`` >
  ``rtvc.serve.row`` a real row, ``rtvc.serve.place`` (host to device),
  the step, ``rtvc.serve.readback``, ``rtvc.serve.resolve`` (tokenizer
  and futures); with dp replicas on their own threads, each thread's step
  and read-back;
- ``train.make_train_step``: ``rtvc.train.step`` > ``rtvc.train.teacher``,
  ``rtvc.train.student_forward``, ``rtvc.train.losses``,
  ``rtvc.train.backward``, ``rtvc.train.grad_cast`` (a microbatch each),
  ``rtvc.train.allreduce`` (dp > 1), ``rtvc.train.adam``,
  ``rtvc.train.copy_back``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Any, Deque, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records, else a shared no-op context (module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _synchronize(tree: Any) -> None:
    """``torch.cuda.synchronize`` on the device of every CUDA tensor in a
    tensor, or a list, tuple or dict of them."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class StepTimer:
    """Durations of a repeated step; with ``window``, the newest
    ``window`` of them (``summary`` then skips the oldest held)."""

    def __init__(self, name: str = "step", window: Optional[int] = None):
        self.name = name
        self.durations: Union[List[float], Deque[float]] = (
            deque(maxlen=window) if window else [])
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            _synchronize(sync_on)
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        return dt

    @contextlib.contextmanager
    def measure(self, sync_on_result=None) -> Iterator[None]:
        self.start()
        yield
        self.stop(sync_on_result)

    def summary(self, skip_warmup: int = 1) -> dict:
        held = list(self.durations)
        d = np.asarray(held[skip_warmup:] or held)
        return {
            f"{self.name}_mean_s": float(d.mean()),
            f"{self.name}_p50_s": float(np.percentile(d, 50)),
            f"{self.name}_p90_s": float(np.percentile(d, 90)),
            f"{self.name}_min_s": float(d.min()),
        }


def _all_threads():
    """Kineto's option to record the operators and spans of every
    thread, where this PyTorch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """A ``torch.profiler`` region over the host's threads and, where
    there is one, the card; on exit its Chrome trace is written to
    ``logdir/trace_<pid>_<ns>.json``."""
    if not enabled:
        yield
        return
    wanted = {torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA}
    activities = [a for a in torch.profiler.supported_activities()
                  if a in wanted]
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=_all_threads()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
