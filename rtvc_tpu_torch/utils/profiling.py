"""Step timers and trace regions: ``rtvc_tpu/utils/profiling.py``.

``StepTimer.stop(sync_on=...)`` waits for the card before it reads the
clock (``torch.cuda.synchronize`` on the device of each CUDA tensor in
``sync_on``), as JAX's waits on ``block_until_ready``. ``profile_trace``
wraps a region in a ``torch.profiler`` trace (JAX: a ``jax.profiler``
trace) and writes it into ``logdir`` as a Chrome trace (open it in
``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch


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
    def __init__(self, name: str = "step"):
        self.name = name
        self.durations: List[float] = []
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
        d = np.asarray(self.durations[skip_warmup:] or self.durations)
        return {
            f"{self.name}_mean_s": float(d.mean()),
            f"{self.name}_p50_s": float(np.percentile(d, 50)),
            f"{self.name}_p90_s": float(np.percentile(d, 90)),
            f"{self.name}_min_s": float(d.min()),
        }


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """A ``torch.profiler`` region over the host and, where there is one,
    the card; on exit its Chrome trace is written to
    ``logdir/trace_<pid>_<ns>.json``."""
    if not enabled:
        yield
        return
    wanted = {torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA}
    activities = [a for a in torch.profiler.supported_activities()
                  if a in wanted]
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
