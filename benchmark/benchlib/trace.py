"""The profiled slice of a traced run: ``torch.profiler`` over a short
stretch of the cell's own traffic, read back from its Chrome trace.

:func:`profile` runs a function under the profiler (CPU and CUDA
activities, input shapes recorded) inside a ``bench::slice`` annotation,
writes the trace to the run's temporary directory, reads it and deletes
it. :class:`Trace` holds what the metric readers need: the device's
kernels, copies and sets with their launching host call, the host's
operator and annotation ranges, and the slice's bounds.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

SLICE = "bench::slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class Trace:
    def __init__(self, events: List[dict]):
        self.slice = (0.0, 0.0)
        self.device: List[dict] = []
        self.launch: Dict[int, Tuple[float, int]] = {}
        self.host: Dict[int, List[dict]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (float(e["ts"]), e.get("tid"))
            elif cat in HOST_CATS:
                if e.get("name") == SLICE:
                    t0 = float(e["ts"])
                    self.slice = (t0, t0 + float(e["dur"]))
                else:
                    self.host[e.get("tid")].append(e)
        for lst in self.host.values():
            lst.sort(key=lambda e: float(e["ts"]))
        self._starts = {tid: [float(e["ts"]) for e in lst]
                        for tid, lst in self.host.items()}
        self.device.sort(key=lambda e: float(e["ts"]))
        self._ranges: Dict[str, list] = {}
        self._range_starts: Dict[str, List[float]] = {}

    # ---- the slice -------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.slice[1] - self.slice[0]) * 1e-6

    def in_slice(self) -> List[dict]:
        s0, s1 = self.slice
        return [e for e in self.device
                if float(e["ts"]) < s1 and float(e["ts"]) + float(e["dur"]) > s0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity, clipped to the slice (µs)."""
        s0, s1 = self.slice
        spans = sorted((max(float(e["ts"]), s0),
                        min(float(e["ts"]) + float(e["dur"]), s1))
                       for e in self.in_slice())
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    # ---- host attribution -----------------------------------------------
    def enclosing(self, tid, t: float) -> Optional[dict]:
        """The innermost host range on ``tid`` open at ``t``, looked for
        among the 64 ranges that started last before ``t``."""
        lst = self.host.get(tid, [])
        i = bisect.bisect_right(self._starts.get(tid, []), t)
        for e in reversed(lst[max(0, i - 64):i]):
            if float(e["ts"]) + float(e["dur"]) >= t:
                return e
        return None

    def ranges(self, name: str) -> List[Tuple[float, float, object, dict]]:
        """Every host range called ``name``: (start, end, thread, event),
        by start."""
        if name not in self._ranges:
            found = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), tid,
                      e) for tid, lst in self.host.items() for e in lst
                     if e.get("name") == name]
            found.sort(key=lambda r: r[0])
            self._ranges[name] = found
            self._range_starts[name] = [r[0] for r in found]
        return self._ranges[name]

    def launched_within(self, kernel: dict, name: str) -> Optional[dict]:
        """The host range ``name`` that was open on the launching thread
        when ``kernel`` was launched, or None."""
        corr = kernel.get("args", {}).get("correlation")
        if corr not in self.launch:
            return None
        t, tid = self.launch[corr]
        spans = self.ranges(name)
        i = bisect.bisect_right(self._range_starts[name], t)
        for a, b, owner, e in reversed(spans[max(0, i - 8):i]):
            if a <= t <= b and owner == tid:
                return e
        return None

    # ---- the breakdown ---------------------------------------------------
    def device_ops(self, top: int = 10) -> List[List]:
        s0, s1 = self.slice
        total: Dict[str, float] = defaultdict(float)
        for e in self.in_slice():
            a = max(float(e["ts"]), s0)
            b = min(float(e["ts"]) + float(e["dur"]), s1)
            total[e.get("name", "?")] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds summed by what the host was doing when each gap
        began: the innermost operator or annotation open then on the
        thread that launched the device's last work."""
        s0, s1 = self.slice
        busy = self.busy_intervals()
        gaps, at = [], s0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < s1:
            gaps.append((at, s1))
        launches = sorted(self.launch.values())
        times = [t for t, _ in launches]
        total: Dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            i = bisect.bisect_right(times, g0)
            tid = launches[i - 1][1] if i else None
            e = self.enclosing(tid, g0) if tid is not None else None
            total[e.get("name", "?") if e else "host outside any operator"] \
                += (g1 - g0) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]


def all_threads_config():
    """Kineto's option to record the host operators of every thread (the
    batch server launches from its scheduler thread), where this PyTorch
    has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def profile(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under ``torch.profiler`` and return its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts, record_shapes=True,
                       experimental_config=all_threads_config()) as prof:
        with torch.profiler.record_function(SLICE):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events)
