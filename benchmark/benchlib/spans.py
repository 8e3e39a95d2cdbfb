"""The program's own spans in a traced run's profiled slice: the
``rtvc.*`` ranges that ``rtvc_tpu_torch.utils.profiling.span`` opens
while a profiler records, read from the slice's trace
(:class:`benchlib.trace.Trace`) on the profiler's clock.

A reader takes only the ranges that lie wholly inside ``bench::slice``.
A child belongs to a parent when it lies inside it on the same thread.
Every reader returns None where the slice holds none of the ranges it
reads: a program without the spans reports nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

Range = Tuple[float, float, object, dict]  # start, end (µs), thread, event


def inside(run, name: str) -> List[Range]:
    """The ranges called ``name`` that lie wholly inside the slice, by
    start."""
    t = run.trace_data
    if t is None:
        return []
    s0, s1 = t.slice
    return [r for r in t.ranges(name) if s0 <= r[0] and r[1] <= s1]


def _within(parents: List[Range], children: List[Range]
            ) -> List[List[Range]]:
    """For each parent, the children inside it on its thread."""
    starts = [c[0] for c in children]
    out = []
    for a, b, tid, _ in parents:
        lo = bisect.bisect_left(starts, a)
        hi = bisect.bisect_right(starts, b)
        out.append([c for c in children[lo:hi]
                    if c[1] <= b and c[2] == tid])
    return out


def _ms(r: Range) -> float:
    return (r[1] - r[0]) * 1e-3


def _mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def mean_ms(run, name: str) -> Optional[float]:
    """The mean duration of the ``name`` ranges, in ms."""
    return _mean([_ms(r) for r in inside(run, name)])


def mean_children_ms(run, parent: str, children: Sequence[str]
                     ) -> Optional[float]:
    """The mean over the ``parent`` ranges of the summed durations of
    their ``children`` ranges, in ms."""
    parents = inside(run, parent)
    if not parents:
        return None
    total = [0.0] * len(parents)
    for name in children:
        for i, kids in enumerate(_within(parents, inside(run, name))):
            total[i] += sum(_ms(c) for c in kids)
    return _mean(total)


def mean_self_ms(run, parent: str, child: str) -> Optional[float]:
    """The mean over the ``parent`` ranges of each one's duration less
    its ``child`` ranges', in ms."""
    parents = inside(run, parent)
    kids = _within(parents, inside(run, child))
    return _mean([_ms(p) - sum(_ms(c) for c in k)
                  for p, k in zip(parents, kids)])


def per_parent(run, child: str, parent: str) -> Optional[float]:
    """``child`` ranges inside the ``parent`` ranges ÷ ``parent``
    ranges."""
    parents = inside(run, parent)
    if not parents:
        return None
    kids = _within(parents, inside(run, child))
    return sum(len(k) for k in kids) / len(parents)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(trace) -> List[Tuple[float, float]]:
    """The slice's stretches with no kernel, copy or set on the device."""
    s0, s1 = trace.slice
    gaps, at = [], s0
    for a, b in trace.busy_intervals():
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < s1:
        gaps.append((at, s1))
    return gaps


def idle_share_pct(run, name: str) -> Optional[float]:
    """The share of the slice's device-idle time that falls inside the
    union of the ``name`` ranges (any thread), in %."""
    spans = _union([(r[0], r[1]) for r in inside(run, name)])
    if not spans:
        return None
    gaps = idle_gaps(run.trace_data)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    covered, j = 0.0, 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            covered += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return 100.0 * covered / idle

