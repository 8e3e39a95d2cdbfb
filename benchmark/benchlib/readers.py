"""Arithmetic the metric readers share. A reader returns None where its
run has nothing to read, and the metric is then left out of the line."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from .work import PEAK_FLOPS, bound_s


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (the smallest value with at
    least q% of the values at or below it)."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def span_mean(run, name: str) -> Optional[float]:
    return mean(run.records.spans.get(name, []))


def per_token_ms(run) -> Optional[float]:
    ms = run.records.spans.get("decode_ms", [])
    tokens = sum(run.records.spans.get("decode_tokens", []))
    return sum(ms) / tokens if ms and tokens else None


def mfu_pct(run, dtype: str = "bfloat16") -> Optional[float]:
    r = run.records
    if not r.flops or not r.window_s:
        return None
    return 100.0 * r.flops / (r.window_s * PEAK_FLOPS[dtype])


def idle_pct(run) -> Optional[float]:
    t = run.trace_data
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(pairs: List[tuple]) -> Optional[float]:
    """Σ bound ÷ Σ device time over launches given as (bytes, operations,
    device seconds)."""
    spent = sum(t for _, _, t in pairs)
    if not pairs or spent <= 0:
        return None
    least = sum(bound_s(b, f)[0] for b, f, _ in pairs)
    return 100.0 * least / spent
