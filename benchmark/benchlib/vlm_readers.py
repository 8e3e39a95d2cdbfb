"""Device time under the vision-language captioner's spans, read from a
traced run's profiled slice (:class:`benchlib.trace.Trace`).

A kernel belongs to a span when the span's range was open on the
launching thread at its launch; only ranges that lie wholly inside the
slice count. Every reader returns None where the slice holds none of the
ranges it reads, as a program without the spans gives.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from .work_vlm import grouped_mm_work, mla_decode_work, prompt_length


def kernels_in(run, name: str, inside: Optional[str] = None
               ) -> Dict[int, list]:
    """``{id: [range event, device seconds]}`` over the ``name`` ranges
    wholly inside the slice (and, with ``inside``, launched inside an
    ``inside`` range too) that launched a kernel."""
    t = run.trace_data
    if t is None:
        return {}
    s0, s1 = t.slice
    out: Dict[int, list] = {}
    for k in t.in_slice():
        if k.get("cat") != "kernel":
            continue
        r = t.launched_within(k, name)
        if r is None:
            continue
        a = float(r["ts"])
        if a < s0 or a + float(r["dur"]) > s1:
            continue
        if inside is not None and t.launched_within(k, inside) is None:
            continue
        out.setdefault(id(r), [r, 0.0])[1] += float(k["dur"]) * 1e-6
    return out


def ms_per_range(run, name: str) -> Optional[float]:
    """Device ms of the kernels launched inside a ``name`` range, the mean
    over the ranges."""
    found = kernels_in(run, name)
    if not found:
        return None
    return 1e3 * sum(s for _, s in found.values()) / len(found)


def ops_inside(run, span: dict, op: str) -> List[dict]:
    """The host ``op`` ranges that start inside ``span`` on its thread."""
    t = run.trace_data
    a, b = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    tid = span.get("tid")
    ranges = t.ranges(op)
    starts = t._range_starts[op]
    lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
    return [e for _, _, owner, e in ranges[lo:hi] if owner == tid]


def _dims(e: dict) -> list:
    return e.get("args", {}).get("Input Dims") or []


def moe_prefill_pairs(run) -> List[Tuple[float, float, float]]:
    """(bytes, operations, device seconds) of each ``rtvc.vlm.experts``
    range inside ``rtvc.vlm.prefill``: the bound of its grouped expert
    products (``aten::_grouped_mm``, from their operands' shapes) against
    the device time of every kernel it launched."""
    pairs = []
    for span, seconds in kernels_in(run, "rtvc.vlm.experts",
                                    "rtvc.vlm.prefill").values():
        nbytes = flops = 0.0
        for e in ops_inside(run, span, "aten::_grouped_mm"):
            dims = _dims(e)
            if len(dims) >= 2 and len(dims[0]) == 2 and len(dims[1]) == 3:
                b, f = grouped_mm_work(dims[0], dims[1])
                nbytes += b
                flops += f
        if flops:
            pairs.append((nbytes, flops, seconds))
    return pairs


def serve_buckets(run) -> List[Tuple[float, float, object, int]]:
    """(start, end, thread, bucket) of every ``rtvc.serve.batch`` range:
    the bucket its ``rtvc.serve.row`` count was padded to."""
    t = run.trace_data
    batches = t.ranges("rtvc.serve.batch")
    rows = t.ranges("rtvc.serve.row")
    starts = [r[0] for r in rows]
    buckets = sorted(run.workload["traffic"]["buckets"])
    out = []
    for a, b, tid, _ in batches:
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        n = sum(1 for r in rows[lo:hi] if r[2] == tid and r[1] <= b)
        out.append((a, b, tid, next((k for k in buckets if k >= n),
                                    buckets[-1])))
    return out


def mla_decode_pairs(run) -> List[Tuple[float, float, float]]:
    """(bytes, operations, device seconds) of each ``rtvc.vlm.mla_decode``
    range inside a served batch: the batch's bucket for B, and the whole
    latent cache (prompt + new tokens; the decode reads every slot, those
    past the position masked) for T."""
    cfg = run.config
    slots = prompt_length(cfg) + cfg["max_new_tokens"]
    batches = serve_buckets(run)
    starts = [b[0] for b in batches]
    pairs = []
    for span, seconds in kernels_in(run, "rtvc.vlm.mla_decode").values():
        t0 = float(span["ts"])
        i = bisect.bisect_right(starts, t0) - 1
        while i >= 0 and not (batches[i][2] == span.get("tid")
                              and batches[i][1] >= t0):
            i -= 1
        if i < 0:
            continue
        nbytes, flops = mla_decode_work(cfg, batches[i][3], slots)
        pairs.append((nbytes, flops, seconds))
    return pairs

