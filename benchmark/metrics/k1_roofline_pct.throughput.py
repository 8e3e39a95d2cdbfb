"""K1, the window attention of TinyViT: Σ bound ÷ Σ device time over the
launches in the profiled slice. A launch is the operator
``rtvc::window_attention``; its device time is every kernel launched
inside the operator's host range, whatever implements it; its bound is
the larger of its bytes over 3.35 TB/s and its operations over 989
TFLOP/s, from the operator's input shapes and types (q, k, v ``[B·nW, H,
N, D]``, the bias ``[H, N, N]``)."""

from benchlib.readers import roofline_pct
from benchlib.work import window_work

OP = "rtvc::window_attention"


def _bytes(type_name: str) -> int:
    t = type_name.lower()
    if "bfloat16" in t or "half" in t:
        return 2
    if "double" in t or "long" in t:
        return 8
    return 4


def read(run):
    t = run.trace_data
    if t is None:
        return None
    found = {}
    for k in t.in_slice():
        if k.get("cat") != "kernel":
            continue
        op = t.launched_within(k, OP)
        if op is not None:
            entry = found.setdefault(id(op), [op, 0.0])
            entry[1] += float(k["dur"]) * 1e-6
    pairs = []
    for op, seconds in found.values():
        args = op.get("args", {})
        dims, types = args.get("Input Dims"), args.get("Input type")
        if not dims or len(dims[0]) != 4:
            continue
        b, h, n, d = dims[0]
        elem = _bytes(types[0]) if types else 2
        bias = _bytes(types[3]) if types and len(types) > 3 else 4
        nbytes, flops = window_work(b, h, n, d, elem, bias)
        pairs.append((nbytes, flops, seconds))
    return roofline_pct(pairs)
