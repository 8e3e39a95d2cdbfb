"""K1, the window attention of TinyViT, where the encoder replays a CUDA
graph: Σ bound ÷ Σ device time over the ``window_attention_sm90_kernel``
launches of the slice's encoder replays.

A replay is a ``rtvc.encode.graph`` range of the program (the copy of the
frames into the graph's input and the replay, ``models/encode_graph.py``);
its launches are the kernels launched while it was open on its thread,
the graph's own included. Its frames ``[B, F, H, W, 3]`` are the input
shape of the ``aten::copy_`` inside it. Its K1 launches, in order, are the
attention blocks of stages 1-3 of the configuration's encoder: block ``j``
of stage ``s`` on q, k, v ``[B·F·nW, heads, win², dim / heads]`` in
bfloat16 (the kernel's only type) and the bias ``[heads, win², win²]`` in
float32, with ``win = min(window, map)`` and the map padded to whole
windows, as ``models/tinyvit.py`` cuts it. A launch's bound is the larger
of its bytes over 3.35 TB/s and its operations over 989 TFLOP/s
(``benchlib.work.window_work``). A replay whose K1 launches do not number
the blocks is left out. Nothing is read where no encoder call replayed a
graph (``k1_roofline_pct.throughput`` reads K1 there)."""

import bisect

from benchlib.readers import roofline_pct
from benchlib.spans import inside
from benchlib.work import window_work

SPAN = "rtvc.encode.graph"
KERNEL = "window_attention_sm90_kernel"


def blocks(enc: dict, height: int, width: int, frames: int) -> list:
    """(windows, heads, N, D) of each attention block, in order."""
    out = []
    for s in range(1, 4):
        h, w = height // 4 // 2 ** s, width // 4 // 2 ** s
        win = min(enc["window_sizes"][s], h, w)
        windows = frames * -(-h // win) * -(-w // win)
        heads = enc["num_heads"][s]
        shape = (windows, heads, win * win, enc["embed_dims"][s] // heads)
        out += [shape] * enc["depths"][s]
    return out


def _frames(t, a: float, b: float, tid):
    """The ``[B, F, H, W, 3]`` input of the first copy inside a range."""
    lst = t.host.get(tid, [])
    i = bisect.bisect_left([float(e["ts"]) for e in lst], a)
    for e in lst[i:]:
        if float(e["ts"]) > b:
            break
        dims = e.get("args", {}).get("Input Dims") or [[]]
        if e.get("name") == "aten::copy_" and len(dims[0]) == 5:
            return dims[0]
    return None


def read(run):
    t = run.trace_data
    if t is None:
        return None
    replays = {id(r[3]): (r, []) for r in inside(run, SPAN)}
    if not replays:
        return None
    for k in t.in_slice():
        if k.get("cat") == "kernel" and KERNEL in k.get("name", ""):
            e = t.launched_within(k, SPAN)
            if e is not None and id(e) in replays:
                replays[id(e)][1].append(k)
    pairs = []
    for (a, b, tid, _), kernels in replays.values():
        x = _frames(t, a, b, tid)
        if x is None:
            continue
        shapes = blocks(run.config["encoder"], x[2], x[3], x[0] * x[1])
        if len(kernels) != len(shapes):
            continue
        kernels.sort(key=lambda k: float(k["ts"]))
        for (n_w, heads, n, d), k in zip(shapes, kernels):
            nbytes, flops = window_work(n_w, heads, n, d, 2, 4)
            pairs.append((nbytes, flops, float(k["dur"]) * 1e-6))
    return roofline_pct(pairs)
