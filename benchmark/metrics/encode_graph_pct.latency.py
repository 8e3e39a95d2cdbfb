"""The share of the slice's encoder calls that replayed a CUDA graph:
``rtvc.encode.graph`` ranges inside the ``rtvc.decode.encode`` ranges ÷
those ranges, in % (the program's spans; 0 where every call ran the eager
body, nothing where the slice encoded no window)."""

from benchlib.spans import per_parent


def read(run):
    share = per_parent(run, "rtvc.encode.graph", "rtvc.decode.encode")
    return None if share is None else 100.0 * share
