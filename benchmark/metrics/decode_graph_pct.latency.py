"""The share of the slice's decoded tokens whose step replayed a CUDA
graph: ``rtvc.decode.graph`` ranges inside the ``rtvc.decode.token``
ranges ÷ those ranges, in % (the program's spans; 0 where every token ran
the eager body, nothing where the slice decoded no token)."""

from benchlib.spans import per_parent


def read(run):
    share = per_parent(run, "rtvc.decode.graph", "rtvc.decode.token")
    return None if share is None else 100.0 * share
