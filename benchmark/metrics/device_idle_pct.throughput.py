"""The share of the profiled slice in which no kernel, copy or set ran on
the device (the union of their intervals in the profiler's trace)."""

from benchlib.readers import idle_pct


def read(run):
    return idle_pct(run)
