"""The 95th percentile of every completed request's latency in the
window, in ms: from when a window was due (open loop) or submitted
(closed loop) until its caption resolved."""

from benchlib.readers import percentile


def read(run):
    p = percentile(run.records.latencies_s, 95)
    return None if p is None else p * 1e3
