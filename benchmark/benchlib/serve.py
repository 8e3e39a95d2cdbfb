"""The batch caption server of a caption cell, built as its command line
builds it, with the cell's batching parameters."""

from __future__ import annotations

import numpy as np

from .caption import CaptionState
from .core import Run


def server(run: Run, st: CaptionState):
    from rtvc_tpu_torch.serving import BatchCaptionServer

    tr = run.workload["traffic"]
    srv = BatchCaptionServer(
        st.student, st.tokenizer, max_batch=int(tr["max_batch"]),
        max_wait_ms=float(tr["max_wait_ms"]), max_len=st.max_len, beam=0,
        buckets=tuple(tr["buckets"]), frame_shape=tuple(tr["frame"]),
        window=int(run.config["num_frames"]), warmup=True)
    st.closers.append(srv.close)
    return srv


def step_setter(srv, tap):
    """``set_step(step)``: the server's caption step replaced by ``step``,
    seen through ``tap``."""
    def set_step(step):
        srv._step = tap.around(step)
    return set_step


def warm(srv, st: CaptionState, requests: int) -> None:
    """Fill the largest bucket a few times with real windows."""
    futs = [srv.submit(st.host_windows[i % len(st.host_windows)])
            for i in range(requests)]
    for f in futs:
        f.result(timeout=300)


def as_row(tokens) -> np.ndarray:
    return np.asarray(tokens if tokens is not None else [], np.int64)
