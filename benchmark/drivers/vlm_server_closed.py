"""Offline captioning of a video library with a vision-language model:
closed-loop clients, each submitting its next seeded clip to the program's
``serving.BatchCaptionServer`` over Kimi-VL-A3B as soon as its last
caption resolved (anonymous requests, nothing superseded). A request's
latency runs from its submission to its resolution; the rate counts the
captions resolved inside the window. The server has no tokenizer: a
caption is its token ids."""

from __future__ import annotations

import threading
import time

from benchlib import core, traffic, vlm


def setup(run: core.Run):
    from rtvc_tpu_torch.serving import BatchCaptionServer

    st = vlm.VLMState(run)
    tr = run.workload["traffic"]
    t0 = time.perf_counter()
    st.server = BatchCaptionServer(
        st.model, None, max_batch=int(tr["max_batch"]),
        max_wait_ms=float(tr["max_wait_ms"]), max_len=st.max_new, beam=0,
        buckets=tuple(tr["buckets"]), frame_shape=tuple(tr["frame"]),
        window=int(run.config["num_frames"]), warmup=True)
    st.closers.append(st.server.close)
    futs = [st.server.submit(st.host_clips[i % len(st.host_clips)])
            for i in range(2 * int(tr["max_batch"]))]
    for f in futs:
        f.tokens(timeout=600)

    st.server._step = st.tap.around(st.server._step)
    core.log(f"set-up: server built and warmed in "
             f"{time.perf_counter() - t0:.3f} s")
    st.orders = [iter(traffic.order(len(st.host_clips), 1 << 16, run.seed,
                                    tag=c))
                 for c in range(int(tr["clients"]))]
    return st


def measure(run: core.Run, st, seconds: float, rec: core.Records) -> None:
    done = []
    lock = threading.Lock()
    st.model.reset_expert_load()
    st.tap.armed = True
    t0 = time.perf_counter()
    end = t0 + seconds

    def client(c: int) -> None:
        while time.perf_counter() < end:
            w = next(st.orders[c])
            t_sub = time.perf_counter()
            fut = st.server.submit(st.host_clips[w])
            try:
                toks = fut.tokens(timeout=600)
                ok = True
            except (RuntimeError, TimeoutError) as e:
                core.log(f"caption failed: {e!r}")
                toks, ok = None, False
            with lock:
                done.append((w, t_sub, fut.done_time, toks, ok))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(int(run.workload["traffic"]["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st.tap.armed = False
    vlm.measured(run, st, done, end, seconds, rec)


def check(run: core.Run, st):
    return vlm.check(run, st)
