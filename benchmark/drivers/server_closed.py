"""Offline captioning of a library: closed-loop clients, each submitting
its next seeded window to the program's ``serving.BatchCaptionServer`` as
soon as its last caption resolved (anonymous requests, nothing is
superseded). A request's latency runs from its submission to its
resolution; the rate counts the captions resolved inside the window."""

from __future__ import annotations

import threading
import time

from benchlib import caption, core, serve, traffic


def setup(run: core.Run):
    st = caption.CaptionState(run)
    tr = run.workload["traffic"]
    t0 = time.perf_counter()
    st.server = serve.server(run, st)
    serve.warm(st.server, st, 2 * int(tr["max_batch"]))
    st.set_step = serve.step_setter(st.server, st.tap)
    st.set_step(st.server._step)
    core.log(f"set-up: server built and warmed in "
             f"{time.perf_counter() - t0:.3f} s")
    st.orders = [iter(traffic.order(len(st.host_windows), 1 << 16, run.seed,
                                    tag=c))
                 for c in range(int(tr["clients"]))]
    return st


def measure(run: core.Run, st, seconds: float, rec: core.Records) -> None:
    done = []
    lock = threading.Lock()
    st.tap.armed = True
    t0 = time.perf_counter()
    end = t0 + seconds

    def client(c: int) -> None:
        while time.perf_counter() < end:
            w = next(st.orders[c])
            t_sub = time.perf_counter()
            fut = st.server.submit(st.host_windows[w])
            try:
                toks = fut.tokens(timeout=120)
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
    rec.window_s = seconds
    rec.attempted = len(done)
    for w, t_sub, t_done, toks, ok in done:
        if not ok or toks is None:
            rec.failed += 1
            continue
        rec.latencies_s.append(t_done - t_sub)
        if t_done <= end:
            rec.completed += 1
            rec.flops += caption.request_flops(
                run, len(caption.served_tokens(toks, st.sep)))
        rec.served.append((w, serve.as_row(toks)))
    if rec.spans_on:
        caption.part_times(run, st, int(run.workload["traffic"]
                                        ["max_batch"]),
                           int(run.workload["traffic"].get("span_reps", 10)),
                           rec)


def check(run: core.Run, st):
    return caption.check(run, st)
