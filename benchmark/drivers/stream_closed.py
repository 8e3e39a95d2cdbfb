"""One live source captioned back to back: a closed-loop client of the
program's ``real_time_inference.StreamingCaptioner`` (the caption step at
batch 1, the host-to-device copy, the read-back and the tokenizer). The
next seeded window goes in as soon as the last caption returns; a
request's latency runs from the call to its caption."""

from __future__ import annotations

import time

from benchlib import caption, core, traffic


def setup(run: core.Run):
    from rtvc_tpu_torch.real_time_inference import StreamingCaptioner

    st = caption.CaptionState(run)
    tr = run.workload["traffic"]
    st.captioner = StreamingCaptioner(st.student, st.tokenizer,
                                      max_len=st.max_len,
                                      frame_shape=tuple(tr["frame"]))
    st.last_rows = None

    def set_step(step):
        tapped = st.tap.around(step)

        def recorded(frames):
            st.last_rows = tapped(frames)
            return st.last_rows

        st.captioner._step = recorded

    st.set_step = set_step
    set_step(st.captioner._step)
    st.order = iter(traffic.order(len(st.host_windows), 1 << 20, run.seed))
    for _ in range(int(tr.get("warm_requests", 3))):
        st.captioner.caption(st.host_windows[next(st.order)])
    return st


def measure(run: core.Run, st, seconds: float, rec: core.Records) -> None:
    rows = []
    st.tap.armed = True
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        w = next(st.order)
        rec.attempted += 1
        t_sub = time.perf_counter()
        try:
            st.captioner.caption(st.host_windows[w])
        except RuntimeError as e:
            core.log(f"caption failed: {e}")
            rec.failed += 1
            continue
        rec.latencies_s.append(time.perf_counter() - t_sub)
        rows.append((w, st.last_rows))
    rec.window_s = time.perf_counter() - t0
    st.tap.armed = False
    rec.completed = len(rows)
    for w, r in rows:
        toks = r[0].cpu().numpy()
        rec.served.append((w, toks))
        rec.flops += caption.request_flops(
            run, len(caption.served_tokens(toks, st.sep)))
    if rec.spans_on:
        caption.part_times(run, st, 1, int(run.workload["traffic"]
                                           .get("span_reps", 20)), rec)


def check(run: core.Run, st):
    return caption.check(run, st)
