"""The readings that the limits of ``correct`` are set from, each judged
as a run judges its own (:func:`core.result`):

- the program's own, after a short window of the cell's traffic (the
  lower readings);
- the control, the program with its own lower-precision path switched on
  in the same timed path (the upper readings): in the caption cells the
  int8 vocabulary projection (``vocab_int8``, kernel K3), in the train
  step the W8A8 teacher (``quantize_teacher_``, kernel K7);
- the faults a cell can have, planted in the timed path: in the caption
  cells a token altered where it is produced and, where a batch holds
  more than one window, half of each batch left out (its rows copied
  over the rest); in the train step half of each batch left out (the
  mean over the rest) and a step that leaves its state unchanged, and
  the reference itself in fp8 put in the program's place.

``benchmark/control.py`` runs them on the card; the benchmark's own runs
never do.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import caption, core, train_check


def _judged(run: core.Run, name: str, values: Dict[str, float],
            rec: core.Records) -> dict:
    run.checks = core.limited(run, values)
    run.records = rec
    line = core.result(run)
    return dict(reading=name, correct=line["correct"], **values)


def caption_readings(run: core.Run, seconds: float,
                     control: bool) -> List[dict]:
    driver = run.module("drivers", run.workload["driver"])
    st = driver.setup(run)
    rec = core.Records()
    driver.measure(run, st, seconds, rec)
    taken = [("program", caption.collect(run, st, rec), rec)]
    if control:
        from rtvc_tpu_torch.serving import make_caption_step, with_vocab_w8

        student = with_vocab_w8(st.student)
        st.set_step(make_caption_step(student, max_len=st.max_len,
                                      vocab_int8=True))
        rec = core.Records()
        driver.measure(run, st, seconds, rec)
        taken.append(("control_vocab_int8", caption.collect(run, st, rec),
                      rec))
        faults = [("fault_token_altered", token_altered)]
        if int(run.workload["traffic"].get("max_batch", 1)) > 1:
            faults.append(("fault_half_batch", half_batch))
        for name, fault in faults:
            st.set_step(fault(make_caption_step(student, max_len=st.max_len),
                              int(run.config["decoder"]["vocab_size"])))
            rec = core.Records()
            driver.measure(run, st, seconds, rec)
            taken.append((name, caption.collect(run, st, rec), rec))
    caption.free(run, st)
    ref = caption.reference(run, st)
    return [_judged(run, name, caption.numbers(run, st, t, ref), r)
            for name, t, r in taken]


def token_altered(step, vocab: int):
    """The caption step with its second generated token moved by one."""
    def altered(frames):
        rows = step(frames).clone()
        rows[:, 2] = (rows[:, 2] + 1) % vocab
        return rows
    return altered


def half_batch(step, vocab: int):
    """The caption step run on the first half of each batch, its rows
    repeated over the rest."""
    def half(frames):
        b = frames.shape[0]
        rows = step(frames[:max(1, b // 2)])
        return rows.repeat((b + rows.shape[0] - 1) // rows.shape[0], 1)[:b]
    return half


def train_readings(run: core.Run, seconds: float,
                   control: bool) -> List[dict]:
    driver = run.module("drivers", run.workload["driver"])
    st = driver.setup(run)
    rec = core.Records()
    driver.measure(run, st, seconds, rec)
    prog = train_check.program_steps(run, st, driver.one_step)
    readings = [("program", prog)]
    if control:
        full = (st.frames, st.captions)
        b = st.frames.shape[1] // 2
        st.frames, st.captions = st.frames[:, :b], st.captions[:, :b]
        readings.append(("fault_half_batch", train_check.program_steps(
            run, st, driver.one_step)))
        st.frames, st.captions = full
        readings.append(("fault_state_unchanged", dict(
            prog, change=[torch.zeros_like(c) for c in prog["change"]])))
        from rtvc_tpu_torch.ops.quantization import quantize_teacher_

        quantize_teacher_(st.teacher)
        readings.append(("control_w8a8_teacher", train_check.program_steps(
            run, st, driver.one_step)))
    del st.state, st.step, st.teacher
    if run.on_card:
        torch.cuda.empty_cache()
    ref = train_check.reference_steps(run, st)
    if control:
        readings.append(("control_fp8_reference",
                         train_check.reference_steps(run, st, "fp8")))
    return [_judged(run, name, train_check.numbers(r, ref, st.names), rec)
            for name, r in readings]
