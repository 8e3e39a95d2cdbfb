"""The trainer's step: closed-loop calls of the program's
``train.make_train_step`` (the frozen teacher's forward, the student's
train-mode forward, kl + ce, the backward, Adam and the bf16 copy-back) on
seeded batches made on the card, each step's dropout drawn from its own
generator as the training loop draws it. Nothing synchronises between
steps, as in the loop; the rate counts the steps launched in the window
over the time until the card has finished them.

Set-up builds one train state and warms it up with three steps on three
distinct batches; the window continues from step four. Once the window
has closed, the check puts the seeded weights and a fresh Adam state back
into that same state and holds its next three steps, through the same
step call, against the reference (:mod:`benchlib.train_check`).
"""

from __future__ import annotations

import time
import types

import torch

from benchlib import core, program, seeds, traffic, train_check
from benchlib.work import train_step_flops

TEXTUAL = "bench::teacher.textual"
WARM_STEPS = 3


class MarkSpans:
    """CUDA events at the step's ``mark`` points (teacher → student →
    optimizer → end), recorded while ``active``."""

    def __init__(self):
        self.active = False
        self.steps = []
        self._cur = {}

    def __call__(self, name: str) -> None:
        if not self.active:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._cur[name] = ev
        if name == "end":
            self.steps.append(self._cur)
            self._cur = {}

    def collect(self, rec: core.Records) -> None:
        parts = (("teacher_ms", "teacher", "student"),
                 ("student_ms", "student", "optimizer"),
                 ("optimizer_ms", "optimizer", "end"))
        for marks in self.steps:
            for span, a, b in parts:
                if a in marks and b in marks:
                    rec.spans[span].append(marks[a].elapsed_time(marks[b]))
        self.steps = []


def annotate(module: torch.nn.Module, name: str) -> None:
    """A ``torch.profiler`` range around every call of ``module``."""
    open_ranges = []

    def enter(mod, args):
        ctx = torch.profiler.record_function(name)
        ctx.__enter__()
        open_ranges.append(ctx)

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    module.register_forward_pre_hook(enter)
    module.register_forward_hook(leave)


def make_batches(run: core.Run):
    """The pool of batches: preprocessed frames ``[P, B, F, H, W, 3]``
    float32 and captions ``[P, B, T]``, made on the device."""
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess

    cfg, tr = run.config, run.workload["traffic"]
    b, f = cfg["train"]["batch_size"], cfg["train"]["frames"]
    pool = int(tr["pool"])
    u8 = traffic.windows(pool * b, f, tr["frame"], run.seed, run.device)
    crop = cfg["student"]["encoder"]["input_size"]
    pre = clip_preprocess(u8.reshape((-1,) + u8.shape[2:]), crop_size=crop)
    frames = pre.reshape((pool, b, f) + pre.shape[1:])
    caps = traffic.captions(pool * b, cfg["train"]["caption_len"],
                            int(tr["caption_min"]), int(tr["caption_max"]),
                            cfg["teacher"]["vocab_size"], run.seed,
                            run.device)
    return frames, caps.reshape(pool, b, -1)


def setup(run: core.Run):
    from rtvc_tpu_torch.distill import LossWeights
    from rtvc_tpu_torch.train import Adam, create_train_state, make_train_step

    cfg = run.config
    tr = cfg["train"]
    st = types.SimpleNamespace()
    st.student_seed = seeds.sub_seed(run.seed, seeds.WEIGHTS)
    st.teacher_seed = seeds.sub_seed(run.seed, seeds.WEIGHTS, 1)
    st.dropout_seed = seeds.sub_seed(run.seed, seeds.DROPOUT)
    values = program.student_values(cfg["student"], st.student_seed,
                                    run.device)
    student = program.student(cfg["student"], values, run.device,
                              dtype=torch.float32)
    del values
    values = program.teacher_values(cfg, st.teacher_seed, run.device)
    st.teacher = program.teacher(cfg, values, run.device)
    del values
    st.opt = Adam(float(tr["lr"]))
    st.state = create_train_state(student, st.opt,
                                  program.DTYPES[tr["dtype"]])
    st.names = [n for n, _ in student.named_parameters()]
    st.marks = MarkSpans() if run.trace else None
    if run.trace:
        annotate(st.teacher.textual, TEXTUAL)
    w = tr["losses"]
    st.step = make_train_step(
        student, st.teacher, st.opt,
        LossWeights(kl=float(w["kl"]), ce=float(w["ce"]),
                    temperature=float(tr["temperature"])),
        mark=st.marks)
    st.frames, st.captions = make_batches(run)
    st.pool = st.frames.shape[0]
    st.count = 0
    core.sync(run)
    t0 = time.perf_counter()
    core.log(f"set-up: models built {t0 - run.t_start:.3f} s from process "
             f"start")
    for _ in range(WARM_STEPS):
        one_step(st)
    core.sync(run)
    core.log(f"set-up: {WARM_STEPS} warm-up steps in "
             f"{time.perf_counter() - t0:.3f} s")
    return st


def one_step(st):
    i = st.count % st.pool
    m = st.step(st.state, {"frames": st.frames[i], "caption": st.captions[i]},
                seeds.step_generator(st.dropout_seed, st.count))
    st.count += 1
    return m


def measure(run: core.Run, st, seconds: float, rec: core.Records) -> None:
    if st.marks is not None:
        st.marks.active = rec.spans_on
    losses = []
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        losses.append(one_step(st)["total"])
    core.sync(run)
    rec.window_s = time.perf_counter() - t0
    n = len(losses)
    bad = int((~torch.isfinite(torch.stack(losses))).sum()) if n else 0
    rec.attempted = n
    rec.failed = bad
    rec.completed = n - bad
    rec.clips = (n - bad) * int(run.config["train"]["batch_size"])
    rec.flops = (n - bad) * train_step_flops(run.config)
    if st.marks is not None:
        st.marks.active = False
        if rec.spans_on:
            st.marks.collect(rec)
        st.marks.steps = []


def check(run: core.Run, st):
    return train_check.check(run, st, one_step)
