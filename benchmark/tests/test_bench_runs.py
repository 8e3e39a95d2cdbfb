"""Whole runs of the four kinds of cell at a tiny size on the CPU, past
the look for a card: the last line's keys, a sound program found
correct, and each fault a cell can have, planted in the program, found
not correct. The controls (the program's own int8 paths) and the fp8
reference are found not correct too, through the same judgement."""

import json

import pytest
import torch

import tiny
from benchlib import controls, core
from benchlib.trace import Trace

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = ["tiny-realtime", "tiny-archive", "tiny-distill"]


@pytest.fixture
def bench(tmp_path):
    torch.set_num_threads(2)
    return tiny.layout(tmp_path)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(bench, cell):
    out = core.execute(tiny.run(bench, cell))
    assert list(out) == KEYS
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    json.dumps(out)


def test_a_traced_line_carries_the_trace(bench):
    run = tiny.run(bench, "tiny-archive")
    run.trace = True
    run.checks = {"logit_gap": (0.0, 1.0)}
    run.trace_data = Trace([
        {"ph": "X", "cat": "user_annotation", "name": "bench::slice",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10,
         "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 2, "tid": 1, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20, "dur": 30,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40,
         "dur": 50, "tid": 1}])
    out = core.result(run)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["device"]["busy_s"] == pytest.approx(30e-6)
    assert out["device"]["window_s"] == pytest.approx(100e-6)
    assert out["breakdown"]["device_ops"] == [["gemm", pytest.approx(30e-6)]]
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps == {"aten::item": pytest.approx(50e-6),
                    "host outside any operator": pytest.approx(20e-6)}


def _alter_token(monkeypatch):
    import rtvc_tpu_torch.serving as serving
    inner = serving.student_greedy

    def altered(model, frames, **kw):
        rows = inner(model, frames, **kw)
        rows[:, 2] = (rows[:, 2] + 1) % model.vocab_size
        return rows
    monkeypatch.setattr(serving, "student_greedy", altered)


def _half_batch_caption(monkeypatch):
    import rtvc_tpu_torch.serving as serving
    inner = serving.student_greedy

    def half(model, frames, **kw):
        b = frames.shape[0]
        rows = inner(model, frames[:max(1, b // 2)], **kw)
        return rows.repeat((b + rows.shape[0] - 1) // rows.shape[0], 1)[:b]
    monkeypatch.setattr(serving, "student_greedy", half)


def _state_unchanged(monkeypatch):
    import rtvc_tpu_torch.train as train
    monkeypatch.setattr(train.Adam, "update",
                        lambda self, grads, state, params: None)


def _half_batch_train(monkeypatch):
    import rtvc_tpu_torch.train as train
    inner = train.make_train_step

    def make(*a, **kw):
        step = inner(*a, **kw)

        def half(state, batch, gen):
            b = batch["frames"].shape[0] // 2
            return step(state, {k: v[:b] for k, v in batch.items()}, gen)
        return half
    monkeypatch.setattr(train, "make_train_step", make)


def _vocab_bias_dropped(monkeypatch):
    from rtvc_tpu_torch.models.student import StudentCandidateV1
    inner = StudentCandidateV1.decode_step

    def dropped(self, *a, **kw):
        logits, caches = inner(self, *a, **kw)
        return logits - self.linear.bias, caches
    monkeypatch.setattr(StudentCandidateV1, "decode_step", dropped)


def _norm_shift_dropped(monkeypatch):
    import rtvc_tpu_torch.models.student as student
    inner = student.TransformerDecoderLayer.decode_step

    def dropped(self, x, *a, **kw):
        return inner(self, x, *a, **kw) - self.norm3.bias
    monkeypatch.setattr(student.TransformerDecoderLayer, "decode_step",
                        dropped)


def _step_after_warmup(monkeypatch):
    """A step that differs only once warm: the set-up's three updates as
    they are, every later one applied twice."""
    import rtvc_tpu_torch.train as train
    inner = train.Adam.update
    calls = []

    def update(self, grads, state, params):
        calls.append(1)
        before = [p.clone() for p in params] if len(calls) > 3 else None
        inner(self, grads, state, params)
        if before is not None:
            torch._foreach_add_(params, torch._foreach_sub(params, before))
    monkeypatch.setattr(train.Adam, "update", update)


FAULTS = [("tiny-realtime", _alter_token), ("tiny-archive", _alter_token),
          ("tiny-archive", _half_batch_caption),
          ("tiny-realtime", _vocab_bias_dropped),
          ("tiny-archive", _norm_shift_dropped),
          ("tiny-distill", _step_after_warmup),
          ("tiny-distill", _state_unchanged),
          ("tiny-distill", _half_batch_train)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_in_the_program_is_not_correct(bench, monkeypatch, cell,
                                               fault):
    fault(monkeypatch)
    out = core.execute(tiny.run(bench, cell))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", ["tiny-realtime", "tiny-archive"])
def test_the_int8_control_of_a_caption_cell_is_not_correct(bench, cell):
    lines = {r["reading"]: r for r in controls.caption_readings(
        tiny.run(bench, cell), 0.6, control=True)}
    assert lines["program"]["correct"] is True, lines["program"]
    ctl = lines["control_vocab_int8"]
    assert ctl["correct"] is False, ctl
    assert ctl["head_err_rms"] > 3 * lines["program"]["head_err_rms"]
    faults = {"fault_token_altered"} | (
        {"fault_half_batch"} if cell == "tiny-archive" else set())
    assert set(lines) == {"program", "control_vocab_int8"} | faults
    for name in faults:
        assert lines[name]["correct"] is False, lines[name]


def test_the_controls_and_faults_of_the_train_step_are_not_correct(bench):
    lines = {r["reading"]: r for r in controls.train_readings(
        tiny.run(bench, "tiny-distill"), 0.6, control=True)}
    assert lines.pop("program")["correct"] is True
    assert sorted(lines) == ["control_fp8_reference", "control_w8a8_teacher",
                             "fault_half_batch", "fault_state_unchanged"]
    for name, line in lines.items():
        assert line["correct"] is False, (name, line)
