"""The port's program spans (``rtvc_tpu_torch.utils.profiling.span``).

Under ``profile_trace`` (every thread), on a tiny student (224-pixel
crop) and the dry run's tiny train pair, on the CPU: the caption step
emits one ``rtvc.decode.token`` a decode iteration the rows show, each
holding one ``rtvc.decode.stop_wait``; the live captioner nests its
copy, step, read-back and tokenizer in ``rtvc.stream.caption``; the
batch server emits its batch, assembly, a row each, placement, step,
read-back and resolution, nested, on its scheduler thread; the train
step emits its spans in order, a microbatch's again for each. With no
profiler no ``record_function`` is entered, and rows, losses and
updates are bit-equal to a run with the spans on. An exported caption
program holds no profiler node, also when exported under an open
profiler. The server's queue wait reaches ``stats()``; the live
captioner's timer is bounded.
"""

import copy
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from rtvc_tpu_torch import export
from rtvc_tpu_torch.distill import LossWeights
from rtvc_tpu_torch.parallel import dryrun
from rtvc_tpu_torch.real_time_inference import StreamingCaptioner
from rtvc_tpu_torch.serving import (STATS_WINDOW, BatchCaptionServer,
                                    make_caption_step)
from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer
from rtvc_tpu_torch.train import Adam, create_train_state, make_train_step
from rtvc_tpu_torch.utils.profiling import StepTimer, profile_trace

from test_torch_export import CROP, FRAME, WINDOW, tiny

SEP = 102
MAX_LEN = 5
MAIN = "test.main"
# every row emits SEP at step 2, so the host stop breaks after 3 tokens
_SCRIPT = np.array([[5, 7, SEP, 11, 13], [9, SEP, SEP, 19, 23]])


@pytest.fixture(scope="module")
def student():
    return tiny()


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(n, WINDOW) + FRAME).astype(np.uint8)


def _read(path):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [(e["name"], e["tid"], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _traced(fn, tmp_path):
    """``fn()`` under ``profile_trace`` (every thread) inside a
    ``test.main`` range; its result and the trace's ranges ``(name, tid,
    start, end)`` by start."""
    with profile_trace(str(tmp_path)):
        with torch.profiler.record_function(MAIN):
            out = fn()
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    return out, sorted(_read(path), key=lambda r: r[2])


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(child, parent):
    return (child[1] == parent[1] and parent[2] <= child[2]
            and child[3] <= parent[3])


def _children(ranges, parent, name):
    return [r for r in _named(ranges, name) if _inside(r, parent)]


def _decode_iterations(rows):
    """Greedy decode iterations the rows show: up to the first step at
    which every row emitted SEP, else all of them."""
    all_sep = np.nonzero((rows[:, 1:] == SEP).all(0))[0]
    return int(all_sep[0]) + 1 if all_sep.size else rows.shape[1] - 1


@pytest.mark.parametrize("scripted", [False, True])
def test_caption_step_spans_a_token_an_iteration(student, monkeypatch,
                                                 tmp_path, scripted):
    if scripted:
        real = student.decode_step

        def decode_step(token, index, caches, kv_mask=None, **kw):
            logits, caches = real(token, index, caches, kv_mask, **kw)
            forced = torch.full_like(logits, -1e4)
            forced[torch.arange(2), torch.from_numpy(_SCRIPT[:, index])] = 0
            return forced, caches

        monkeypatch.setattr(student, "decode_step", decode_step)
    step = make_caption_step(student, max_len=MAX_LEN, crop_size=CROP)
    rows, ranges = _traced(lambda: step(torch.from_numpy(_windows(2))),
                           tmp_path)
    n = _decode_iterations(rows.numpy())
    assert n == (3 if scripted else MAX_LEN)
    (outer,) = _named(ranges, "rtvc.caption.step")
    assert len(_children(ranges, outer, "rtvc.caption.preprocess")) == 1
    assert len(_children(ranges, outer, "rtvc.decode.encode")) == 1
    tokens = _children(ranges, outer, "rtvc.decode.token")
    assert len(tokens) == len(_named(ranges, "rtvc.decode.token")) == n
    waits = _named(ranges, "rtvc.decode.stop_wait")
    assert len(waits) == n
    for token in tokens:
        assert len([w for w in waits if _inside(w, token)]) == 1


def test_beam_step_spans_each_decode_step(student, tmp_path):
    step = make_caption_step(student, max_len=MAX_LEN, beam=2,
                             crop_size=CROP)
    _, ranges = _traced(lambda: step(torch.from_numpy(_windows(1))),
                        tmp_path)
    (outer,) = _named(ranges, "rtvc.caption.step")
    assert len(_children(ranges, outer, "rtvc.decode.token")) == MAX_LEN - 1
    assert not _named(ranges, "rtvc.decode.stop_wait")


def test_streaming_captioner_nests_its_parts(student, tmp_path):
    cap = StreamingCaptioner(student, BertWordPieceTokenizer(),
                             max_len=MAX_LEN)
    _, ranges = _traced(lambda: cap.caption(_windows(1)[0]), tmp_path)
    (outer,) = _named(ranges, "rtvc.stream.caption")
    parts = ["rtvc.stream.h2d", "rtvc.caption.step", "rtvc.stream.readback",
             "rtvc.stream.detokenize"]
    found = [r for r in ranges if r[0] in parts and _inside(r, outer)]
    assert [r[0] for r in found] == parts
    assert cap.timer.durations.maxlen == STATS_WINDOW


def test_server_spans_nest_on_its_scheduler_thread(student, tmp_path):
    wins = _windows(3)
    srv = BatchCaptionServer(student, BertWordPieceTokenizer(), max_batch=4,
                             max_wait_ms=200.0, max_len=MAX_LEN,
                             frame_shape=FRAME, window=WINDOW, warmup=False)
    try:
        def serve():
            futs = [srv.submit(w) for w in wins]
            return [f.tokens(timeout=120) for f in futs]

        _, ranges = _traced(serve, tmp_path)
    finally:
        srv.close()
    (main,) = _named(ranges, MAIN)
    batches = _named(ranges, "rtvc.serve.batch")
    assert batches and all(b[1] != main[1] for b in batches)
    order = ["rtvc.serve.assemble", "rtvc.serve.place", "rtvc.caption.step",
             "rtvc.serve.readback", "rtvc.serve.resolve"]
    rows = 0
    for batch in batches:
        found = [r for r in ranges if r[0] in order and _inside(r, batch)]
        assert [r[0] for r in found] == order
        (assemble,) = _children(ranges, batch, "rtvc.serve.assemble")
        rows += len(_children(ranges, assemble, "rtvc.serve.row"))
    assert rows == len(_named(ranges, "rtvc.serve.row")) == len(wins)
    assert srv.stats()["served"] == len(wins)


@pytest.fixture(scope="module")
def train_pair():
    return dryrun.dryrun_models()


def _train_step(pair, grad_accum=1):
    student, teacher = copy.deepcopy(pair)
    opt = Adam(1e-3)
    state = create_train_state(student, opt, torch.float32)
    step = make_train_step(student, teacher, opt,
                           LossWeights(kl=1.0, ce=1.0),
                           grad_accum=grad_accum)
    batch = dryrun.synth_batches(3, 1, 2, 2, 64, 8, dryrun.VOCAB)[0]
    return lambda: step(state, batch, torch.Generator().manual_seed(5)), state


TRAIN_PART = ["rtvc.train.teacher", "rtvc.train.student_forward",
              "rtvc.train.losses", "rtvc.train.backward",
              "rtvc.train.grad_cast"]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_spans_in_order(train_pair, tmp_path, grad_accum):
    run, _ = _train_step(train_pair, grad_accum)
    _, ranges = _traced(run, tmp_path)
    (outer,) = _named(ranges, "rtvc.train.step")
    names = [r[0] for r in ranges
             if r[0].startswith("rtvc.train.") and _inside(r, outer)]
    assert names == (["rtvc.train.step"] + TRAIN_PART * grad_accum
                     + ["rtvc.train.adam", "rtvc.train.copy_back"])


class _Counting(torch.profiler.record_function):
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


def _counted(monkeypatch, fn, profiled: bool):
    _Counting.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    try:
        if profiled:
            with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
                out = fn()
        else:
            out = fn()
    finally:
        monkeypatch.undo()
    return out, _Counting.entered


def test_no_profiler_enters_no_range_and_changes_no_row(student,
                                                        monkeypatch):
    step = make_caption_step(student, max_len=MAX_LEN, crop_size=CROP)
    cap = StreamingCaptioner(student, BertWordPieceTokenizer(),
                             max_len=MAX_LEN)
    frames = _windows(2)

    def run():
        return step(torch.from_numpy(frames)), cap.caption(frames[0])

    (rows_on, text_on), on = _counted(monkeypatch, run, profiled=True)
    (rows_off, text_off), off = _counted(monkeypatch, run, profiled=False)
    assert on > 0 and off == 0
    assert torch.equal(rows_on, rows_off) and text_on == text_off


def test_no_profiler_leaves_the_train_step_bit_equal(train_pair,
                                                     monkeypatch):
    run_on, state_on = _train_step(train_pair)
    run_off, state_off = _train_step(train_pair)
    losses_on, on = _counted(monkeypatch, run_on, profiled=True)
    losses_off, off = _counted(monkeypatch, run_off, profiled=False)
    assert on > 0 and off == 0
    for k in losses_on:
        assert torch.equal(losses_on[k], losses_off[k]), k
    for a, b in zip(state_on.params, state_off.params):
        assert torch.equal(a, b)
    for a, b in zip(state_on.opt_state.mu, state_off.opt_state.mu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("profiled", [False, True])
def test_exported_program_holds_no_profiler_node(student, profiled):
    variables = export.serving_variables(student)

    def trace():
        return export.export_caption_program(
            student, variables, batch=1, window=WINDOW, frame_shape=FRAME,
            max_len=2, device="cpu")

    if profiled:
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
            program = trace()
    else:
        program = trace()
    targets = [str(n.target) for n in program.graph_module.graph.nodes
               if n.op == "call_function"]
    assert "rtvc.layer_norm.default" in targets
    assert not [t for t in targets if "profiler" in t or "record" in t]


def test_queue_wait_shows_a_blocked_step(student):
    srv = BatchCaptionServer(student, BertWordPieceTokenizer(), max_batch=1,
                             max_wait_ms=0.0, max_len=MAX_LEN,
                             frame_shape=FRAME, window=WINDOW, warmup=False)
    entered, release = threading.Event(), threading.Event()
    inner = srv._step

    def blocked(frames):
        entered.set()
        assert release.wait(30)
        return inner(frames)

    srv._step = blocked
    try:
        first = srv.submit(_windows(1)[0])
        assert entered.wait(30)
        second = srv.submit(_windows(1, seed=1)[0])
        time.sleep(0.3)
        release.set()
        first.tokens(timeout=120)
        second.tokens(timeout=120)
        stats = srv.stats()
    finally:
        release.set()
        srv.close()
    waits = sorted(srv.queue_waits_s)
    assert len(waits) == 2
    assert waits[0] < 0.25 and waits[1] >= 0.3
    assert stats["queue_wait_p95_ms"] == pytest.approx(waits[1] * 1e3)
    assert stats["queue_wait_p50_ms"] == pytest.approx(waits[1] * 1e3)


def test_a_windowed_step_timer_keeps_its_newest_samples():
    timer = StepTimer("caption", window=3)
    for dt in (5.0, 1.0, 2.0, 3.0):
        timer.durations.append(dt)
    assert list(timer.durations) == [1.0, 2.0, 3.0]
    assert timer.summary()["caption_min_s"] == 2.0
    assert timer.summary(skip_warmup=0)["caption_mean_s"] == 2.0
