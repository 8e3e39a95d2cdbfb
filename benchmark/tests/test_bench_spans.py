"""The readers of the program's spans (``benchlib/spans.py`` and the
eight metrics over it) on a synthetic trace with known answers, on a
trace without the spans (a program that has none: nothing is reported),
and in whole traced runs of the tiny cells on the CPU, where every one
of them reads the real program's spans."""

import json
import time
import types

import pytest
import torch

import tiny
from benchlib import core
from benchlib.trace import Trace

SLICE = {"ph": "X", "cat": "user_annotation", "name": "bench::slice",
         "ts": 0, "dur": 1000, "tid": 1}


def _range(name, ts, end, tid):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _kernel(ts, end):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
            "dur": end - ts, "args": {"correlation": 1}}


EVENTS = [
    SLICE,
    # two whole tokens and one cut by the slice's end
    _range("rtvc.decode.token", 100, 200, 1),
    _range("rtvc.decode.stop_wait", 180, 200, 1),
    _range("rtvc.decode.token", 300, 400, 1),
    _range("rtvc.decode.stop_wait", 370, 400, 1),
    _range("rtvc.decode.token", 950, 1100, 1),
    _range("rtvc.decode.stop_wait", 990, 1100, 1),
    _kernel(100, 150), _kernel(300, 320),
    # a batch begun before the slice, its row inside it; a whole batch
    _range("rtvc.serve.batch", -100, 60, 2),
    _range("rtvc.serve.row", 10, 20, 2),
    _range("rtvc.serve.batch", 500, 900, 2),
    _range("rtvc.serve.assemble", 510, 530, 2),
    _range("rtvc.serve.row", 512, 515, 2),
    _range("rtvc.serve.row", 516, 520, 2),
    _range("rtvc.serve.row", 521, 525, 2),
    _range("rtvc.serve.place", 530, 540, 2),
    _range("rtvc.serve.resolve", 850, 880, 2),
    # a resolve on another thread is no child of the batch
    _range("rtvc.serve.resolve", 600, 700, 3),
    _range("rtvc.train.step", 100, 600, 4),
    _range("rtvc.train.backward", 200, 390, 4),
    _range("rtvc.train.grad_cast", 400, 450, 4),
    _range("rtvc.train.copy_back", 550, 560, 4),
]

IDLE = 100 + 150 + 680  # µs of the slice with no kernel
WANT = {
    "decode_issue_ms_per_token.latency": (80 + 70) / 2 * 1e-3,
    "decode_issue_ms_per_token.throughput": (80 + 70) / 2 * 1e-3,
    "decode_wait_ms_per_token.latency": (20 + 30) / 2 * 1e-3,
    "decode_idle_pct.latency": 100.0 * (50 + 80) / IDLE,
    "serve_host_ms.throughput": (20 + 10 + 30) * 1e-3,
    "mean_batch.throughput": 3.0,
    "backward_host_ms.train": 190 * 1e-3,
    "cast_host_ms.train": (50 + 10) * 1e-3,
}


def _read(name, trace):
    mod = core.load_module(core.BENCH_DIR / "metrics" / f"{name}.py",
                           f"metrics.{name}")
    return mod.read(types.SimpleNamespace(trace_data=trace))


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_reads_the_synthetic_spans(name):
    assert _read(name, Trace(EVENTS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_program_without_spans_reports_nothing(name):
    bare = [e for e in EVENTS if not e["name"].startswith("rtvc.")]
    assert _read(name, Trace(bare)) is None
    assert _read(name, None) is None


def test_the_benchmark_declares_each_reader():
    spec = json.loads((core.BENCH_DIR.parent / "BENCHMARK.json")
                      .read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in WANT:
        assert declared[name]["source"] == "program_span"
        assert len(declared[name]["workloads"]) == 1
        assert (core.BENCH_DIR / "metrics" / f"{name}.py").exists()


class _HostEvent:
    """``torch.cuda.Event`` on the host clock, for a CPU run."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


CELLS = {"tiny-realtime": ["decode_issue_ms_per_token.latency",
                           "decode_wait_ms_per_token.latency",
                           "decode_idle_pct.latency"],
         "tiny-archive": ["decode_issue_ms_per_token.throughput",
                          "serve_host_ms.throughput",
                          "mean_batch.throughput"],
         "tiny-distill": ["backward_host_ms.train", "cast_host_ms.train"]}
UNITS = {"decode_idle_pct.latency": "%",
         "mean_batch.throughput": "rows/batch",
         "decode_issue_ms_per_token.latency": "ms/token",
         "decode_wait_ms_per_token.latency": "ms/token",
         "decode_issue_ms_per_token.throughput": "ms/token"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_tiny_run_reads_the_programs_spans(tmp_path, monkeypatch,
                                                    cell):
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    bench = tiny.layout(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"] = [
        {"name": n, "unit": UNITS.get(n, "ms"), "better": "lower",
         "source": "program_span", "layer": "test", "moves": "setup_s",
         "workloads": [c]} for c, names in CELLS.items() for n in names]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    run = tiny.run(bench, cell, seconds=3.0, trace=True)
    out = core.execute(run)
    assert out["correct"] is True, out["checks"]
    assert set(CELLS[cell]) <= set(out["metrics"]), out["metrics"]
    if cell == "tiny-archive":
        assert 1.0 <= out["metrics"]["mean_batch.throughput"]["value"] <= 2
    if cell == "tiny-realtime":
        assert 0 < out["metrics"]["decode_idle_pct.latency"]["value"] <= 100
