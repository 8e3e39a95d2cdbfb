"""``encode_graph_pct.*``: the share of encoder calls that replayed a CUDA
graph, read from the program's ``rtvc.encode.graph`` ranges inside its
``rtvc.decode.encode`` ranges, on synthetic traces with known answers and
in a traced tiny run on the CPU, where every call runs the eager body and
the share reads 0."""

import json
import types

import pytest
import torch

import tiny
from benchlib import core
from benchlib.trace import Trace
from test_bench_spans import SLICE, _HostEvent, _range

NAMES = ["encode_graph_pct.latency", "encode_graph_pct.throughput"]
ENCODES = [_range("rtvc.decode.encode", 100, 200, 1),
           _range("rtvc.decode.encode", 300, 400, 1),
           _range("rtvc.decode.encode", 500, 600, 2),
           _range("rtvc.decode.encode", 700, 800, 1),
           # cut by the slice's end: not counted
           _range("rtvc.decode.encode", 950, 1100, 1),
           _range("rtvc.encode.graph", 960, 990, 1),
           # a decode graph inside an encode range is no encoder replay
           _range("rtvc.decode.graph", 720, 730, 1)]
GRAPHS = [_range("rtvc.encode.graph", 110, 150, 1),
          _range("rtvc.encode.graph", 310, 330, 1),
          _range("rtvc.encode.graph", 510, 530, 2),
          _range("rtvc.encode.graph", 710, 790, 1)]
CASES = {
    "every call": (GRAPHS, 100.0),
    "none": ([], 0.0),
    # one outside any encode range, one inside a range of another thread
    "two of four": (GRAPHS[:2] + [_range("rtvc.encode.graph", 210, 220, 1),
                                  _range("rtvc.encode.graph", 520, 530, 1)],
                    100.0 * 2 / 4),
}


def _read(name, events):
    mod = core.load_module(core.BENCH_DIR / "metrics" / f"{name}.py",
                           f"metrics.{name}")
    trace = None if events is None else Trace(events)
    return mod.read(types.SimpleNamespace(trace_data=trace))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", NAMES)
def test_the_share_of_encoder_calls_that_replayed_a_graph(name, case):
    graphs, want = CASES[case]
    assert _read(name, [SLICE] + ENCODES + graphs) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_no_encoder_calls_no_share(name):
    assert _read(name, [SLICE] + GRAPHS) is None
    assert _read(name, [SLICE]) is None
    assert _read(name, None) is None


def test_the_benchmark_declares_both_readers():
    spec = json.loads((core.BENCH_DIR.parent / "BENCHMARK.json")
                      .read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    cells = {"encode_graph_pct.latency": ("caption_p95_ms",
                                          "caption-realtime-1stream"),
             "encode_graph_pct.throughput": ("caption_windows_per_s",
                                             "caption-archive-closed16")}
    for name, (moves, cell) in cells.items():
        m = declared[name]
        assert (m["source"], m["layer"], m["unit"]) == (
            "program_span", "models.student.forward_image_enc", "%")
        assert (m["moves"], m["workloads"]) == (moves, [cell])


@pytest.mark.parametrize("cell,name", [("tiny-realtime", NAMES[0]),
                                       ("tiny-archive", NAMES[1])])
def test_a_traced_tiny_run_on_the_cpu_reads_zero(tmp_path, monkeypatch,
                                                 cell, name):
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    bench = tiny.layout(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"] = [
        {"name": name, "unit": "%", "better": "higher",
         "source": "program_span", "layer": "test", "moves": "setup_s",
         "workloads": [cell]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = core.execute(tiny.run(bench, cell, seconds=3.0, trace=True))
    assert out["correct"] is True, out["checks"]
    assert out["metrics"][name] == {"value": 0.0, "unit": "%"}
