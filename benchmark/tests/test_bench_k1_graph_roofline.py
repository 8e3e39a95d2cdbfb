"""``k1_graph_roofline_pct.throughput``: K1's share of its roofline over
the encoder's graph replays, on synthetic traces whose answer is worked
out here from the blocks' shapes by hand, and in a traced tiny run on the
CPU, where no call replays a graph and the metric is left out."""

import json
import types

import pytest
import torch

import tiny
from benchlib import core
from benchlib.trace import Trace
from benchlib.work import bound_s, window_work
from test_bench_spans import SLICE, _HostEvent, _range

NAME = "k1_graph_roofline_pct.throughput"
CONFIG = json.loads((core.BENCH_DIR / "configs"
                     / "student-tinyvit21m-d576.json").read_text())
K1 = "void window_attention_sm90_kernel<13, true, true>(...)"
# the ten attention blocks of TinyViT-21M on 224 px frames, for 48 images
# (8 windows of 6 frames): stage 1 a 28-map in 16 windows of 7, stage 2 a
# 14-map in one window of 14, stage 3 a 7-map in one window of 7
BLOCKS_B8 = ([(48 * 16, 6, 49, 32)] * 2 + [(48, 12, 196, 32)] * 6
             + [(48, 18, 49, 32)] * 2)


def _reader():
    return core.load_module(core.BENCH_DIR / "metrics" / f"{NAME}.py",
                            f"metrics.{NAME}")


def _read(events):
    trace = None if events is None else Trace(events)
    return _reader().read(types.SimpleNamespace(trace_data=trace,
                                                config=CONFIG))


def _copy(ts, dims, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": ts,
            "dur": 2, "tid": tid, "args": {"Input Dims": [dims, dims]}}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _kernels(start, durations, corr, name=K1):
    out, at = [], start
    for d in durations:
        out.append({"ph": "X", "cat": "kernel", "name": name, "ts": at,
                    "dur": d, "args": {"correlation": corr}})
        at += d + 1
    return out


def _replay(a, b, corr, frames, durations, tid=1):
    """A ``rtvc.encode.graph`` range with its copy, its graph launch, the
    K1 kernels it launched and one other kernel of the graph."""
    return ([_range("rtvc.encode.graph", a, b, tid), _copy(a + 1, frames, tid),
             _launch(a + 5, corr, tid)]
            + _kernels(a + 10, durations, corr)
            + _kernels(a + 10 + 2 * sum(durations), [7], corr, "gemm"))


def _want(blocks, durations):
    bound = sum(bound_s(*window_work(*shape, 2, 4))[0] for shape in blocks)
    return 100.0 * bound / (sum(durations) * 1e-6)


def test_the_blocks_of_the_configuration():
    read = _reader()
    assert read.blocks(CONFIG["encoder"], 224, 224, 48) == BLOCKS_B8
    # a map that does not divide by the window is padded to whole windows
    assert read.blocks(CONFIG["encoder"], 256, 256, 1)[:3] == [
        (25, 6, 49, 32), (25, 6, 49, 32), (4, 12, 196, 32)]


def test_k1_over_the_replays_of_the_slice():
    durs = [float(10 + i) for i in range(10)]
    one = _replay(100, 300, 7, [8, 6, 224, 224, 3], durs)
    # a replay of one window: the shapes follow the copy's frames
    durs1 = [4.0] * 10
    two = _replay(400, 500, 8, [1, 6, 224, 224, 3], durs1)
    blocks1 = [(6 * n_w // 48, h, n, d) for n_w, h, n, d in BLOCKS_B8]
    got = _read([SLICE] + one + two)
    want_bound = (_want(BLOCKS_B8, durs) * sum(durs)
                  + _want(blocks1, durs1) * sum(durs1))
    assert got == pytest.approx(want_bound / (sum(durs) + sum(durs1)))
    assert got == pytest.approx(_read([SLICE] + two + one))


def test_launches_outside_a_whole_replay_are_left_out():
    durs = [20.0] * 10
    one = _replay(100, 300, 7, [8, 6, 224, 224, 3], durs)
    want = _want(BLOCKS_B8, durs)
    others = (
        # nine K1 launches: not the blocks of a replay
        _replay(400, 500, 8, [8, 6, 224, 224, 3], [5.0] * 9)
        # K1 launched by an eager call, outside any replay
        + [_launch(600, 9)] + _kernels(610, [3.0], 9)
        # a replay cut by the slice's end
        + _replay(950, 1100, 10, [8, 6, 224, 224, 3], [2.0] * 10))
    assert _read([SLICE] + one + others) == pytest.approx(want)


def test_no_replay_no_reading():
    eager = [_launch(600, 9)] + _kernels(610, [3.0] * 10, 9)
    assert _read([SLICE] + eager) is None
    assert _read([SLICE]) is None
    assert _read(None) is None


def test_the_benchmark_declares_the_reader():
    spec = json.loads((core.BENCH_DIR.parent / "BENCHMARK.json")
                      .read_text())
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert (m["source"], m["layer"], m["unit"], m["better"]) == (
        "device_trace", "kernels", "%", "higher")
    assert (m["moves"], m["workloads"]) == ("caption_windows_per_s",
                                            ["caption-archive-closed16"])


def test_a_traced_tiny_run_on_the_cpu_leaves_it_out(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    bench = tiny.layout(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"] = [
        {"name": NAME, "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "test", "moves": "setup_s",
         "workloads": ["tiny-archive"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = core.execute(tiny.run(bench, "tiny-archive", seconds=3.0,
                                trace=True))
    assert out["correct"] is True, out["checks"]
    assert NAME not in out["metrics"]
