"""A cell, a driver and a metric added as new files, with their entries
in BENCHMARK.json, are run without a change to any file there is."""

import json
import textwrap

import tiny
from benchlib import core

DRIVER = textwrap.dedent('''
    """A driver that counts to a number."""
    def setup(run):
        return {"n": int(run.workload["traffic"]["count"])}

    def measure(run, state, seconds, records):
        records.attempted = records.completed = state["n"]
        records.window_s = seconds
        records.spans["echo"].append(float(state["n"]))

    def check(run, state):
        return {"echo": (0.0, float(run.limits["echo"]))}
''')

METRIC = textwrap.dedent('''
    """The driver's count."""
    def read(run):
        spans = run.records.spans.get("echo")
        return spans[0] if spans else None
''')


def test_new_files_are_found_by_name(tmp_path):
    wl = {"tiny-count": {"config": "tiny-student", "driver": "count_up",
                         "traffic": {"count": 41},
                         "check": {"limits": {"echo": 0.0}}}}
    bench = tiny.layout(tmp_path, workloads=wl)
    (bench / "drivers").mkdir()
    (bench / "drivers" / "count_up.py").write_text(DRIVER)
    (bench / "metrics").mkdir()
    (bench / "metrics" / "count.echo.py").write_text(METRIC)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "count.echo", "unit": "n",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["tiny-count"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = core.execute(tiny.run(bench, "tiny-count", seconds=0.1))
    assert out["correct"] is True
    assert out["metrics"]["count.echo"] == {"value": 41.0, "unit": "n"}
    assert out["attempted"] == 41
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"
