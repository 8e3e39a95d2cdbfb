"""One run of one cell: the records a driver fills, the discovery of the
files a cell names, and the result line.

A cell's files are found by name under the benchmark's folder:
``workloads/<cell>.json`` names its configuration, its driver and its
traffic; ``drivers/<driver>.py`` runs the traffic loop; every metric the
cell reports has ``metrics/<metric>.py``, whose ``read(run)`` returns a
number or None. A new cell, driver or metric is new files and a new
``BENCHMARK.json`` entry: nothing here lists them.

A driver module has three functions:

- ``setup(run)`` builds the program and warms up the cell's shapes, and
  returns its state; the run's ``setup_s`` ends when it returns;
- ``measure(run, state, seconds, records)`` drives the cell's traffic for
  ``seconds`` and fills ``records``;
- ``check(run, state)`` frees the program's state, runs the reference, and
  returns each compared number with its limit: ``{name: (value,
  limit)}``; the run is correct where every value is at most its limit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rtvc_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Records:
    """What one stretch of traffic left: requests, latencies, work and, in
    the measured part of a traced run, spans."""

    def __init__(self, spans: bool = False):
        self.spans_on = spans
        self.window_s = 0.0
        self.attempted = 0
        self.failed = 0
        self.completed = 0
        self.latencies_s: List[float] = []
        self.flops = 0.0
        self.clips = 0
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.served: List[Tuple[int, Any]] = []


class Run:
    """Everything one run knows: its arguments, its cell's files, and what
    it measured."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device, t_start: float, roots: Optional[List[Path]] = None,
                 bench: Optional[dict] = None):
        self.name = name
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.roots = list(roots or [BENCH_DIR])
        self.bench = bench if bench is not None else load_json(
            BENCH_DIR.parent / "BENCHMARK.json")
        self.cell = find(self.bench["workloads"], name, "workload")
        self.workload = load_json(self.path("workloads", f"{name}.json"))
        entry = find(self.bench["configs"], self.cell["config"], "config")
        self.config = load_json(self.path_of(entry["file"]))
        self.setup_s: Optional[float] = None
        self.records = Records()
        self.trace_data = None
        self.memory_peak_bytes = 0
        self.checks: Dict[str, Tuple[float, float]] = {}

    # ---- files ------------------------------------------------------------
    def path(self, *parts: str) -> Path:
        """The first of the roots that holds ``parts``."""
        for root in self.roots:
            p = root.joinpath(*parts)
            if p.exists():
                return p
        raise FileNotFoundError("/".join(parts))

    def path_of(self, repo_relative: str) -> Path:
        """A path from ``BENCHMARK.json`` (relative to the repository),
        looked for under each root's parent."""
        for root in self.roots:
            p = root.parent / repo_relative
            if p.exists():
                return p
        raise FileNotFoundError(repo_relative)

    def module(self, kind: str, name: str):
        return load_module(self.path(kind, f"{name}.py"), f"{kind}.{name}")

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["check"]["limits"]

    @property
    def on_card(self) -> bool:
        return str(self.device).startswith("cuda")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, label: str):
    key = "bench_" + "".join(c if c.isalnum() else "_" for c in label)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_entries(run: Run, kind: str) -> List[dict]:
    """The ``kind`` metrics (``end_to_end`` or ``per_layer``) this cell
    reports."""
    return [m for m in run.bench[kind]
            if "workloads" not in m or run.name in m["workloads"]]


def sync(run: Run) -> None:
    if run.on_card:
        import torch
        torch.cuda.synchronize()


def execute(run: Run) -> dict:
    """Set up, measure (and trace), check; return the result line."""
    import torch

    from . import trace as trace_lib

    driver = run.module("drivers", run.workload["driver"])
    state = driver.setup(run)
    sync(run)
    run.setup_s = time.perf_counter() - run.t_start
    log(f"setup_s {run.setup_s:.3f}")
    if run.trace:
        slice_s = min(float(run.workload.get("trace_seconds", 2.0)),
                      run.seconds / 2)
        run.records = Records(spans=True)
        driver.measure(run, state, run.seconds - slice_s, run.records)
        run.trace_data = trace_lib.profile(
            lambda: driver.measure(run, state, slice_s, Records()))
    else:
        run.records = Records()
        driver.measure(run, state, run.seconds, run.records)
    r = run.records
    if r.latencies_s:
        lat = sorted(r.latencies_s)
        log(f"window: {r.attempted} attempted, {r.completed} completed in "
            f"{r.window_s:.3f} s; latency ms p50 {lat[len(lat) // 2] * 1e3:.3f}"
            f", max {lat[-1] * 1e3:.3f}")
    if run.on_card:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    run.checks = driver.check(run, state)
    del state
    return result(run)


def limited(run: Run, values: Dict[str, float]
            ) -> Dict[str, Tuple[float, float]]:
    """The numbers of ``values`` that the cell gives a limit, each with
    it; the others are logged."""
    lim = run.limits
    missing = sorted(set(lim) - set(values))
    if missing:
        raise KeyError(f"limits for numbers the check has not: {missing}")
    for k in sorted(set(values) - set(lim)):
        log(f"read, not compared: {k} {values[k]!r}")
    return {k: (float(values[k]), float(lim[k])) for k in lim}


def judge(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Correct: something was compared, and every number is at most its
    limit."""
    return bool(checks) and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())


def _value(x):
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


def result(run: Run) -> dict:
    kind = "per_layer" if run.trace else "end_to_end"
    metrics: Dict[str, dict] = {}
    for m in metric_entries(run, kind):
        value = _value(run.module("metrics", m["name"]).read(run))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = judge(run.checks)
    device: Dict[str, Any] = {"platform": "gpu" if run.on_card else "cpu",
                              "kind": device_kind(run),
                              "count": int(run.cell.get("chips", 1)),
                              "memory_peak_bytes": run.memory_peak_bytes}
    out: Dict[str, Any] = {"correct": correct,
                           "attempted": int(run.records.attempted),
                           "failed": int(run.records.failed),
                           "metrics": metrics, "device": device}
    if run.trace and run.trace_data is not None:
        device["busy_s"] = run.trace_data.busy_s
        device["window_s"] = run.trace_data.window_s
        out["breakdown"] = {"device_ops": run.trace_data.device_ops(),
                            "idle_gaps": run.trace_data.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def device_kind(run: Run) -> str:
    if run.on_card:
        import torch
        return torch.cuda.get_device_name(0)
    return "cpu"


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0
