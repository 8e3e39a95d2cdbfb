"""``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the cards of this machine.

The last line of standard output is the result (``core.result``); the
numbers compared for ``correct`` end standard error, each beside its
limit. The run exits with 3, and prints no result, without CUDA or with
fewer cards than the cell asks for, and with 4 if ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import List, Optional

from . import core


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv: Optional[List[str]] = None, t_start: float = None) -> int:
    if t_start is None:
        t_start = time.perf_counter() - core.process_age_s()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    bench = core.load_json(core.BENCH_DIR.parent / "BENCHMARK.json")
    chips = int(core.find(bench["workloads"], a.workload,
                          "workload").get("chips", 1))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"needs {chips} CUDA device(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    core.log(f"card: {power_limit()}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    run = core.Run(a.workload, a.seed, a.seconds, bool(a.trace),
                   torch.device("cuda", 0), t_start, bench=bench)
    out = core.execute(run)
    bad = core.forbidden_modules()
    if bad:
        core.log(f"modules that must not load were loaded: {bad}")
        return 4
    for name, c in out["checks"].items():
        core.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
