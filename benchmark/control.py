#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card:

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3] [--seconds 8]

For each seed, in one process: the cell's set-up, a short window of its
own traffic, and every number its check can compare, judged against the
cell's limits as a run judges them (:mod:`benchlib.controls`); for the
control seeds also the control's and the faults' readings. One JSON line
a seed and reading goes to standard output. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(HERE), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

from benchlib import controls, core  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    a = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        core.log("control.py runs on a card")
        return 3
    chosen = {int(s) for s in a.control_seeds.split(",") if s}
    for s in (int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = core.Run(a.workload, s, a.seconds, False,
                       torch.device("cuda", 0), time.perf_counter())
        read = (controls.train_readings
                if run.workload["driver"] == "train_step"
                else controls.caption_readings)
        for line in read(run, a.seconds, s in chosen):
            print(json.dumps(dict(workload=run.name, seed=s, **line)),
                  flush=True)
        core.log(f"seed {s}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
