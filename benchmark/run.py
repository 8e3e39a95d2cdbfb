#!/usr/bin/env python3
"""Run one cell of the benchmark once:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``rtvc_tpu_torch``)
and ``BENCHMARK.json``. The compile caches are kept at fixed paths inside
the checkout (the kernels' ``build/``, and ``benchmark/.cache/``), so
only a checkout's first run builds.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

from benchlib import core  # noqa: E402  (the standard library only)

T_START = time.perf_counter() - core.process_age_s()

from benchlib import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(t_start=T_START))
