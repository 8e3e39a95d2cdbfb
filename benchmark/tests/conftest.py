"""The benchmark's CPU tests: the harness's folder and the repository's
root on the path, as ``benchmark/run.py`` puts them."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for path in (os.path.dirname(BENCH), BENCH, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)
