"""One short run of a cell on the card, through the command the checks
run, its last line read back. Skips where there is no card:

    python -m pytest benchmark/tests -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "caption-archive-closed16", "--seed", str(2 ** 31 + 9),
         "--seconds", "6", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert ("breakdown" in line) == bool(trace)


def test_no_card_no_result(tmp_path):
    """Without CUDA the command prints no result and exits non-zero (on a
    machine with a card, hide it)."""
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "caption-archive-closed16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
