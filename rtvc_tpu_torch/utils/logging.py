"""Run logging: append-only run text file + scalar channel (+ optional wandb).

A copy of ``rtvc_tpu/utils/logging.py``, its code unchanged: importing
``rtvc_tpu`` imports jax. tests/test_torch_pruning.py holds the
copy's run file and ``scalars.jsonl`` equal to the original's.

Mirrors the reference's three logging channels (SURVEY.md §5): the
``_results_and_metrics.txt`` run file with a config header
(reference model.py:841,864-878) and per-epoch GT/prediction/BLEU
transcripts (model.py:1027-1033), Lightning-style scalar logging
(model.py:985-987), and wandb (train.py:70-73) — which is optional and
offline-gated here (wandb is optional: the hook is a no-op unless it is
installed).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping, Optional


class RunLogger:
    def __init__(self, run_dir: str, run_name: str = "run",
                 config_dump: Optional[Mapping[str, Any]] = None,
                 use_wandb: bool = False, wandb_mode: str = "offline"):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.filename = "_results_and_metrics.txt"
        self.filepath = os.path.join(run_dir, self.filename)
        self.scalars_path = os.path.join(run_dir, "scalars.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # noqa: F401
                os.environ.setdefault("WANDB_MODE", wandb_mode)
                self._wandb = wandb.init(project="rtvc_tpu", name=run_name,
                                         dir=run_dir)
            except Exception as e:
                # requested-but-unavailable must be visible, not silent
                import warnings
                warnings.warn(f"wandb logging requested but unavailable: {e}")
                self._wandb = None

        if config_dump is not None:
            # config header, reference model.py:864-878 format
            with open(self.filepath, "a") as f:
                f.write(f"Results for the run: {self.filename}\n")
                f.write("\n************************************\n")
                f.write("\n" * 2)
                for key, value in config_dump.items():
                    f.write(f"{key}: {value}\n")
                f.write("\n" * 2)

    def write(self, text: str) -> None:
        with open(self.filepath, "a") as f:
            f.write(text)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": step, "time": time.time(),
                  **{k: float(v) for k, v in scalars.items()}}
        with open(self.scalars_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_epoch_transcript(self, split: str, epoch: int, gt, preds,
                             bleu4: float) -> None:
        """Per-epoch transcript block (reference model.py:1027-1033)."""
        with open(self.filepath, "a") as f:
            f.write("\n" * 2)
            f.write(f"{split} Results\n")
            f.write(f"Epoch: {epoch}\n")
            f.write(f"Ground-Truth Captions: {gt}\n")
            f.write(f"Student Predictions: {preds}\n")
            f.write(f"BLEU@4: {bleu4}\n")

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
