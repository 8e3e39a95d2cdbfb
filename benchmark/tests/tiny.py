"""Tiny configurations of the benchmark's two models, and a folder laid
out as a checkout's ``benchmark/`` that holds them, for CPU runs of the
harness."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from benchlib import core

STUDENT = {
    "name": "tiny-student", "source": "test", "dtype": "float32",
    "num_frames": 2, "max_len": 6, "decode": "greedy",
    "encoder": {"name": "tiny", "input_size": 224,
                "embed_dims": [8, 16, 16, 24], "depths": [1, 1, 2, 1],
                "num_heads": [1, 2, 2, 3], "window_sizes": [7, 7, 14, 7],
                "mlp_ratio": 2.0, "mbconv_expand_ratio": 2.0,
                "drop_path_rate": 0.2, "dropout": 0.0,
                "gelu_approximate": True},
    "decoder": {"d_model": 24, "n_head": 2, "d_ffn": 32, "dropout": 0.3,
                "num_decoder_layers": 2, "vocab_size": 160,
                "cls_token_id": 101, "sep_token_id": 102,
                "max_pos_len": 64},
    "distill_heads": {"teacher_visual_dim": 16, "teacher_num_tokens": 514,
                      "teacher_hidden": 16},
}

TEACHER = {
    "name": "tiny-distill", "source": "test", "dtype": "float32",
    "teacher": {"clip": {"name": "tiny", "image_size": 224,
                         "patch_size": 14, "width": 16, "layers": 2,
                         "heads": 2},
                "hidden_size": 16, "num_layers": 1, "attention_heads": 2,
                "feedforward_size": 32, "visual_feature_size": 16,
                "vocab_size": 160, "max_caption_length": 64,
                "num_image_with_embedding": 2},
    "student": {k: v for k, v in STUDENT.items()
                if k not in ("name", "source")},
    "train": {"batch_size": 2, "frames": 2, "caption_len": 8, "lr": 1e-3,
              "losses": {"kl": 1.0, "ce": 1.0}, "temperature": 1.0,
              "optimizer": "adam",
              "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8},
              "dtype": "float32", "master_dtype": "float32"},
}

GAP = {"logit_gap": 1e-3, "head_err_rms": 1e-4}
TRAIN = {"update_norm_gap": 1e-3, "teacher_err_rms": 1e-4}

WORKLOADS = {
    "tiny-realtime": {"config": "tiny-student", "driver": "stream_closed",
                      "traffic": {"loop": "closed", "clients": 1, "pool": 4,
                                  "frame": [224, 224, 3],
                                  "warm_requests": 1},
                      "check": {"sample": 3, "keep_calls": 4,
                                "limits": GAP}},
    "tiny-archive": {"config": "tiny-student", "driver": "server_closed",
                     "traffic": {"loop": "closed", "clients": 4, "pool": 6,
                                 "frame": [224, 224, 3], "max_batch": 2,
                                 "max_wait_ms": 2.0, "buckets": [1, 2]},
                     "check": {"sample": 16, "keep_calls": 4,
                               "limits": GAP}},
    "tiny-distill": {"config": "tiny-distill", "driver": "train_step",
                     "traffic": {"loop": "closed", "pool": 3,
                                 "frame": [224, 224, 3], "caption_min": 3,
                                 "caption_max": 8},
                     "check": {"limits": TRAIN}},
}

E2E = [
    {"name": "caption_p95_ms", "unit": "ms", "better": "lower",
     "bound": 0.25, "source": "host_clock",
     "workloads": ["tiny-realtime"]},
    {"name": "caption_windows_per_s", "unit": "windows/s",
     "better": "higher", "bound": 0.25, "source": "host_clock",
     "workloads": ["tiny-archive"]},
    {"name": "train_clips_per_s", "unit": "clips/s", "better": "higher",
     "bound": 0.25, "source": "host_clock", "workloads": ["tiny-distill"]},
    {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
     "source": "host_clock"},
]


def layout(root: Path, workloads=None, configs=None) -> Path:
    """Write a ``benchmark/`` folder under ``root`` with the tiny
    configurations and cells; return it."""
    bench = root / "benchmark"
    (bench / "configs").mkdir(parents=True, exist_ok=True)
    (bench / "workloads").mkdir(exist_ok=True)
    configs = configs or {"tiny-student": STUDENT, "tiny-distill": TEACHER}
    workloads = workloads or WORKLOADS
    for name, cfg in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, wl in workloads.items():
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    spec = {"command": ["python3", "benchmark/run.py"],
            "paths": ["benchmark"], "run_seconds": 1,
            "configs": [{"name": n, "source": "test",
                         "file": f"benchmark/configs/{n}.json",
                         "reduced": [], "why": "test"} for n in configs],
            "workloads": [{"name": n, "config": wl["config"],
                           "traffic": n, "chips": 1, "why": "test"}
                          for n, wl in workloads.items()],
            "end_to_end": copy.deepcopy(E2E), "per_layer": []}
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def run(bench: Path, name: str, seed: int = 7, seconds: float = 0.6,
        trace: bool = False) -> core.Run:
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    return core.Run(name, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), roots=[bench, core.BENCH_DIR],
                    bench=spec)
