"""Where the teacher's device time goes, on a CUDA card.

    python -m rtvc_tpu_torch.profile_teacher [--top 22]

Run from the repository root. Builds the full-width bf16 teacher of
``teacher_from_config(cfg)`` from a seeded generator and prints, for the
forward at batch 8 (40 caption tokens, taps at blocks 0, 6, 12, 18), the
same on its W8A8 copy and ``teacher_beam`` at batch 2: the device time by
op from one ``torch.profiler`` pass, the attention kernels' (K4, K5) share
of it, then the CUDA-event ms of 3 calls and the device's busy share of
them. Each kernel's library yardstick is timed by ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import copy

import torch

from .config import cfg
from .decode import teacher_beam
from .models.git_teacher import random_init_, teacher_from_config
from .ops.preprocess import clip_preprocess
from .ops.quantization import quantize_teacher_

TAPS = (0, 6, 12, 18)


def profile_run(label: str, fn, top: int) -> None:
    """One warm-up call, one profiled call (self device time by op, the
    ``top`` largest), then 3 calls between CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the device's own entries: an aten op's row repeats its kernels'
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        n = sum(e.count for e in kernels)
        attn = sum(e.self_device_time_total for e in kernels
                   if "attention" in e.key) / 1e3
        print(f"=== {label}: device busy {busy:.3f} ms over {n} kernels; "
              f"attention kernels (K4, K5) {attn:.3f} ms = "
              f"{attn / busy:.1%} of it")
        for e in sorted(kernels,
                        key=lambda e: -e.self_device_time_total)[:top]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x"
                  f"  {e.key[:100]}")
        walls = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end))
    print(f"  CUDA-event ms, 3 calls: {walls}; device busy "
          f"{busy / (sum(walls) / len(walls)):.1%} of their mean",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=22,
                    help="ops listed per run, by device time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_teacher: no CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    g = torch.Generator().manual_seed(1)
    teacher = random_init_(teacher_from_config(cfg, device=dev), g).eval()
    windows = torch.randint(0, 256, (8 * 6, 480, 640, 3), generator=g,
                            dtype=torch.uint8).to(dev)
    frames = clip_preprocess(windows).reshape(8, 6, 224, 224, 3)
    captions = torch.randint(1000, cfg.teacher.vocab_size, (8, 40),
                             generator=g).to(dev)
    quant = quantize_teacher_(copy.deepcopy(teacher))
    profile_run("forward bf16 b8", lambda: teacher.forward_output_logits(
        frames, captions, TAPS), args.top)
    profile_run("forward W8A8 b8", lambda: quant.forward_output_logits(
        frames, captions, TAPS), args.top)
    profile_run("teacher_beam b2 x 4 beams", lambda: teacher_beam(
        teacher, frames[:2]), args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
