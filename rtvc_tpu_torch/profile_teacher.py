"""Where the teacher's device time goes, on a CUDA card, and the student
encoder's and decode's beside it.

    python -m rtvc_tpu_torch.profile_teacher [--top 22] [--decode-only]

Run from the repository root. Builds the full-width bf16 teacher of
``teacher_from_config(cfg)`` from a seeded generator and prints, for the
forward at batch 8 (40 caption tokens, taps at blocks 0, 6, 12, 18), the
same on its W8A8 copy and ``teacher_beam`` at batch 2: the device time by
op from one ``torch.profiler`` pass, the attention kernels' (K4, K5) share
of it, then the CUDA-event ms of 3 calls and the device's busy share of
them. Last the same for the full-width bf16 student's image encoder
(TinyViT-21M, the caption step's encode part) at batch 8, whose attention
kernel is K1. Then the decode of the ``vocab_int8`` caption step at
batch 1 and 8 (8 random 6-frame 480x640 windows, greedy, 25 tokens at
most): its device time per decoded token by kernel, K2 (LayerNorm), K3
(the int8 vocab GEMV), cuBLAS and the rest, and its busy share. The
decode's device work is the whole step's less that of its preprocess and
encode, profiled apart; its wall time likewise. ``--decode-only`` prints
the decode lines alone. Each kernel's library yardstick is timed by
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import copy

import torch

from .config import cfg
from .decode import teacher_beam
from .models.git_teacher import random_init_, teacher_from_config
from .models.student import random_init_ as student_random_init_
from .models.student import student_from_config
from .ops.preprocess import clip_preprocess
from .ops.quantization import quantize_teacher_
from .serving import make_caption_step, with_vocab_w8

TAPS = (0, 6, 12, 18)
# the decode's kernels by name: (label, test on the lower-cased name)
DECODE_KERNELS = (
    ("K2", lambda k: "layer_norm" in k and "add_layer_norm" not in k),
    ("K3", lambda k: "w8_matmul" in k),
    ("cuBLAS", lambda k: any(w in k for w in ("gemm", "gemv", "cublas",
                                                "xmma", "cutlass"))),
    ("rest", lambda k: True))


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
              f"attention kernels {attn:.3f} ms = "
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


def device_work(fn) -> tuple:
    """({kernel name: (device ms, launches)} of one profiled call after a
    warm-up, the mean CUDA-event ms of 3 calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end))
    work = {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return work, sum(walls) / len(walls)


def by_part(work: dict) -> dict:
    """Device ms and launches per DECODE_KERNELS label."""
    parts = {label: [0.0, 0] for label, _ in DECODE_KERNELS}
    for key, (ms, n) in work.items():
        label = next(lb for lb, test in DECODE_KERNELS if test(key.lower()))
        parts[label][0] += ms
        parts[label][1] += n
    return parts


def profile_decode(student, windows) -> None:
    """The decode's device time per token, by kernel, in the vocab_int8
    caption step on ``windows`` [B, 6, H, W, 3] uint8."""
    b = windows.shape[0]
    step = make_caption_step(student, vocab_int8=True)
    flat = windows.reshape((-1,) + windows.shape[2:])
    step_work, step_ms = device_work(lambda: step(windows))
    enc_work, enc_ms = device_work(lambda: student.forward_image_enc(
        clip_preprocess(flat).reshape((b, 6, 224, 224, 3))))
    with torch.inference_mode():
        rows = step(windows)
    sep = rows == student.sep_token_id
    done = [i for i in range(1, rows.shape[1]) if bool(sep[:, i].all())]
    tokens = done[0] if done else rows.shape[1] - 1
    total, enc = by_part(step_work), by_part(enc_work)
    per = {k: ((total[k][0] - enc[k][0]) * 1e3 / tokens,
               (total[k][1] - enc[k][1]) / tokens) for k in total}
    device_us = sum(us for us, _ in per.values())
    wall_us = (step_ms - enc_ms) * 1e3 / tokens
    print(f"=== decode vocab_int8 b{b}: {tokens} tokens; device us per "
          f"token: " + ", ".join(f"{k} {us:.2f} ({n:g} launches)"
                                 for k, (us, n) in per.items())
          + f"; {device_us:.2f} us of device work in {wall_us:.2f} us "
          f"of wall per token, busy {device_us / wall_us:.1%}; K2 "
          f"{per['K2'][0] / device_us:.1%} and K3 "
          f"{per['K3'][0] / device_us:.1%} of the device work", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=22,
                    help="ops listed per run, by device time")
    ap.add_argument("--decode-only", action="store_true",
                    help="profile the caption step's decode alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_teacher: no CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    g = torch.Generator().manual_seed(1)
    windows = torch.randint(0, 256, (8 * 6, 480, 640, 3), generator=g,
                            dtype=torch.uint8).to(dev)
    frames = clip_preprocess(windows).reshape(8, 6, 224, 224, 3)
    student = with_vocab_w8(student_random_init_(
        student_from_config(cfg, device=dev), g).to(cfg.dtype).eval())
    if args.decode_only:
        for b in (1, 8):
            profile_decode(student, windows.reshape(8, 6, 480, 640, 3)[:b])
        return 0
    teacher = random_init_(teacher_from_config(cfg, device=dev), g).eval()
    captions = torch.randint(1000, cfg.teacher.vocab_size, (8, 40),
                             generator=g).to(dev)
    quant = quantize_teacher_(copy.deepcopy(teacher))
    profile_run("forward bf16 b8", lambda: teacher.forward_output_logits(
        frames, captions, TAPS), args.top)
    profile_run("forward W8A8 b8", lambda: quant.forward_output_logits(
        frames, captions, TAPS), args.top)
    profile_run("teacher_beam b2 x 4 beams", lambda: teacher_beam(
        teacher, frames[:2]), args.top)
    del teacher, quant
    profile_run("student encode b8 (K1)",
                lambda: student.forward_image_enc(frames), args.top)
    for b in (1, 8):
        profile_decode(student, windows.reshape(8, 6, 480, 640, 3)[:b])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
