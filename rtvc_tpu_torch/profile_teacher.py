"""Where the teacher's device time goes, on a CUDA card.

    python -m rtvc_tpu_torch.profile_teacher [--top 22]

Run from the repository root. Builds the full-width bf16 teacher of
``teacher_from_config(cfg)`` from a seeded generator and prints, for the
forward at batch 8 (40 caption tokens, taps at blocks 0, 6, 12, 18), the
same on its W8A8 copy and ``teacher_beam`` at batch 2: the device time by
op from one ``torch.profiler`` pass, then the CUDA-event ms of 3 calls.
Then each of K4-K7 beside the library op that computes the same thing at
the teacher's shapes (CUDA-event µs per call): K4 and K5 beside
``F.scaled_dot_product_attention``, K6 beside add + ``F.layer_norm``, K7
beside ``quantize_activations`` and the bf16 ``nn.Linear`` it replaces.
"""

from __future__ import annotations

import argparse
import copy

import torch
import torch.nn.functional as F

from .config import cfg
from .decode import teacher_beam
from .models.git_teacher import random_init_, teacher_from_config
from .ops import attention, int8_gemm, layernorm
from .ops.preprocess import clip_preprocess
from .ops.quantization import quantize_activations, quantize_teacher_

TAPS = (0, 6, 12, 18)


def cuda_us(fn, reps: int = 20) -> float:
    """Mean µs per call of ``fn`` from CUDA events, after 2 warm-up calls."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


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
        print(f"=== {label}: device busy {busy:.3f} ms over {n} kernels")
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
    print(f"  CUDA-event ms, 3 calls: {walls}", flush=True)


def library_beside_kernels(dev) -> None:
    bf = torch.bfloat16
    qkv = torch.randn(8, 1582, 2304, device=dev, dtype=bf)
    q, k, v = (t.transpose(1, 2)
               for t in qkv.view(8, 1582, 3, 12, 64).unbind(2))
    allowed = attention._allowed(1582, 1582, True, 1542, None, dev)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    print("K4 joint [8,12,1582,64] prefix 1542:",
          cuda_us(lambda: attention.flash_attention(
              q, k, v, causal=True, prefix_len=1542)),
          "us; SDPA with a bool mask:",
          cuda_us(lambda: F.scaled_dot_product_attention(
              qc, kc, vc, attn_mask=allowed)), "us")
    views = torch.randn(48, 257, 3072, device=dev, dtype=bf).view(
        48, 257, 3, 16, 64).unbind(2)
    heads = [t.transpose(1, 2) for t in views]
    print("K5 CLIP [48,257,16,64]:",
          cuda_us(lambda: attention.blhd_attention(*views)),
          "us; SDPA with the head transposes:",
          cuda_us(lambda: F.scaled_dot_product_attention(
              *[t.contiguous() for t in heads]).transpose(1, 2).contiguous()),
          "us")
    x = torch.randn(12336, 1024, device=dev, dtype=bf)
    d = torch.randn_like(x)
    w = torch.ones(1024, device=dev, dtype=bf)
    b = torch.zeros(1024, device=dev, dtype=bf)
    print("K6 [12336,1024]:",
          cuda_us(lambda: layernorm.fused_add_layer_norm(x, d, w, b), 50),
          "us; add + F.layer_norm:",
          cuda_us(lambda: F.layer_norm(x + d, (1024,), w, b, 1e-5), 50),
          "us")
    lin = torch.nn.Linear(1024, 3072).to(dev, bf)
    ql = quantize_teacher_(torch.nn.Sequential(copy.deepcopy(lin)))[0]
    xq, sx = quantize_activations(x)
    print("K7 CLIP fc M=12336 [1024->3072]:",
          cuda_us(lambda: int8_gemm.w8a8_matmul(
              xq, sx.reshape(-1), ql.weight_q.t(), ql.weight_scale, ql.bias,
              bf)),
          "us; quantize_activations:",
          cuda_us(lambda: quantize_activations(x)),
          "us; bf16 nn.Linear:", cuda_us(lambda: lin(x)), "us", flush=True)


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
    teacher = random_init_(teacher_from_config(cfg), g).eval().to(dev)
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
    library_beside_kernels(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
