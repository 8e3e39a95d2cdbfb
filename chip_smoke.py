#!/usr/bin/env python3
"""Drive the PyTorch port's caption step once on an NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``rtvc_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``build/`` and load it;
3. kernels: K1 (window attention), K2 (LayerNorm) and K3 (int8 GEMV) at
   the caption step's shapes, in bfloat16 and float32, each held against
   its plain PyTorch version on the card and timed against it with CUDA
   events;
4. slice: the full-width student (random weights from a seeded generator,
   bfloat16) serves 8 distinct 480×640 6-frame windows at batch 1 and as
   one batch of 8, through the default and the ``vocab_int8`` caption
   steps. The kernels' launch counts are reset just before and read just
   after; every kernel of the path must have launched. Then, in float32
   with TF32 off, the card's encoder memory, first-step logits and token
   rows are held against the same step run on the CPU (plain versions).

It prints the kernels' record as one JSON line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

SEED = 0
MAX_LEN = 25
WINDOWS = 8
FRAMES = 6
FRAME_HW = (480, 640)
# kernel vs plain on the card: max|diff| <= TOL * max(1, max|plain|). f32:
# the same float32 arithmetic summed in another order. bf16: both round one
# float32 result to bfloat16, which can differ by one bf16 ulp (2^-8 of the
# value) where the float32 results straddle a rounding boundary.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# card vs CPU, float32, TF32 off: the full 14-stage encoder and 2-layer
# decoder with every sum in another order
SLICE_TOL = 1e-3

KERNELS = {
    "window_attention": ("rtvc_tpu_torch/csrc/window_attention.cu",
                         "rtvc_tpu/ops/attention.py:766"),
    "layer_norm": ("rtvc_tpu_torch/csrc/layer_norm.cu",
                   "rtvc_tpu/ops/layernorm.py:40"),
    "w8_matmul": ("rtvc_tpu_torch/csrc/w8_matmul.cu",
                  "rtvc_tpu/ops/int8_gemm.py:169"),
}


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` on the device, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple:
    """(max |got - want|, that divided by max(1, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(1.0, float(want.float().abs().max()))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev, g):
    """(kernel name, label, kernel call, plain call) at the caption step's
    shapes: TinyViT window attention per stage at batch 1 and 8 (6-frame
    windows), the decoder's [B, 576] norms and TinyViT's stage-1 norm, the
    vocab GEMV at 1 and 8 rows."""
    import torch
    from rtvc_tpu_torch.ops import attention, int8_gemm, layernorm

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).removeprefix("torch.")
        for batch in (1, 8):
            for stage, (nw, h, n) in enumerate(
                    ((16, 6, 49), (1, 12, 196), (1, 18, 49)), start=1):
                b = batch * FRAMES * nw
                q, k, v = (rand(b, h, n, 32, dtype=dtype) for _ in range(3))
                bias = rand(h, n, n, scale=0.5)
                kw = dict(softmax_in_input_dtype=True)
                cases.append((
                    "window_attention",
                    f"{dn} stage{stage} b{batch} [{b},{h},{n},32]",
                    lambda q=q, k=k, v=v, bias=bias, kw=kw:
                        attention.window_attention(q, k, v, bias, **kw),
                    lambda q=q, k=k, v=v, bias=bias, kw=kw:
                        attention.window_attention_plain(q, k, v, bias,
                                                         **kw)))
        for rows, width in ((8, 576), (8 * 25, 576),
                            (8 * FRAMES * 28 * 28, 192)):
            x = rand(rows, width, dtype=dtype, scale=2.0)
            w, bb = rand(width, dtype=dtype), rand(width, dtype=dtype)
            cases.append((
                "layer_norm", f"{dn} [{rows},{width}]",
                lambda x=x, w=w, bb=bb: layernorm.layer_norm(x, w, bb),
                lambda x=x, w=w, bb=bb: layernorm.layer_norm_plain(x, w, bb)))
        wq = torch.randint(-127, 128, (576, 31744), generator=g,
                           dtype=torch.int8).to(dev)
        sw = (torch.rand(31744, generator=g) / (127 * 24)).to(dev)
        bb = rand(31744, scale=0.1)
        for m in (1, 8):
            x = rand(m, 576, dtype=dtype)
            cases.append((
                "w8_matmul", f"{dn} M={m} [576,31744]",
                lambda x=x: int8_gemm.w8_matmul(x, wq, sw, bb),
                lambda x=x: int8_gemm.w8_matmul_plain(x, wq, sw, bb)))
    return cases


def kernel_phase(dev):
    import torch
    g = torch.Generator().manual_seed(SEED)
    records = []
    for name, label, kern, plain in kernel_cases(dev, g):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        dtype = str(want.dtype).removeprefix("torch.")
        err, rel = rel_err(got, want)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        ok = rel <= TOL[dtype] and bool(torch.isfinite(got).all())
        log(f"  {name:17s} {label:38s} max_abs_err {err:.3e} (tol "
            f"{TOL[dtype]:g} rel) kernel {ms * 1e3:9.2f} us  plain "
            f"{plain_ms * 1e3:9.2f} us  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees with "
                                 f"its plain version ({err:.3e})")
        records.append(dict(name=name, case=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms))
    return records


# ---------------------------------------------------------------------------
# phase 4: the caption step
# ---------------------------------------------------------------------------

def make_windows(g):
    """8 distinct uint8 BGR windows [8, 6, 480, 640, 3]: smooth random
    scenes (a coarse grid upsampled) plus pixel noise, each at its own
    brightness."""
    import torch
    import torch.nn.functional as F
    coarse = torch.rand(WINDOWS * FRAMES, 3, 12, 16, generator=g)
    scene = F.interpolate(coarse, size=FRAME_HW, mode="bilinear",
                          align_corners=False)
    noise = torch.rand(WINDOWS * FRAMES, 3, *FRAME_HW, generator=g)
    level = torch.linspace(0.3, 1.0, WINDOWS).repeat_interleave(FRAMES)
    img = (0.8 * scene + 0.2 * noise) * level[:, None, None, None] * 255
    return (img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
            .reshape(WINDOWS, FRAMES, *FRAME_HW, 3).contiguous())


def check_rows(rows, vocab: int, cls_id: int) -> None:
    import torch
    if rows.dtype != torch.int32 or rows.shape[1] != 1 + MAX_LEN:
        raise AssertionError(f"rows {rows.dtype} {tuple(rows.shape)}")
    if not bool((rows[:, 0] == cls_id).all()):
        raise AssertionError("rows must start with CLS")
    if not bool(((rows >= 0) & (rows < vocab)).all()):
        raise AssertionError("token ids out of range")


def decode_steps(rows, sep_id: int) -> int:
    """Decode iterations the greedy loop ran (it stops when all rows SEP)."""
    for i in range(1, rows.shape[1]):
        if bool((rows[:, i] == sep_id).all()):
            return i
    return rows.shape[1] - 1


def counts():
    from rtvc_tpu_torch.ops import attention, int8_gemm, layernorm
    return {"window_attention": attention.window_attention.launches,
            "layer_norm": layernorm.layer_norm.launches,
            "w8_matmul": int8_gemm.w8_matmul.launches}


def reset_counts() -> None:
    from rtvc_tpu_torch.ops import attention, int8_gemm, layernorm
    for fn in (attention.window_attention, layernorm.layer_norm,
               int8_gemm.w8_matmul):
        fn.launches = 0


def serve(student, windows, vocab_int8: bool):
    """The main path: 8 windows one by one, then as one batch of 8.
    Returns (rows at batch 1, rows at batch 8, ms per window at batch 1,
    ms per window at batch 8, launch counts of this run)."""
    import torch
    from rtvc_tpu_torch.serving import make_caption_step
    step = make_caption_step(student, max_len=MAX_LEN, vocab_int8=vocab_int8)
    for i in range(WINDOWS):   # warm-up pass: cuDNN, allocator, clocks
        step(windows[i:i + 1])
    step(windows)
    torch.cuda.synchronize()
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    rows1, ms1 = [], []
    for i in range(WINDOWS):
        ev[0].record()
        rows1.append(step(windows[i:i + 1]))
        ev[1].record()
        torch.cuda.synchronize()
        ms1.append(ev[0].elapsed_time(ev[1]))
    ev[0].record()
    rows8 = step(windows)
    ev[1].record()
    torch.cuda.synchronize()
    launched = counts()
    log(f"  batch-1 ms per window: {[round(t, 3) for t in ms1]}")
    return (torch.cat(rows1).cpu(), rows8.cpu(), sum(ms1) / WINDOWS,
            ev[0].elapsed_time(ev[1]) / WINDOWS, launched)


def part_times(student, windows, vocab_int8: bool) -> dict:
    """Device ms of preprocess, encode and the whole step for one batch;
    decode is the rest, per token over the iterations the loop ran."""
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    from rtvc_tpu_torch.serving import make_caption_step
    import torch
    b = windows.shape[0]
    flat = windows.reshape((b * FRAMES,) + windows.shape[2:])
    pre = cuda_ms(lambda: clip_preprocess(flat), reps=5, warmup=1)
    proc = clip_preprocess(flat).reshape((b, FRAMES, 224, 224, 3))
    with torch.inference_mode():
        enc = cuda_ms(lambda: student.forward_image_enc(proc), reps=5,
                      warmup=1)
    step = make_caption_step(student, max_len=MAX_LEN, vocab_int8=vocab_int8)
    total = cuda_ms(lambda: step(windows), reps=3, warmup=1)
    steps = decode_steps(step(windows), student.sep_token_id)
    decode = total - pre - enc
    return dict(batch=b, preprocess_ms=pre, encode_ms=enc, step_ms=total,
                decode_ms=decode, decode_steps=steps,
                decode_ms_per_token=decode / steps)


def first_token_divergence(a, b) -> float:
    """Share of rows whose first generated token differs."""
    return float((a[:, 1] != b[:, 1]).float().mean())


def f32_check(student_f32, windows_cpu, dev) -> dict:
    """The f32 caption step on the card (kernels, TF32 off) against the
    same step on the CPU (plain versions)."""
    import torch
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    from rtvc_tpu_torch.serving import make_caption_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = copy.deepcopy(student_f32).to(dev)
    out = {}
    with torch.inference_mode():
        mem, logits = {}, {}
        for name, model, d in (("cpu", student_f32, "cpu"),
                               ("card", card, dev)):
            w = windows_cpu.to(d)
            flat = w.reshape((WINDOWS * FRAMES,) + w.shape[2:])
            proc = clip_preprocess(flat).reshape(
                (WINDOWS, FRAMES, 224, 224, 3))
            _, mem[name] = model.forward_image_enc(proc)
            caches = model.init_cache(WINDOWS, 1 + MAX_LEN, mem[name])
            cls = torch.full((WINDOWS,), model.cls_token_id,
                             dtype=torch.int32, device=d)
            logits[name], _ = model.decode_step(cls, 0, caches)
        for what, vals in (("memory", mem), ("first_step_logits", logits)):
            err, rel = rel_err(vals["card"].cpu(), vals["cpu"])
            log(f"  f32 card vs cpu {what:18s} max_abs_err {err:.3e} "
                f"(rel {rel:.3e}, tol {SLICE_TOL:g})")
            if not rel <= SLICE_TOL:
                raise AssertionError(f"f32 {what}: card and CPU disagree")
            out[f"{what}_max_abs_err"] = err
    rows_cpu = make_caption_step(student_f32, max_len=MAX_LEN)(windows_cpu)
    rows_card = make_caption_step(card, max_len=MAX_LEN)(
        windows_cpu.to(dev)).cpu()
    out["rows_cpu"] = rows_cpu
    out["f32_first_token_divergence"] = first_token_divergence(rows_card,
                                                               rows_cpu)
    return out


def slice_phase(dev) -> dict:
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.models.student import random_init_, student_from_config
    from rtvc_tpu_torch.serving import truncate_at_sep, with_vocab_w8

    g = torch.Generator().manual_seed(SEED)
    student_f32 = random_init_(student_from_config(cfg), g).eval()
    windows_cpu = make_windows(g)
    windows = windows_cpu.to(dev)
    student = copy.deepcopy(student_f32).to(dev, cfg.dtype)
    with_vocab_w8(student)
    vocab, cls_id = cfg.student.vocab_size, cfg.student.cls_token_id
    result = {"compute_dtype": cfg.compute_dtype, "launches": {}}
    for mode, vocab_int8 in (("default", False), ("vocab_int8", True)):
        rows1, rows8, ms1, ms8, launched = serve(student, windows, vocab_int8)
        for rows in (rows1, rows8):
            check_rows(rows, vocab, cls_id)
        same = sum(
            list(truncate_at_sep(a.numpy())) == list(truncate_at_sep(b.numpy()))
            for a, b in zip(rows1, rows8)) / WINDOWS
        log(f"  {mode:10s} launches {launched}")
        log(f"  {mode:10s} ms/window batch 1 {ms1:.3f}  batch 8 {ms8:.3f}  "
            f"batch-1 rows equal to batch-8 rows: {same:.3f}")
        for i, row in enumerate(rows1.tolist()):
            log(f"  {mode:10s} window {i} tokens {row}")
        need = ["window_attention", "layer_norm"] + (
            ["w8_matmul"] if vocab_int8 else [])
        missing = [k for k in need if launched[k] == 0]
        if missing:
            raise AssertionError(f"{mode} caption step never launched "
                                 f"{missing}")
        for k, n in launched.items():
            result["launches"][k] = result["launches"].get(k, 0) + n
        parts = [part_times(student, windows[:b], vocab_int8)
                 for b in (1, WINDOWS)]
        for p in parts:
            log(f"  {mode:10s} parts {json.dumps(p)}")
        result[mode] = dict(ms_per_window_b1=ms1, ms_per_window_b8=ms8,
                            b1_equals_b8=same, rows_b1=rows1.tolist(),
                            parts=parts)
    f32 = f32_check(student_f32, windows_cpu, dev)
    bf16_vs_cpu = first_token_divergence(
        torch.tensor(result["default"]["rows_b1"]), f32.pop("rows_cpu"))
    log(f"  first-token divergence, f32 card vs f32 cpu: "
        f"{f32['f32_first_token_divergence']:.3f}; bf16 card vs f32 cpu: "
        f"{bf16_vs_cpu:.3f}")
    result.update(f32, bf16_first_token_divergence_vs_f32_cpu=bf16_vs_cpu)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every measurement to this "
                                  "JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rtvc_tpu_torch import _build  # fails outside the repository
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {len(_build.sources())} sources -> "
        f"{_build.library_path().name} in {time.perf_counter() - t0:.1f} s")

    log("[kernels] kernel vs plain on the card")
    records = kernel_phase(dev)
    log("[slice] full-width student, caption steps")
    sl = slice_phase(dev)

    # the row per kernel: its largest error over all cases; its times at the
    # main path's heaviest bf16 batch-8 case
    primary = {"window_attention": "bfloat16 stage1 b8",
               "layer_norm": "bfloat16 [200,576]",
               "w8_matmul": "bfloat16 M=8"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        head = next(r for r in mine if r["case"].startswith(primary[name]))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sl["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=head["ms"], plain_ms=head["plain_ms"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, kernels=kernels, cases=records,
                           slice=sl), f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
