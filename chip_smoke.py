#!/usr/bin/env python3
"""Drive the PyTorch port's caption step, frozen teacher and distillation
train step once on an NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``rtvc_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``build/`` and load it;
3. kernels: K1 (window attention), K2 (LayerNorm) and K3 (int8 GEMV) at
   the caption step's shapes, K2, K4 (flash attention), K5 (BLHD
   attention), K6 (add + LayerNorm) and K7 (W8A8 GEMM) at the teacher's,
   K4 with dropout, K8 (flash backward, with and without dropout) and K9
   (depthwise 3x3 weight gradient) at the train step's, in bfloat16 and
   float32, each held against its plain PyTorch version on the card and
   timed against it and its library yardstick, each as a replayed CUDA
   graph of back-to-back calls. Then K8's one caller, the gradient
   of ``flash_attention`` through autograd, runs once at the joint shape
   with dropout, launch counts reset before and read after;
4. slice: the full-width student (random weights from a seeded generator,
   bfloat16) serves 8 distinct 480×640 6-frame windows at batch 1 and as
   one batch of 8, through the default and the ``vocab_int8`` caption
   steps. The kernels' launch counts are reset just before and read just
   after; every kernel of the path must have launched. Then, in float32
   with TF32 off, the card's encoder memory, first-step logits and token
   rows are held against the same step run on the CPU (plain versions);
5. teacher: the full-width GIT-Large teacher (CLIP ViT-L/14 + the 6-layer
   joint decoder, random weights from a seeded generator, bfloat16) runs
   ``forward_output_logits`` on 8 preprocessed windows with 40-token
   captions and four encoder taps, then the same on its W8A8 copy
   (``quantize_teacher_``), then ``teacher_beam`` (batch 2, 4 beams, 15
   steps) and ``teacher_kd_targets``. Launch counts are reset before and
   read after each run and must equal the layer counts. One more W8A8
   forward holds every K7 launch in it against the plain version on the
   same input. Then, in float32 with TF32 off, a depth-cut teacher (2 CLIP
   blocks, 2 joint layers, full widths) on the card is held against the
   same model on the CPU;
6. train: the full-width student (bfloat16 compute over float32 master
   weights) and the full-width teacher run 5 steps of the default
   ``make_train_step`` (kl + ce, dropout 0.3, DropPath, Adam at lr 1e-4)
   on 8 preprocessed windows with 40-token captions, printing each step's
   time and parts, losses, gradient norm and peak memory. Every parameter
   the loss reaches must get a finite gradient, nonzero somewhere, and
   only the distillation heads that kl + ce leave unused none; launch
   counts must equal the layer counts. Then one float32 step (TF32 off,
   one window, no dropout, the teacher cut to 2 CLIP blocks and 2 joint
   layers) on the card is held against the same step on the CPU.

It prints the kernels' record as one JSON line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
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
# decoder (or the depth-cut teacher) with every sum in another order
SLICE_TOL = 1e-3
# gradient leaves below this share of the largest are held to it (see
# train_f32_check)
GRAD_FLOOR = 1e-4
CAPTION_LEN = 40               # teacher-forced caption tokens
TAPS = (0, 6, 12, 18)          # CLIP blocks tapped for distillation
BEAM_BATCH, BEAMS, BEAM_STEPS = 2, 4, 15

KERNELS = {
    "window_attention": ("rtvc_tpu_torch/csrc/window_attention.cu",
                         "rtvc_tpu/ops/attention.py:766"),
    "layer_norm": ("rtvc_tpu_torch/csrc/layer_norm.cu",
                   "rtvc_tpu/ops/layernorm.py:40"),
    "w8_matmul": ("rtvc_tpu_torch/csrc/w8_matmul.cu",
                  "rtvc_tpu/ops/int8_gemm.py:169"),
    "flash_attention": ("rtvc_tpu_torch/csrc/flash_attention_sm90.cu",
                        "rtvc_tpu/ops/attention.py:274"),
    "blhd_attention": ("rtvc_tpu_torch/csrc/flash_attention_sm90.cu",
                       "rtvc_tpu/ops/attention.py:642"),
    "fused_add_layer_norm": ("rtvc_tpu_torch/csrc/layer_norm.cu",
                             "rtvc_tpu/ops/layernorm.py:159"),
    "w8a8_matmul": ("rtvc_tpu_torch/csrc/w8a8_matmul.cu",
                    "rtvc_tpu/ops/int8_gemm.py:100"),
    "flash_attention_bwd": ("rtvc_tpu_torch/csrc/flash_attention.cu",
                            "rtvc_tpu/ops/attention.py:452"),
    "dw3x3_wgrad": ("rtvc_tpu_torch/csrc/depthwise_wgrad.cu",
                    "rtvc_tpu/ops/depthwise.py:90"),
}
TRAIN_STEPS = 5
DROPOUT_SEED = 12345


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


def device_ms(fn, reps: int, warmup: int = 2) -> tuple:
    """(mean ms per call of ``fn`` on the device, "graph" or "eager").
    ``reps`` calls are captured into one CUDA graph and replayed between
    CUDA events, so the host's time to launch each call (the wrappers'
    checks, ctypes, the tensor maps) is left out: a short kernel would
    otherwise be timed at the host's pace. Where capture fails (an op that
    synchronises), the calls run back to back instead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception:  # whatever broke the capture, time the calls eagerly
        del graph
        torch.cuda.synchronize()
        return cuda_ms(fn, reps, warmup=0), "eager"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps, "graph"


def sm90_sass(library) -> dict:
    """What the bfloat16 K4/K5 kernels (``attention_sm90_kernel``) were
    compiled to, from ``cuobjdump`` on the built library: their HGMMA
    (warpgroup tensor-core product) and ``WARPGROUP.DEPBAR`` (wait for the
    products) instructions, and registers per thread of each instance. A
    DEPBAR per HGMMA would mean ptxas serialised the products."""
    import re
    from pathlib import Path
    from rtvc_tpu_torch import _build
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, function = {"HGMMA": 0, "WARPGROUP.DEPBAR": 0}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            function = line
        elif "attention_sm90" in function:
            for op in out:
                out[op] += op in line
    usage = subprocess.run([tool, "-res-usage", str(library)],
                           capture_output=True, text=True, check=True,
                           timeout=300).stdout
    out["registers"] = [int(m.group(1)) for m in re.finditer(
        r"attention_sm90\S*\s+REG:(\d+)", usage)]
    return out


def rel_err(got, want) -> tuple:
    """(max |got - want|, that divided by max(1, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(1.0, float(want.float().abs().max()))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev, g):
    """Each case as a dict: kernel name, label, the kernel call, the plain
    call, timing reps, the work it must do (for its bound) and a maker of
    its library yardstick (``rtvc_tpu_torch.yardsticks``), at the main
    path's shapes. The caption step's: TinyViT window attention per stage
    at batch 1 and 8 (6-frame windows), the decoder's [B, 576] norms and
    TinyViT's stage-1 norm, the vocab GEMV at 1 and 8 rows. The teacher's:
    the joint attention over 1542 visual + 40 text tokens at batch 8 (on
    strided head views of the QKV product, as the model passes them), a
    ragged and a key-masked case (one row with no key left), the CLIP
    attention of 48 frames, the CLIP norms over 48 × 257 tokens at eps
    1e-5 and the joint norms over 8 × 1582 tokens at eps 1e-12, the ln_2
    add + norm, and the W8A8 GEMMs of a CLIP MLP (both Linears) at
    M = 12336, of the joint fc2 at M = 12656 (K up to 4096, where the
    int32 sums pass 2^24) and of the vocab projection at the
    teacher-forced M = 320 and a beam's M = 8. The train step's: K4 with
    dropout 0.1 at the joint shape, K8 there with and without dropout and
    on the ragged, key-masked case, K9 on the four stride-1 depthwise
    shapes of the batch-8 TinyViT (MBConv at stage 0, local_conv at
    stages 1-3). In bfloat16, the edges of the tensor-core K4/K5: D = 32
    and 40 (zero-padded columns), Lq = 1, Lkv below one 64-key tile, Lq
    and Lkv off the 64/128 grid, a batch row with every key masked, BLHD
    at L = 50, and the beam's visual prefill [8, 12, 1542, 64] (every key
    visible)."""
    import torch
    from rtvc_tpu_torch import yardsticks as Y
    from rtvc_tpu_torch.ops import attention, depthwise, int8_gemm, layernorm

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    def packed_heads(b, lq, h, d, dtype, pitch=None):
        """q, k, v [b, h, lq, d]: head views of one packed QKV product,
        each head's d columns the first of ``pitch`` (d by default)."""
        pitch = pitch or d
        qkv = rand(b, lq, 3, h, pitch, dtype=dtype)[..., :d]
        return tuple(t.transpose(1, 2) for t in qkv.unbind(2))

    cases = []

    def add(name, label, reps, kern, plain, args, kw, work, library):
        cases.append(dict(
            name=name, label=label, reps=reps,
            kern=lambda: kern(*args, **kw), plain=lambda: plain(*args, **kw),
            work=work(*args, **kw), library=lambda: library(*args, **kw)))

    def flash(label, args, kw, reps=10):
        add("flash_attention", label, reps, attention.flash_attention,
            attention.flash_attention_plain, args, kw, Y.flash_work,
            Y.flash_library)

    def blhd(label, views, reps=10):
        add("blhd_attention", label, reps, attention.blhd_attention,
            attention.blhd_attention_plain, views, {}, Y.blhd_work,
            Y.blhd_library)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).removeprefix("torch.")
        for batch in (1, 8):
            for stage, (nw, h, n) in enumerate(
                    ((16, 6, 49), (1, 12, 196), (1, 18, 49)), start=1):
                b = batch * FRAMES * nw
                q, k, v = (rand(b, h, n, 32, dtype=dtype) for _ in range(3))
                add("window_attention",
                    f"{dn} stage{stage} b{batch} [{b},{h},{n},32]", 50,
                    attention.window_attention,
                    attention.window_attention_plain,
                    (q, k, v, rand(h, n, n, scale=0.5)),
                    dict(softmax_in_input_dtype=True), Y.window_work,
                    Y.window_library)
        for rows, width in ((8, 576), (8 * 25, 576),
                            (8 * FRAMES * 28 * 28, 192)):
            add("layer_norm", f"{dn} [{rows},{width}]", 50,
                layernorm.layer_norm, layernorm.layer_norm_plain,
                (rand(rows, width, dtype=dtype, scale=2.0),
                 rand(width, dtype=dtype), rand(width, dtype=dtype)), {},
                Y.layer_norm_work, Y.layer_norm_library)
        wq = torch.randint(-127, 128, (576, 31744), generator=g,
                           dtype=torch.int8).to(dev)
        sw = (torch.rand(31744, generator=g) / (127 * 24)).to(dev)
        bb = rand(31744, scale=0.1)
        for m in (1, 8):
            add("w8_matmul", f"{dn} M={m} [576,31744]", 50,
                int8_gemm.w8_matmul, int8_gemm.w8_matmul_plain,
                (rand(m, 576, dtype=dtype), wq, sw, bb), {}, Y.w8_work,
                Y.w8_library)

        # the teacher (K4-K7)
        b, h, lq, d, prefix = WINDOWS, 12, FRAMES * 257 + CAPTION_LEN, 64, \
            FRAMES * 257
        heads = packed_heads(b, lq, h, d, dtype)
        mask = torch.rand(b, lq, generator=g).to(dev) > 0.1
        mask[-1] = False
        ragged = (rand(2, h, 1000, d, dtype=dtype),
                  rand(2, h, 1037, d, dtype=dtype),
                  rand(2, h, 1037, d, dtype=dtype))
        drop = dict(dropout_rate=0.1, seed=DROPOUT_SEED)
        joint = dict(causal=True, prefix_len=prefix)
        flash(f"{dn} joint [{b},{h},{lq},{d}] prefix {prefix}", heads, joint)
        flash(f"{dn} ragged [2,{h},1000x1037,{d}] prefix 900", ragged,
              dict(causal=True, prefix_len=900))
        flash(f"{dn} key-masked [{b},{h},{lq},{d}]", heads,
              dict(joint, kv_mask=mask))
        flash(f"{dn} dropout 0.1 joint [{b},{h},{lq},{d}]", heads,
              dict(joint, **drop))
        rmask = torch.rand(2, 1037, generator=g).to(dev) > 0.1
        rmask[-1] = False
        for label, args, kw in (
                (f"joint [{b},{h},{lq},{d}] prefix {prefix}",
                 heads + (rand(b, h, lq, d, dtype=dtype),), joint),
                (f"dropout 0.1 joint [{b},{h},{lq},{d}]",
                 heads + (rand(b, h, lq, d, dtype=dtype),),
                 dict(joint, **drop)),
                (f"key-masked ragged [2,{h},1000x1037,{d}] prefix 900",
                 ragged + (rand(2, h, 1000, d, dtype=dtype),),
                 dict(causal=True, prefix_len=900, kv_mask=rmask))):
            add("flash_attention_bwd", f"{dn} {label}", 3,
                attention.flash_attention_bwd,
                attention.flash_attention_bwd_plain, args, kw,
                Y.flash_bwd_work, Y.flash_bwd_library)
        for stage, (c, hw) in enumerate(((384, 56), (192, 28), (384, 14),
                                         (576, 7))):
            add("dw3x3_wgrad",
                f"{dn} stage{stage} [{WINDOWS * FRAMES},{c},{hw},{hw}]", 20,
                depthwise.dw3x3_wgrad, depthwise.dw3x3_wgrad_plain,
                tuple(rand(WINDOWS * FRAMES, c, hw, hw, dtype=dtype)
                      for _ in range(2)), {}, Y.dw3x3_wgrad_work,
                Y.dw3x3_wgrad_library)
        clip_qkv = rand(WINDOWS * FRAMES, 257, 3 * 1024, dtype=dtype)
        blhd(f"{dn} clip [{WINDOWS * FRAMES},257,16,64]",
             clip_qkv.view(WINDOWS * FRAMES, 257, 3, 16, 64).unbind(2))
        if dtype == torch.bfloat16:
            # D = 40 on heads 48 columns apart: a 40-column row stride
            # (80 B) is no multiple of 16 B, which TMA needs
            for dd, pitch in ((32, 32), (40, 48)):
                flash(f"{dn} edge: D={dd} [2,4,300,{dd}] prefix 260",
                      packed_heads(2, 300, 4, dd, dtype, pitch),
                      dict(causal=True, prefix_len=260))
            kv = (rand(3, 4, 200, d, dtype=dtype),
                  rand(3, 4, 200, d, dtype=dtype))
            flash(f"{dn} edge: Lq=1 [3,4,1x200,{d}]",
                  (rand(3, 4, 1, d, dtype=dtype),) + kv, {})
            flash(f"{dn} edge: Lkv=37 [2,4,150x37,{d}] prefix 20",
                  (rand(2, 4, 150, d, dtype=dtype),
                   rand(2, 4, 37, d, dtype=dtype),
                   rand(2, 4, 37, d, dtype=dtype)),
                  dict(causal=True, prefix_len=20))
            odd = (rand(2, 3, 200, d, dtype=dtype),
                   rand(2, 3, 333, d, dtype=dtype),
                   rand(2, 3, 333, d, dtype=dtype))
            flash(f"{dn} edge: Lq=200 Lkv=333 [2,3,200x333,{d}] prefix 150",
                  odd, dict(causal=True, prefix_len=150))
            omask = torch.rand(2, 333, generator=g).to(dev) > 0.5
            omask[1] = False
            flash(f"{dn} edge: fully masked batch row [2,3,200x333,{d}]",
                  odd, dict(kv_mask=omask))
            blhd(f"{dn} edge: BLHD L=50 [{WINDOWS * FRAMES},50,16,64]",
                 rand(WINDOWS * FRAMES, 50, 3 * 1024, dtype=dtype).view(
                     WINDOWS * FRAMES, 50, 3, 16, 64).unbind(2))
            flash(f"{dn} edge: beam prefill [{b},{h},{prefix},{d}]",
                  packed_heads(b, prefix, h, d, dtype),
                  dict(causal=True, prefix_len=prefix))
        rows = WINDOWS * FRAMES * 257
        joint_rows = WINDOWS * lq
        for width, n, eps in ((1024, rows, 1e-5), (768, joint_rows, 1e-12)):
            # row scales from 1e-3 to 2: the small-variance rows tell the
            # two eps values apart, so a kernel given the wrong one fails
            scale = torch.logspace(-3, 0.3, n).to(dev)[:, None]
            add("layer_norm", f"{dn} teacher [{n},{width}] eps {eps:g}", 10,
                layernorm.layer_norm, layernorm.layer_norm_plain,
                ((rand(n, width) * scale).to(dtype), rand(width, dtype=dtype),
                 rand(width, dtype=dtype), eps), {}, Y.layer_norm_work,
                Y.layer_norm_library)
        add("fused_add_layer_norm", f"{dn} [{rows},1024]", 10,
            layernorm.fused_add_layer_norm,
            layernorm.fused_add_layer_norm_plain,
            tuple(rand(rows, 1024, dtype=dtype, scale=2.0) for _ in range(2))
            + (rand(1024, dtype=dtype), rand(1024, dtype=dtype)), {},
            Y.add_layer_norm_work, Y.add_layer_norm_library)
        for label, m, k, n in (("clip fc", rows, 1024, 3072),
                               ("clip c_proj", rows, 4096, 1024),
                               ("joint fc2", joint_rows, 3072, 768),
                               ("vocab", WINDOWS * CAPTION_LEN, 768, 30522),
                               ("vocab", WINDOWS, 768, 30522)):
            xq, pack = int8(m, k), int8(n, k)
            sx = torch.rand(m, generator=g).to(dev) * 0.02 + 1e-3
            swn = torch.rand(n, generator=g).to(dev) * 1e-3 + 1e-4
            add("w8a8_matmul", f"{dn} {label} M={m} [{k}->{n}]", 10,
                int8_gemm.w8a8_matmul, int8_gemm.w8a8_matmul_plain,
                (xq, sx, pack.t(), swn, rand(n, scale=0.1), dtype), {},
                Y.w8a8_work, Y.w8a8_library)
    return cases


def library_ms(yardstick, reps: int) -> tuple:
    """(device ms per call or None, the call's name) of a library
    yardstick. A call the card's torch refuses (a shape or type it does not
    take) is recorded as none, with the reason."""
    if yardstick.fn is None:
        return None, yardstick.name
    try:
        return device_ms(yardstick.fn, reps)[0], yardstick.name
    except (RuntimeError, NotImplementedError) as e:
        reason = str(e).strip().splitlines()[0][:120]
        return None, f"none: {yardstick.name} raised {reason}"


def kernel_phase(dev):
    import torch
    g = torch.Generator().manual_seed(SEED)
    log(f"  torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32} (K9's float32 yardstick, "
        f"conv2d_weight, runs in TF32 where True)")
    records = []
    for c in kernel_cases(dev, g):
        name, label, reps = c["name"], c["label"], c["reps"]
        got = c["kern"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [
            (got, want)]
        dtype = str(pairs[0][1].dtype).removeprefix("torch.")
        errs = [rel_err(a, b) for a, b in pairs]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
        del got, want, pairs
        ms, timing = device_ms(c["kern"], reps)
        plain_ms, plain_timing = device_ms(c["plain"], reps)
        lib_ms, lib_call = library_ms(c["library"](), reps)
        bound_s, bound_by = c["work"].bound()
        ok = rel <= TOL[dtype] and finite
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
        log(f"  {name:20s} {label:52s} max_abs_err {err:.3e} (tol "
            f"{TOL[dtype]:g} rel) kernel {ms * 1e3:10.2f} us  plain "
            f"{plain_ms * 1e3:10.2f} us  bound {bound_s * 1e6:.2f} us "
            f"({bound_by}, {bound_s * 1e3 / ms:.1%})  library {lib}  "
            f"[{timing}/{plain_timing}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees with "
                                 f"its plain version ({err:.3e})")
        records.append(dict(
            name=name, case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            timing=timing, plain_timing=plain_timing,
            bound_us=bound_s * 1e6, bound_by=bound_by,
            roofline_share=bound_s * 1e3 / ms,
            library_us=None if lib_ms is None else lib_ms * 1e3,
            library_call=lib_call))
        torch.cuda.empty_cache()
    return records


def flash_grad_path(dev) -> dict:
    """K8's caller: ``flash_attention(...).backward()`` at the joint shape,
    bf16, dropout 0.1 drawn from a CPU generator. Launch counts are reset
    before and read after; K4 and K8 must launch once each, and the
    gradients must equal ``flash_attention_bwd_plain`` with the same seed
    (the seed is the generator's next draw)."""
    import torch
    from rtvc_tpu_torch.ops import attention
    from rtvc_tpu_torch.ops.dropout import draw_seed
    g = torch.Generator().manual_seed(SEED + 5)
    b, h, lq, d = WINDOWS, 12, FRAMES * 257 + CAPTION_LEN, 64
    q, k, v, go = (torch.randn(b, h, lq, d, generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kw = dict(causal=True, prefix_len=FRAMES * 257, dropout_rate=0.1)
    seed = draw_seed(torch.Generator().manual_seed(SEED + 6))
    torch.cuda.synchronize()
    reset_counts()
    attention.flash_attention(
        *leaves, generator=torch.Generator().manual_seed(SEED + 6),
        **kw).backward(go)
    torch.cuda.synchronize()
    launched = counts()
    want = attention.flash_attention_bwd_plain(q, k, v, go, seed=seed, **kw)
    err = max(rel_err(t.grad, w)[1] for t, w in zip(leaves, want))
    log(f"  flash_attention autograd, dropout 0.1: launches {launched}, "
        f"grads vs plain {err:.3e} (tol {TOL['bfloat16']:g} rel)")
    check_launches("flash_attention autograd", launched,
                   {"flash_attention": 1, "flash_attention_bwd": 1})
    if not err <= TOL["bfloat16"]:
        raise AssertionError("flash_attention gradients disagree with "
                             "flash_attention_bwd_plain")
    return launched


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


def wrappers() -> dict:
    """Each kernel's wrapper, by the kernel's name in KERNELS."""
    from rtvc_tpu_torch.ops import attention, depthwise, int8_gemm, layernorm
    return {"window_attention": attention.window_attention,
            "layer_norm": layernorm.layer_norm,
            "w8_matmul": int8_gemm.w8_matmul,
            "flash_attention": attention.flash_attention,
            "blhd_attention": attention.blhd_attention,
            "fused_add_layer_norm": layernorm.fused_add_layer_norm,
            "w8a8_matmul": int8_gemm.w8a8_matmul,
            "flash_attention_bwd": attention.flash_attention_bwd,
            "dw3x3_wgrad": depthwise.dw3x3_wgrad}


def counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
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
    student_f32 = random_init_(student_from_config(cfg, device="cpu"),
                               g).eval()
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


# ---------------------------------------------------------------------------
# phase 5: the frozen teacher
# ---------------------------------------------------------------------------

def timed_run(label: str, fn):
    """One warm-up call of ``fn``, then the launch counts reset, one call
    between CUDA events, the counts read. Returns (result, ms, counts)."""
    import torch
    fn()
    torch.cuda.synchronize()
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    launched = counts()
    ms = ev[0].elapsed_time(ev[1])
    log(f"  {label:18s} {ms:10.3f} ms  launches {launched}")
    return out, ms, launched


def check_launches(label: str, launched: dict, want: dict) -> None:
    bad = {k: (launched[k], n) for k, n in want.items() if launched[k] != n}
    if bad:
        raise AssertionError(f"{label}: launches (got, want) {bad}")


def check_tensor(label: str, t, shape) -> None:
    import torch
    if tuple(t.shape) != tuple(shape):
        raise AssertionError(f"{label}: shape {tuple(t.shape)} != {shape}")
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{label}: non-finite values")


def teacher_f32_check(frames, captions, dev) -> dict:
    """The depth-cut float32 teacher (2 CLIP blocks, 2 joint layers, full
    widths) on the card (kernels, TF32 off) against the same model on the
    CPU (plain versions), batch 1. The W8A8 copy is left out: once one
    activation rounds to the neighbouring int8 value on one side, the next
    layers' activations differ by ~1e-3 and many more round apart, so the
    two sides drift to the quantization error itself (1.8e-2 of the
    largest logit at 2 blocks + 2 layers); :func:`w8a8_sites_check` holds
    K7 in the model instead."""
    import torch
    from rtvc_tpu_torch.config import GITConfig, clip_vit_l14_config
    from rtvc_tpu_torch.models.git_teacher import GITTeacher, random_init_
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 2)
    cut = GITConfig(clip=clip_vit_l14_config(layers=2), num_layers=2)
    cpu_model = random_init_(GITTeacher(cut), g).eval()
    card = copy.deepcopy(cpu_model).to(dev)
    fr, caps = frames[:1].float().cpu(), captions[:1].cpu()
    out = {}
    with torch.inference_mode():
        want = cpu_model.forward_output_logits(fr, caps)
        got = card.forward_output_logits(fr.to(dev), caps.to(dev))
    for what, i in (("visual", 1), ("logits", 0)):
        err, rel = rel_err(got[i].cpu(), want[i])
        log(f"  f32 card vs cpu teacher {what:7s} max_abs_err {err:.3e} "
            f"(rel {rel:.3e}, tol {SLICE_TOL:g})")
        if not rel <= SLICE_TOL:
            raise AssertionError(f"f32 teacher {what}: card and CPU disagree")
        out[f"f32_teacher_{what}_max_abs_err"] = err
        out[f"f32_teacher_{what}_rel_err"] = rel
    return out


def w8a8_sites_check(model, frames, captions) -> dict:
    """One more W8A8 forward, each ``QuantLinear``'s output (a K7 launch at
    the main path's shape) held against the plain version on the same
    input on the card, with the TOL rule."""
    import torch
    from rtvc_tpu_torch.ops.int8_gemm import w8a8_matmul_plain
    from rtvc_tpu_torch.ops.quantization import (QuantLinear,
                                                 quantize_activations)
    worst = {}

    def hook(mod, inputs, out):
        x = inputs[0].reshape(-1, inputs[0].shape[-1])
        xq, sx = quantize_activations(x)
        want = w8a8_matmul_plain(xq, sx.reshape(-1), mod.weight_q.t(),
                                 mod.weight_scale, mod.bias, x.dtype)
        err, rel = rel_err(out.reshape(want.shape), want)
        site = (f"{str(x.dtype).removeprefix('torch.')} M={x.shape[0]} "
                f"[{x.shape[1]}->{want.shape[1]}]")
        worst[site] = max(worst.get(site, (0.0, 0.0)), (rel, err))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, QuantLinear)]
    try:
        with torch.inference_mode():
            model.forward_output_logits(frames, captions, TAPS)
    finally:
        for h in hooks:
            h.remove()
    for site, (rel, err) in sorted(worst.items()):
        tol = TOL[site.split()[0]]
        log(f"  w8a8 site {site:33s} max_abs_err {err:.3e} (rel {rel:.3e}, "
            f"tol {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"w8a8 site {site}: K7 disagrees with its "
                                 f"plain version")
    return {"w8a8_sites": len(hooks), "w8a8_site_shapes": len(worst),
            "w8a8_sites_max_abs_err": max(e for _, e in worst.values())}


def teacher_phase(dev) -> dict:
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.decode import teacher_beam, teacher_kd_targets
    from rtvc_tpu_torch.models.git_teacher import (random_init_,
                                                   teacher_from_config)
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    from rtvc_tpu_torch.ops.quantization import QuantLinear, quantize_teacher_

    g = torch.Generator().manual_seed(SEED + 1)
    teacher = random_init_(teacher_from_config(cfg, device=dev), g).eval()
    tc = teacher.config
    blocks, joint, vocab = tc.clip.layers, tc.num_layers, tc.vocab_size
    tokens = FRAMES * ((tc.clip.image_size // tc.clip.patch_size) ** 2 + 1)
    windows = make_windows(g).to(dev)
    frames = clip_preprocess(windows.reshape((-1,) + windows.shape[2:]))
    frames = frames.reshape((WINDOWS, FRAMES) + frames.shape[1:])
    captions = torch.randint(1000, vocab, (WINDOWS, CAPTION_LEN),
                             generator=g)
    captions[:, 0] = 101
    captions = captions.to(dev)
    result = {"launches": {}}

    def add(launched):
        for k, n in launched.items():
            result["launches"][k] = result["launches"].get(k, 0) + n

    # K2: ln_pre, ln_1 per block, ln_post; visual_ln, emb_norm, two per layer
    norms = blocks + 2 + 2 + 2 * joint
    forward_counts = {"blhd_attention": blocks, "fused_add_layer_norm": blocks,
                      "flash_attention": joint, "layer_norm": norms}
    quant = quantize_teacher_(copy.deepcopy(teacher))
    packs = sum(isinstance(m, QuantLinear) for m in quant.modules())
    outs = {}
    for mode, model in (("forward", teacher), ("forward_w8a8", quant)):
        with torch.inference_mode():
            out, ms, launched = timed_run(mode, lambda: (
                model.forward_output_logits(frames, captions, TAPS)))
        check_launches(mode, launched, dict(
            forward_counts, w8a8_matmul=packs if model is quant else 0))
        add(launched)
        logits, visual, hidden, taps = out
        check_tensor(f"{mode} logits", logits, (WINDOWS, CAPTION_LEN, vocab))
        check_tensor(f"{mode} visual", visual,
                     (WINDOWS, tokens, tc.visual_feature_size))
        for i, h in enumerate(hidden):
            check_tensor(f"{mode} hidden {i}", h,
                         (WINDOWS, tokens + CAPTION_LEN, tc.hidden_size))
        for i, t in enumerate(taps):
            check_tensor(f"{mode} tap {i}", t,
                         (WINDOWS, FRAMES, tc.clip.width))
        if len(hidden) != joint or len(taps) != len(TAPS):
            raise AssertionError(f"{mode}: {len(hidden)} hidden states, "
                                 f"{len(taps)} taps")
        outs[mode] = logits.float()
        result[f"{mode}_b{WINDOWS}_ms"] = ms
    agree = float((outs["forward"].argmax(-1)
                   == outs["forward_w8a8"].argmax(-1)).float().mean())
    gap = rel_err(outs["forward_w8a8"], outs["forward"])[1]
    log(f"  w8a8 vs bf16 logits: argmax agreement {agree:.4f}, max gap "
        f"{gap:.3e} of max(1, max|logit|)")
    result.update(w8a8_argmax_agreement=agree, w8a8_rel_gap=gap)
    result.update(w8a8_sites_check(quant, frames, captions))
    del quant, outs

    def beam_and_targets():
        out = teacher_beam(teacher, frames[:BEAM_BATCH], beam_size=BEAMS,
                           max_steps=BEAM_STEPS)
        return out, teacher_kd_targets(
            out, torch.full((BEAM_BATCH,), BEAM_STEPS - 1))

    (beam, kd), ms, launched = timed_run("teacher_beam", beam_and_targets)
    steps = beam.num_steps
    check_launches("teacher_beam", launched, {
        "blhd_attention": blocks, "fused_add_layer_norm": blocks,
        "flash_attention": joint, "w8a8_matmul": 0,
        "layer_norm": blocks + 2 + (1 + 2 * joint) * (1 + steps)})
    add(launched)
    preds = beam.predictions
    check_tensor("beam predictions", preds, (BEAM_BATCH, BEAM_STEPS))
    if not (bool((preds[:, 0] == 101).all())
            and bool(((preds >= 0) & (preds < vocab)).all())):
        raise AssertionError(f"beam predictions {preds.tolist()}")
    check_tensor("beam logits", beam.logits,
                 (BEAM_STEPS - 1, BEAM_BATCH, BEAMS, vocab))
    check_tensor("beam logprobs", beam.logprobs, (BEAM_BATCH,))
    check_tensor("kd targets", kd[0], (BEAM_BATCH, BEAM_STEPS - 1, vocab))
    log(f"  teacher_beam {steps} steps, predictions {preds.tolist()}, "
        f"logprobs {beam.logprobs.tolist()}")
    result.update(beam_ms=ms, beam_steps=steps,
                  beam_predictions=preds.tolist())
    result.update(teacher_f32_check(frames, captions, dev))
    return result


# ---------------------------------------------------------------------------
# phase 6: the distillation train step
# ---------------------------------------------------------------------------

# the student's distillation heads: kl + ce leave them without a gradient
HEADS = ("projectors.", "upsample.", "project.", "project_decoder.")


def train_batch(g, dev, windows: int = 0) -> dict:
    """``windows`` (all ``WINDOWS`` by default) preprocessed 6-frame windows
    and 40-token captions: CLS first, a seeded valid length from 5 tokens
    up, pad (0) after it."""
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    windows = windows or WINDOWS
    raw = make_windows(g)[:windows].to(dev)
    frames = clip_preprocess(raw.reshape((-1,) + raw.shape[2:]))
    frames = frames.reshape((windows, FRAMES) + frames.shape[1:])
    caps = torch.randint(1000, cfg.student.vocab_size,
                         (windows, CAPTION_LEN), generator=g)
    lens = torch.randint(5, CAPTION_LEN + 1, (windows,), generator=g)
    caps[torch.arange(CAPTION_LEN)[None, :] >= lens[:, None]] = 0
    caps[:, 0] = cfg.student.cls_token_id
    return {"frames": frames, "caption": caps.to(dev)}


def gradient_check(model, mu) -> int:
    """Adam's first moment after one step is 0.1·g: every parameter's must
    be finite, nonzero somewhere, and zero everywhere only for the heads
    that kl + ce leave unused. Returns how many parameters the loss
    reached."""
    import torch
    unreached = []
    for (name, _), m in zip(model.named_parameters(), mu):
        if not bool(torch.isfinite(m).all()):
            raise AssertionError(f"non-finite gradient in {name}")
        if not bool((m != 0).any()):
            unreached.append(name)
    wrong = [n for n in unreached if not n.startswith(HEADS)]
    if wrong:
        raise AssertionError(f"{len(wrong)} parameters got no gradient, "
                             f"first {wrong[:5]}")
    return len(mu) - len(unreached)


def train_launches_per_step(student, teacher) -> dict:
    """Kernel launches one train step makes, from the layer counts: K1 per
    TinyViT attention block, K9 per stride-1 depthwise conv (MBConv conv2
    and local_conv), K2 per student and teacher LayerNorm (the backward of
    K1 and K2 is plain PyTorch), K4-K6 per teacher layer as in the teacher
    phase."""
    depths = student.image_encoder["model"].config.depths
    tc = teacher.config
    blocks = sum(depths[1:])
    return {"window_attention": blocks, "dw3x3_wgrad": sum(depths),
            "layer_norm": 2 * blocks + 3 * len(student.decoder["layers"])
            + tc.clip.layers + 4 + 2 * tc.num_layers,
            "flash_attention": tc.num_layers,
            "blhd_attention": tc.clip.layers,
            "fused_add_layer_norm": tc.clip.layers, "w8_matmul": 0,
            "w8a8_matmul": 0, "flash_attention_bwd": 0}


def train_f32_check(dev) -> dict:
    """One float32 step (TF32 off) of the full-width student on one window
    with dropout and DropPath at 0, the teacher cut to 2 CLIP blocks and 2
    joint layers, on the card (kernels) against the same step on the CPU
    (plain versions): the losses, each parameter's gradient (read from
    Adam's first moment) and the new BatchNorm statistics."""
    import torch
    from rtvc_tpu_torch.config import GITConfig, cfg, clip_vit_l14_config
    from rtvc_tpu_torch.models import git_teacher, student as student_lib
    from rtvc_tpu_torch.models.layers import DropPath
    from rtvc_tpu_torch.train import Adam, create_train_state, make_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 8)
    student = student_lib.random_init_(
        student_lib.student_from_config(cfg, device="cpu"), g)
    for mod in student.modules():
        if isinstance(mod, student_lib.TransformerDecoderLayer):
            mod.dropout = 0.0
        elif isinstance(mod, DropPath):
            mod.rate = 0.0
    cut = GITConfig(clip=clip_vit_l14_config(layers=2), num_layers=2)
    teacher = git_teacher.random_init_(git_teacher.GITTeacher(cut), g)
    batch = train_batch(g, "cpu", windows=1)
    runs = {}
    for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = copy.deepcopy(student).to(d)
        opt = Adam(cfg.train.lr)
        state = create_train_state(model, opt, torch.float32)
        step = make_train_step(model, copy.deepcopy(teacher).to(d), opt)
        metrics = step(state, {k: v.to(d) for k, v in batch.items()},
                       torch.Generator().manual_seed(0))
        runs[side] = (metrics, state.opt_state.mu,
                      {n: b for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))})
    (m_cpu, mu_cpu, bn_cpu), (m_card, mu_card, bn_card) = (runs["cpu"],
                                                           runs["card"])
    out = {}
    for k in ("kl", "ce", "total"):
        a, b = float(m_card[k]), float(m_cpu[k])
        rel = abs(a - b) / max(1.0, abs(b))
        log(f"  f32 card vs cpu step {k:5s} {a:.6f} vs {b:.6f} (rel "
            f"{rel:.3e}, tol 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"f32 train step {k}: card and CPU disagree")
        out[f"f32_step_{k}_rel_err"] = rel

    # Each gradient leaf is held to its own largest value, or to
    # GRAD_FLOOR of the largest over all leaves where its own is smaller:
    # a gradient that is zero in exact arithmetic is rounding noise on both
    # sides (the last MLP bias of stages 1 and 2 only feeds a train-mode
    # BatchNorm, which removes any per-channel constant: ~1e-8 of the
    # largest gradient). The BatchNorm statistics are activation-scale
    # values and take the rule of the other checks, max(1, max|cpu|).
    top = max(float(b.abs().max()) for b in mu_cpu)
    grads = max(float((a.cpu() - b).abs().max())
                / max(float(b.abs().max()), GRAD_FLOOR * top)
                for a, b in zip(mu_card, mu_cpu))
    stats = max(rel_err(bn_card[n].cpu(), bn_cpu[n])[1] for n in bn_cpu)
    log(f"  f32 card vs cpu step: worst gradient leaf {grads:.3e} (of max("
        f"leaf max, {GRAD_FLOOR:g} x largest)), worst BatchNorm statistic "
        f"{stats:.3e} (of max(1, max)); tol {SLICE_TOL:g}")
    if not (grads <= SLICE_TOL and stats <= SLICE_TOL):
        raise AssertionError("f32 train step: card and CPU disagree")
    out.update(f32_step_worst_grad_rel_err=grads,
               f32_step_worst_bn_stat_rel_err=stats)
    return out


def train_phase(dev) -> dict:
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.models import git_teacher, student as student_lib
    from rtvc_tpu_torch.train import Adam, create_train_state, make_train_step

    g = torch.Generator().manual_seed(SEED + 3)
    student = student_lib.random_init_(
        student_lib.student_from_config(cfg, device=dev), g)
    teacher = git_teacher.random_init_(
        git_teacher.teacher_from_config(cfg, device=dev), g)
    batch = train_batch(g, dev)
    optimizer = Adam(cfg.train.lr)
    state = create_train_state(student, optimizer, cfg.dtype)
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    step = make_train_step(student, teacher, optimizer, mark=mark)
    gen = torch.Generator().manual_seed(SEED + 4)
    per_step = train_launches_per_step(student, teacher)
    torch.cuda.synchronize()
    reset_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        marks.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        t = {name: ev for name, ev in marks}
        rec = dict(step=i + 1,
                   ms=t["teacher"].elapsed_time(t["end"]),
                   teacher_ms=t["teacher"].elapsed_time(t["student"]),
                   student_ms=t["student"].elapsed_time(t["optimizer"]),
                   optimizer_ms=t["optimizer"].elapsed_time(t["end"]),
                   max_memory_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
                   **{k: float(v) for k, v in metrics.items()})
        if not all(map(math.isfinite, rec.values())):
            raise AssertionError(f"train step {i + 1}: non-finite {rec}")
        log(f"  step {i + 1}: {json.dumps(rec)}")
        if i == 0:
            reached = gradient_check(student, state.opt_state.mu)
            log(f"  step 1: {reached} of {len(state.params)} parameters "
                f"got a finite, nonzero gradient; the rest are the unused "
                f"heads {HEADS}")
        steps.append(rec)
    launched = counts()
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"  launches over {TRAIN_STEPS} steps {launched}")
    check_launches("train steps", launched, want)
    if not state.step == TRAIN_STEPS:
        raise AssertionError(f"state.step {state.step}")
    del student, teacher, state, step
    torch.cuda.empty_cache()
    result = dict(steps=steps, parameters_reached=reached,
                  launches=launched, launches_per_step=per_step)
    result.update(train_f32_check(dev))
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
    sass = sm90_sass(_build.library_path())
    log(f"[build] tensor-core K4/K5 kernels' SASS: {sass['HGMMA']} HGMMA, "
        f"{sass['WARPGROUP.DEPBAR']} WARPGROUP.DEPBAR, registers "
        f"{sass['registers']}")
    if sass["HGMMA"] == 0:
        raise AssertionError("the bf16 K4/K5 kernels hold no HGMMA")

    log("[kernels] kernel vs plain on the card")
    records = kernel_phase(dev)
    grad_path = flash_grad_path(dev)
    log("[slice] full-width student, caption steps")
    sl = slice_phase(dev)
    log("[teacher] full-width GIT-Large teacher, bf16")
    te = teacher_phase(dev)
    log("[train] distillation train step, full-width student and teacher")
    tr = train_phase(dev)

    # the row per kernel: its largest error over all cases; its times at the
    # main path's heaviest bf16 case; its launches on the main paths (K8
    # has no caller there: its launches are those of flash_attention's
    # gradient in the kernel phase)
    primary = {"window_attention": "bfloat16 stage1 b8",
               "layer_norm": "bfloat16 [200,576]",
               "w8_matmul": "bfloat16 M=8",
               "flash_attention": "bfloat16 joint",
               "blhd_attention": "bfloat16 clip",
               "fused_add_layer_norm": "bfloat16 [",
               "w8a8_matmul": "bfloat16 clip fc",
               "flash_attention_bwd": "bfloat16 joint",
               "dw3x3_wgrad": "bfloat16 stage0"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        head = next(r for r in mine if r["case"].startswith(primary[name]))
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=sl["launches"][name] + te["launches"][name]
                   + tr["launches"][name],
                   max_abs_err=max(r["max_abs_err"] for r in mine),
                   ms=head["ms"], plain_ms=head["plain_ms"],
                   bound_ms=head["bound_us"] / 1e3,
                   bound_by=head["bound_by"],
                   library_ms=None if head["library_us"] is None
                   else head["library_us"] / 1e3,
                   library_call=head["library_call"], case=head["case"])
        if name == "flash_attention_bwd":
            row.update(launches=grad_path[name],
                       launches_from="flash_attention autograd, kernel phase")
        kernels.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, kernels=kernels, cases=records,
                           slice=sl, teacher=te, train=tr), f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
