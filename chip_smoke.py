#!/usr/bin/env python3
"""Drive the PyTorch port's caption step, its server and its exported and
compiled programs, its evaluation path, frozen teacher (also in the input-dtype softmax, with its sampled
beam and ``teacher_generate``), distillation train step, training loop and
its data- and tensor-parallel layer once on an NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``rtvc_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``build/`` and load it; count the tensor-core instructions of the bf16
   K1, K3, K4/K5, K4n, K8 and K8n kernels and the int8 K7 in its SASS (a
   wait after every warpgroup product fails); run the probe of K4n/K8n's
   exact fast exponential and dropout division on every input of their
   bf16 domains (any mismatch fails; the inputs that took ``expf`` or a
   division are counted);
3. kernels: K1 (window attention), K2 (LayerNorm) and K3 (int8 GEMV,
   with a warm and a cold L2, beside the bf16 projection it replaces) at
   the caption step's shapes, K2 and K3 also at the beam's B·k rows, K2,
   K4 (flash attention), K5 (BLHD attention), K6 (add + LayerNorm) and K7
   (W8A8 GEMM, bit for bit) at the teacher's, K4 with dropout, K8 (flash backward, with and without
   dropout) and K9 (depthwise 3x3 weight gradient, run twice for the same
   bits) at the train step's, in bfloat16 and float32, each held against
   its plain PyTorch version on the card and timed against it and its
   library yardstick, each as a replayed CUDA graph of back-to-back calls
   (bf16 K8's yardstick, SDPA's backward, the median of three); and the
   edge cases of K7, K9 and the bf16 tensor-core K1, K4/K5 and K8, and K1
   and K2 at the eval phase's ragged last batch (K2 at its decoder and
   TinyViT rows), for correctness only. K4n and K8n, K4 and K8 in the
   input-dtype softmax (JAX's ``softmax_native``), run K4's joint,
   key-masked, dropout and beam-prefill cases (edges: a fully masked batch
   row, a ragged length) and K8's joint, key-masked ragged and dropout
   cases, each held to the bf16 limit and to a discriminating gate (its
   mean error below half the mode-off plain version's mean distance from
   the mode's plain version, which the limit alone cannot tell apart) and
   timed beside the mode-off kernel; K8n runs on the statistics its K4n
   forward left, as autograd runs it, and at the joint shape also
   standalone (``flash_attention_bwd``, after K4n's stats-only launch),
   and the stats-only launch is held against its plain version at the
   joint and key-masked cases (the max bit for bit, bf16(1 / z) within one
   bf16 ulp). Then K8's one caller, the gradient of ``flash_attention``
   through autograd, runs once at the joint shape with dropout, in both
   softmax modes, launch counts reset before and read after (in the mode:
   K4n and K8n once, the stats-only K4n never; a standalone
   ``flash_attention_bwd`` launches it once; a forward keeps statistics
   only with grad); float32 with the mode on must give the mode-off bits;
   K6's gradient under autograd at [12336, 1024] is held to its bf16
   limit;
4. slice: the full-width student (random weights from a seeded generator,
   bfloat16) serves 8 distinct 480×640 6-frame windows at batch 1 and as
   one batch of 8, through the default and the ``vocab_int8`` caption
   steps. The kernels' launch counts are reset just before and read just
   after; every kernel of the path must have launched. Then, in float32
   with TF32 off, the card's encoder memory, first-step logits and token
   rows are held against the same step run on the CPU (plain versions);
5. serve: the same student and windows through the beam step
   (``make_caption_step(beam=3)``, default and ``vocab_int8``, batch 1 and
   8, launch counts reset before and read after: K1 and K2 must launch,
   K3 once a step under ``vocab_int8``), the f32 beam's card-vs-CPU
   first-word divergence (reported), then ``BatchCaptionServer`` (max
   batch 8, greedy and beam 3, the synthetic tokenizer) behind
   ``CaptionHTTPFrontend`` on 127.0.0.1: 8 windows submitted at once from
   8 streams must form one batch whose rows equal the direct step's bit
   for bit, and 3 bursts of 8 concurrent HTTP requests (raw and JSON
   frames) must all answer 200 with the in-process captions. The
   JPEG/PNG frame path needs ``cv2``, which the card's machine lacks: it
   is tested on the CPU (tests/test_torch_serving_http.py), not here;
5b. export: the same student and windows through ``export.save_bundle``
   (greedy and beam 3, buckets 1 and 8) and ``load_bundle``: every
   exported call's rows must equal the live ``make_caption_step``'s bit
   for bit and launch K1 and K2 exactly the layer counts (10 K1; 20 + 6 a
   decode step K2, all 25 steps greedy, 24 beam), nothing else; one
   exported b8 call under ``profile_trace`` must show K1's and K2's
   kernels; ``save_compiled`` (AOTInductor) at b8 greedy, 10 tokens
   (``COMPILED_MAX_LEN``), on a ``lively_`` copy must give that copy's
   live rows and launch the layer counts. Exported,
   compiled and live ms per window are timed in the same run, and K1 and
   K2 through their ``rtvc::`` operators against the direct launch on the
   host (the operators' share of a b1 greedy step);
6. eval: an MSRVTT-format test split in a temporary directory (20 seeded
   .npy clips of 12 frames at 320×240, 20 captions a clip from the
   synthetic vocabulary's words, encoded by the port's tokenizer). The bf16
   serving student, its vocab projection and cross-attention output
   projections ×10 so that its rows depend on the clip, saved with
   ``save_checkpoint``, is scored by ``python -m rtvc_tpu_torch.evaluate
   --ckpt ... --out ...`` (greedy to max_len 45, batches of 8, 8 and 4,
   launch counts reset before and read after): the scores JSON must hold
   JAX's keys, all finite, the preds JSON each clip once;
   ``make_eval_step``'s rows on each loader batch must equal
   ``make_caption_step``'s on the same uint8 clips bit for bit, more than
   one distinct row among them, and the preds texts their decode; K1 must
   launch 10 times a TinyViT forward, K2 20 times a forward and 6 a decode
   step, no other kernel. Then ``evaluate_checkpoint`` greedy and with beam
   3 (the same gates), timed with the loader; ``pruning.main`` at 0.5
   (exactly round(0.5 · total) prunable elements zero) and
   ``pruning_test.test`` on the pruned checkpoint (K1 and K2 launched); the
   first batch's f32 greedy rows, card vs CPU, reported;
7. teacher: the full-width GIT-Large teacher (CLIP ViT-L/14 + the 6-layer
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
7b. generate: the same teacher with ``set_softmax_native_pallas(True)``
   (turned off again in a ``finally``): the forward (every K4 launch a K4n
   launch; its logits' distance from the mode-off forward's reported), the
   sampled beam (``do_sample``, temperature 1, top-k 50, top-p 0.9, batch
   2 × 4 beams × 15 steps: one generator seed gives one row set twice,
   another seed another; rows SOS first and EOS-padded), the exact beam
   and ``teacher_generate`` (JAX's keys, ``output`` ``[1, n, 30522]``,
   ``cap`` the tokenizer's decode of its row), each timed with CUDA events
   and its launches counted; then the depth-cut f32 teacher's sampled beam,
   card vs CPU from one CPU generator (first-token divergence reported);
8. train: the full-width student (bfloat16 compute over float32 master
   weights) and the full-width teacher run 5 steps of the default
   ``make_train_step`` (kl + ce, dropout 0.3, DropPath, Adam at lr 1e-4)
   on 8 preprocessed windows with 40-token captions, printing each step's
   time and parts, losses, gradient norm and peak memory. Every parameter
   the loss reaches must get a finite gradient, nonzero somewhere, and
   only the distillation heads that kl + ce leave unused none; launch
   counts must equal the layer counts. Then one float32 step (TF32 off,
   one window, no dropout, the teacher cut to 2 CLIP blocks and 2 joint
   layers) on the card is held against the same step on the CPU;
9. loop: ``train()`` at full width (the same bf16 student over float32
   masters and bf16 teacher, batches of 8) on a seeded MSRVTT-format tree
   of 24 train, 8 validate and 8 test clips, two epochs of three steps,
   under ``torch.use_deterministic_algorithms(True)``: live with
   background checkpoints; through a full-vocab ``TeacherLogitsCache``
   (24 misses, then 24 hits, epoch losses within 1e-5 of live);
   SIGTERM after step 4, ``ckpt_preempt``, then ``resume_schedule`` to an
   end state (master weights, Adam moments, BatchNorm statistics) equal to
   the live run's bit for bit; beam-KD (``ce_teacher`` and
   ``beam_consensus``) through a top-128 ``TeacherBeamCache``, whose hit
   epoch launches no teacher kernel; ``python -m rtvc_tpu_torch.train``,
   then ``python -m rtvc_tpu_torch.evaluate`` on its newest checkpoint
   (rows equal to the test epoch's). Each epoch's and each eval pass's
   launches are checked against the layer counts; each run prints its
   epochs' step ms, first step, host share, checkpoint waits and eval
   time. Then the beam-KD step with the live beam inside it, and the
   default step's peak memory with and without ``remat_encoder``;
10. parallel: ``rtvc_tpu_torch.parallel`` on the one card. (a) Two gloo
   ranks (``python -m rtvc_tpu_torch.parallel.dryrun`` processes, both
   on the card) run 3 full-width bf16 steps of the default
   ``make_train_step`` (dropout and DropPath on) on a global batch of 8,
   4 rows a rank: each rank's K1, K2, K4, K5, K6 and K9 launches must
   equal the layer counts, the master weights must be equal across the
   ranks bit for bit, the losses finite (printed beside one rank's run of
   the 8 rows). (b) The same in float32 with TF32 off and the teacher cut
   to 2 CLIP blocks and 2 joint layers, 2 steps, against one rank on the
   same card, the dp ranks taking step 2 from the one rank's state after
   step 1: each step's losses, gradient norm and gradient leaves, the
   BatchNorm statistics and the final master weights within
   ``PAR_LIMITS`` (``compare_runs``). (c) tp = 2, one
   float32 step: each rank holds half the vocab rows of the student's
   projection and embedding and the teacher's output head and word
   embeddings; the same limits against tp = 1. (d) ``BatchCaptionServer``
   on ``make_mesh((2, 1), devices=[card, card])``, greedy with
   ``vocab_int8``: 8 windows form one batch, split 4 + 4 over the two
   replicas, whose rows equal ``make_caption_step``'s at batch 4 on each
   half bit for bit, and K1, K2 and K3 launch the layer counts on each
   replica. (e) A rank that owns the card takes NCCL
   (``initialize_distributed``'s choice, where (a)-(c) take gloo) and
   its one-rank group runs the mesh's all-reduce, all-gather and
   broadcast on bf16 and float32, exactly. Each multi-rank
   job has a timeout and a failed rank fails the phase; the phase prints
   ms a step at dp = 2 against one rank and each rank's time from process
   start to its first step, beside the card's name and power limit.

It prints the kernels' record as one JSON line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import copy
import functools
import itertools
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
# The bf16 tensor-core K1 and K8 are held closer: each output to this share
# of its own largest value, with no floor at 1 (K8's gradients lie below
# 1). K1 at 2^-7, the most one bf16 ulp of the largest value can be: a K1
# that adds the bias unrounded in the bf16 mode misses by more at each
# caption-step stage, and a K8 without 1/keep, without Delta or with dP
# unmasked where dropped misses by more than 2e-2
# (tests/test_torch_card_limits.py). K7 is held to 0 in both dtypes: its
# integer sums are exact and its float32 epilogue rounds in the plain
# version's order, so a fused multiply-add or a bias added before sw shows
# as an error above 0 (tests/test_torch_card_limits.py).
# K2 in float32 at 2e-5 of max(1, max|plain|): a one-pass E[x^2] - mean^2
# variance misses the centred one by 6.5e-5 to 2e-4 of that scale on rows
# of mean 64 and spread 2, which the TOL of 1e-4 passes at the decode's
# [8, 576]; the centred two passes in the kernel's order miss by ~2e-6
# (tests/test_torch_card_limits.py).
FLOOR_ONE_TOL = {("layer_norm", "float32"): 2e-5}
OWN_SCALE_TOL = {("window_attention", "bfloat16"): 2 ** -7,
                 ("flash_attention_bwd", "bfloat16"): 2e-2,
                 ("flash_attention_bwd_native", "bfloat16"): 2e-2,
                 ("w8a8_matmul", "float32"): 0.0,
                 ("w8a8_matmul", "bfloat16"): 0.0}
# the kernels that must give the same bits on every run: each of their
# cases runs twice
DETERMINISTIC = ("dw3x3_wgrad",)
# card vs CPU, float32, TF32 off: the full 14-stage encoder and 2-layer
# decoder (or the depth-cut teacher) with every sum in another order
SLICE_TOL = 1e-3
# gradient leaves below this share of the largest are held to it (see
# train_f32_check)
GRAD_FLOOR = 1e-4
CAPTION_LEN = 40               # teacher-forced caption tokens
TAPS = (0, 6, 12, 18)          # CLIP blocks tapped for distillation
BEAM_BATCH, BEAMS, BEAM_STEPS = 2, 4, 15
SERVE_BEAM = 3                 # the student beam's k in the serve phase
# tokens the compiled package decodes: AOTInductor compiles the unrolled
# decode, and at MAX_LEN its save_compiled took 167-315 s on an H100
# host, a third of the script's time limit
COMPILED_MAX_LEN = 10
SERVER_WAIT_MS = 50.0          # the server's linger: 8 submits form 1 batch
HTTP_ROUNDS = 3                # bursts of 8 concurrent HTTP requests
# the eval phase's MSRVTT-format test split: 20 clips of 12 frames at
# MSRVTT's 320x240, 20 captions a clip; batches of 8, 8 and 4
EVAL_CLIPS, EVAL_CLIP_FRAMES, EVAL_HW, EVAL_CAPTIONS = 20, 12, (240, 320), 20
EVAL_MAX_LEN = 45              # the 40-token caption bucket + max_len_extra 5
EVAL_BEAM = 3
EVAL_LIVELY = 10.0             # lively_'s scale: rows that depend on the clip
PRUNE_RATIO = 0.5
EVAL_KEYS = {"corpus_bleu4", "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
             "METEOR", "ROUGE_L", "CIDEr"}

KERNELS = {
    "window_attention": ("rtvc_tpu_torch/csrc/window_attention_sm90.cu",
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
    "w8a8_matmul": ("rtvc_tpu_torch/csrc/w8a8_matmul_sm90.cu",
                    "rtvc_tpu/ops/int8_gemm.py:100"),
    "flash_attention_bwd": ("rtvc_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
                            "rtvc_tpu/ops/attention.py:452"),
    "dw3x3_wgrad": ("rtvc_tpu_torch/csrc/depthwise_wgrad.cu",
                    "rtvc_tpu/ops/depthwise.py:90"),
    # K4 and K8 in the input-dtype softmax (_block_probs' softmax_native)
    "flash_attention_native": ("rtvc_tpu_torch/csrc/flash_attention_sm90.cu",
                               "rtvc_tpu/ops/attention.py:136"),
    "flash_attention_bwd_native": (
        "rtvc_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
        "rtvc_tpu/ops/attention.py:136"),
    # K4n's first two sweeps alone: the row statistics K8n takes where no
    # forward left them (a standalone flash_attention_bwd call)
    "flash_attention_stats_native": (
        "rtvc_tpu_torch/csrc/flash_attention_sm90.cu",
        "rtvc_tpu/ops/attention.py:136"),
}
KERNEL_ZERO = {name: 0 for name in KERNELS}
# K1's and K2's kernel symbols, as a profiler trace names them
TRACE_SYMBOLS = {"window_attention": "window_attention_sm90_kernel",
                 "layer_norm": "layer_norm_vec_kernel"}
# the sampled teacher beam of the generate phase
SAMPLE = dict(do_sample=True, temperature=1.0, top_k=50, top_p=0.9)
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


# the tensor-core kernels: family -> (mangled-name pattern, the tensor-core
# instruction it must hold). A K4/K5 name is the bare "attention_sm90_kernel"
# after its length prefix; K1's, K7's and K8's carry their own words.
SASS_FAMILIES = {
    "K4/K5": (r"\dattention_sm90_kernel", "HGMMA"),
    "K4n": (r"attention_native_sm90_kernel", "HGMMA"),
    "K1": (r"window_attention_sm90_kernel", "HMMA"),
    "K8 dQ": (r"attention_bwd_dq_sm90_kernel", "HGMMA"),
    "K8n dQ": (r"attention_bwd_dq_native_sm90_kernel", "HGMMA"),
    "K8 dK/dV": (r"attention_bwd_dkv_sm90_kernel", "HGMMA"),
    "K7": (r"w8a8_sm90_kernel", "IGMMA"),
    "K3": (r"w8_matmul_tc_kernel", "HMMA"),
}
SASS_OPS = ("HMMA", "HGMMA", "IGMMA", "WARPGROUP.DEPBAR")


def sm90_sass(library) -> dict:
    """What the tensor-core kernels were compiled to, from ``cuobjdump`` on
    the built library, per family of SASS_FAMILIES: the HMMA (warp
    tensor-core product), HGMMA and IGMMA (bf16 and int8 warpgroup
    products) and ``WARPGROUP.DEPBAR`` (wait for the products) instructions
    summed over the family's instances, and each instance's registers per
    thread. A DEPBAR per warpgroup product would mean ptxas serialised the
    products."""
    import re
    from pathlib import Path
    from rtvc_tpu_torch import _build
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    usage = subprocess.run([tool, "-res-usage", str(library)],
                           capture_output=True, text=True, check=True,
                           timeout=300).stdout
    out = {}
    for family, (pattern, _) in SASS_FAMILIES.items():
        ops, inside = dict.fromkeys(SASS_OPS, 0), False
        for line in sass.splitlines():
            if "Function :" in line:
                inside = re.search(pattern, line) is not None
            elif inside:
                for op in ops:
                    ops[op] += op in line
        ops["registers"] = [int(m.group(1)) for m in re.finditer(
            pattern + r"\S*\s+REG:(\d+)", usage)]
        out[family] = ops
    return out


def rel_err(got, want, floor: float = 1.0) -> tuple:
    """(max |got - want|, that divided by max(floor, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(floor, float(want.float().abs().max()))


def native_gate(got, want, off) -> tuple:
    """The input-dtype softmax's discriminating gate, beside its bf16
    limit (which a kernel ignoring the mode would pass: the two modes lie
    within 2e-2 of each other): (passes, mean |got - want|, mean |off -
    want|), ``want`` the mode's plain version, ``off`` the mode-off plain
    version on the same inputs. It passes where the first mean is below
    half the second."""
    err = float((got.float() - want.float()).abs().mean())
    gap = float((off.float() - want.float()).abs().mean())
    return err < 0.5 * gap, err, gap


def stats_gate(got, want) -> tuple:
    """K4n's row statistics [..., 2] against their plain version: (passes,
    max |got - want|, the largest bf16 ulp distance of the reciprocals).
    The max must agree bit for bit (fmaxf in any order), bf16(1 / z) within
    one bf16 ulp (the float32 sum runs in another order)."""
    import torch
    err = float((got - want).abs().max())
    same_max = torch.equal(got[..., 0], want[..., 0])
    bits = [t[..., 1].to(torch.bfloat16).view(torch.int16).int()
            for t in (got, want)]
    ulps = int((bits[0] - bits[1]).abs().max())
    return same_max and ulps <= 1, err, ulps


def limit(name: str, dtype: str) -> tuple:
    """(tolerance, floor of the scale) a kernel's case is held to: TOL (or
    FLOOR_ONE_TOL) of max(1, max|plain|), or OWN_SCALE_TOL of
    max|plain|."""
    if (name, dtype) in OWN_SCALE_TOL:
        return OWN_SCALE_TOL[name, dtype], 1e-30
    return FLOOR_ONE_TOL.get((name, dtype), TOL[dtype]), 1.0


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev, g):
    """Each case as a dict: kernel name, label, the kernel call, the plain
    call, timing reps, the work it must do (for its bound) and a maker of
    its library yardstick (``rtvc_tpu_torch.yardsticks``), at the main
    path's shapes. The caption step's: TinyViT window attention per stage
    at batch 1 and 8 (6-frame windows), the decoder's [B, 576] norms and
    TinyViT's stage 1-3 norms at batch 8, the vocab GEMV at 1 and 8 rows
    with a warm and a cold L2 (a case may carry ``replaced``, what its
    kernel's path replaces, timed beside it). The teacher's:
    the joint attention over 1542 visual + 40 text tokens at batch 8 (on
    strided head views of the QKV product, as the model passes them), a
    ragged and a key-masked case (one row with no key left), the CLIP
    attention of 48 frames, the CLIP norms over 48 × 257 tokens at eps
    1e-5 and the joint norms over 8 × 1582 tokens at eps 1e-12, the ln_2
    add + norm, and the W8A8 GEMMs of CLIP's qkv and MLP Linears at
    M = 12336, of the joint fc2 at M = 12656 (K up to 4096, where the
    int32 sums pass 2^24) and of the vocab projection at the
    teacher-forced M = 320 and a beam's M = 8. The train step's: K4 with
    dropout 0.1 at the joint shape, K8 there with and without dropout and
    on the ragged, key-masked case, K9 on the four stride-1 depthwise
    shapes of the batch-8 TinyViT (MBConv at stage 0, local_conv at
    stages 1-3). The beam's visual prefill [8, 12, 1542, 64] (every key
    visible). In both dtypes, the edges (labels with "edge:") of K7 and
    K9 (listed where they are made). In bfloat16, the edges of the
    tensor-core K4/K5: D = 32 and 40 (zero-padded columns), Lq = 1, Lkv
    below one 64-key tile, Lq and Lkv off the 64/128 grid, a batch row
    with every key masked, BLHD at L = 50; of the tensor-core K1, in both
    score modes: 7 windows, N = 16, 64, 100, 196 and 256 and a bias scaled
    by 8; of the tensor-core K8: D = 32, Lq = 1, Lkv = 37, bidirectional
    with no mask, a batch row with every key masked."""
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

    def native_mode(name, label, args, kw, reps, standalone=False):
        """K4n or K8n (``name``) in the input-dtype softmax against the
        mode's plain version; beside it the mode-off plain version (the
        discriminating gate's reference) and the mode-off kernel (timed
        beside). K8n runs as autograd runs it, on the statistics its
        forward left (``k8n_after_forward``), or ``standalone``, as
        ``flash_attention_bwd`` (a stats-only K4n launch first). The bound
        is the function's own work, as K4's or K8's."""
        fwd = name == "flash_attention_native"
        kern = attention.flash_attention if fwd else \
            attention.flash_attention_bwd
        plain = attention.flash_attention_plain if fwd else \
            attention.flash_attention_bwd_plain
        native = functools.partial(kern, softmax_in_input_dtype=True)
        if not fwd and not standalone:
            native = k8n_after_forward(*args, **kw)
        add(name, label, reps, native,
            functools.partial(plain, softmax_in_input_dtype=True), args, kw,
            Y.flash_work if fwd else Y.flash_bwd_work,
            Y.flash_library if fwd else Y.flash_bwd_library)
        cases[-1].update(
            off=lambda: plain(*args, **kw),
            off_kern=lambda: kern(*args, softmax_in_input_dtype=False, **kw))

    def native_stats(label, args, kw):
        """K4n's stats-only launch against its plain version
        (``stats_gate``)."""
        add("flash_attention_stats_native", label, 10,
            attention.flash_attention_stats,
            attention.flash_attention_stats_plain, args, kw,
            Y.flash_stats_work, Y.flash_stats_library)
        cases[-1].update(check=stats_gate)

    def w8_cold(label, variants, replaced):
        """K3 with a cold L2: each call of the kernel, its plain version
        and each yardstick takes the next of ``variants`` (``replaced``
        for the bf16 ``F.linear``), each with a weight of its own."""
        def rotate(fns):
            turn = itertools.cycle(fns)
            return lambda: next(turn)()
        libs = [Y.w8_library(*a) for a in variants]
        linears = [Y.w8_replaced_library(*a) for a in replaced]
        cases.append(dict(
            name="w8_matmul", label=label, reps=50,
            kern=rotate([functools.partial(int8_gemm.w8_matmul, *a)
                         for a in variants]),
            plain=rotate([functools.partial(int8_gemm.w8_matmul_plain, *a)
                          for a in variants]),
            work=Y.w8_work(*variants[0]),
            library=lambda: Y.Yardstick(
                libs[0].name,
                libs[0].fn and rotate([y.fn for y in libs])),
            replaced=Y.Yardstick(linears[0].name,
                                 rotate([y.fn for y in linears]))))

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
        # the eval phase's ragged last batch, 4 clips of 6 frames, at each
        # stage (correctness only)
        for stage, (nw, h, n) in enumerate(
                ((16, 6, 49), (1, 12, 196), (1, 18, 49)), start=1):
            b = 4 * FRAMES * nw
            add("window_attention",
                f"{dn} edge: eval b4 stage{stage} [{b},{h},{n},32]", 10,
                attention.window_attention, attention.window_attention_plain,
                tuple(rand(b, h, n, 32, dtype=dtype) for _ in range(3))
                + (rand(h, n, n, scale=0.5),),
                dict(softmax_in_input_dtype=True), Y.window_work,
                Y.window_library)
        if dtype == torch.bfloat16:
            # the tensor-core K1's edges, in both score modes: a window
            # batch that divides no grid, N = 16 (one 16-key chunk), N = 64
            # (whole 16-key chunks, no padding), N = 100, 196 and 256 (the
            # 8-, 13- and 16-chunk instances; N = 100 on 96 windows, where
            # the native mode copies the bias into shared memory, and on
            # 24, where it reads it from L2), a bias large enough that one
            # key takes nearly all of a row
            for native in (True, False):
                mode = "native" if native else "f32 scores"
                for label, b, h, n, bias_scale in (
                        ("B*nW=7", 7, 6, 49, 0.5), ("N=16", 24, 6, 16, 0.5),
                        ("N=64", 24, 6, 64, 0.5), ("N=100", 96, 6, 100, 0.5),
                        ("N=100", 24, 6, 100, 0.5),
                        ("N=196", 24, 6, 196, 0.5),
                        ("N=256", 24, 6, 256, 0.5),
                        ("bias x8", 24, 6, 49, 8.0)):
                    add("window_attention",
                        f"{dn} edge: {label} {mode} [{b},{h},{n},32]", 10,
                        attention.window_attention,
                        attention.window_attention_plain,
                        tuple(rand(b, h, n, 32, dtype=dtype)
                              for _ in range(3))
                        + (rand(h, n, n, scale=bias_scale),),
                        dict(softmax_in_input_dtype=native), Y.window_work,
                        Y.window_library)
        # K2 where the caption step launches it: the decoder's [B, 576]
        # norms at b1 and b8, and at the beam's B·k rows ([3, 576] and
        # [24, 576] with k = 3), TinyViT's norms at b8 (stage 1-3 attention
        # and MLP norms: [37632, 192], [9408, 384], [2352, 576]), and the
        # [200, 576] earlier records quoted; then rows of mean 64 and
        # spread 2, where a one-pass variance would lose the spread; then
        # the edges (correctness only): 7 rows of 192 (a warp's last group
        # of lanes past the last row), widths 40 and 100, which take the
        # generic kernel (100 bf16 values are no 16-byte multiple), and the
        # eval phase's ragged last batch of 4: its decoder norms, greedy and
        # beam 3, and its TinyViT norms at 24 frames
        tiny, ragged = 8 * FRAMES, 4 * FRAMES
        for label, rows, width, mean, reps in (
                ("", 1, 576, 0.0, 50), ("", 8, 576, 0.0, 50),
                ("beam ", SERVE_BEAM, 576, 0.0, 50),
                ("beam ", WINDOWS * SERVE_BEAM, 576, 0.0, 50),
                ("", 8 * 25, 576, 0.0, 50), ("", tiny * 28 * 28, 192, 0.0, 50),
                ("", tiny * 14 * 14, 384, 0.0, 50),
                ("", tiny * 7 * 7, 576, 0.0, 50),
                ("mean 64 ", tiny * 7 * 7, 576, 64.0, 50),
                ("edge: ", 7, 192, 0.0, 10), ("edge: ", 5, 40, 0.0, 10),
                ("edge: ", 9, 100, 0.0, 10),
                ("edge: eval b4 ", 4, 576, 0.0, 10),
                ("edge: eval beam b4 ", 4 * SERVE_BEAM, 576, 0.0, 10),
                ("edge: eval b4 ", ragged * 28 * 28, 192, 0.0, 10),
                ("edge: eval b4 ", ragged * 14 * 14, 384, 0.0, 10),
                ("edge: eval b4 ", ragged * 7 * 7, 576, 0.0, 10)):
            add("layer_norm", f"{dn} {label}[{rows},{width}]", reps,
                layernorm.layer_norm, layernorm.layer_norm_plain,
                ((rand(rows, width, scale=2.0) + mean).to(dtype),
                 rand(width, dtype=dtype), rand(width, dtype=dtype)), {},
                Y.layer_norm_work, Y.layer_norm_library)
        # K3 on the vocab pack at the greedy step's M = 1 and 8 and the
        # beam's M = B·k = 3 and 24: warm (one weight, which the 50 MB L2
        # keeps between calls) and cold (each call the next of 5 weights,
        # 91.5 MB, so each finds its weight evicted); then the edges
        # (correctness only): M = 3, 16 and 32 (a partial and two and four
        # n-tiles), N = 1000 (a partial tile), K = 144 (a partial 64-k
        # chunk), no bias
        packs = [torch.randint(-127, 128, (31744, 576), generator=g,
                               dtype=torch.int8).to(dev)
                 for _ in range(5 if dtype == torch.bfloat16 else 1)]
        sw = (torch.rand(31744, generator=g) / (127 * 24)).to(dev)
        bb = rand(31744, scale=0.1)
        vocab_w = rand(30522, 576, dtype=dtype, scale=0.04)
        vocab_b = rand(30522, dtype=dtype, scale=0.1)
        for m in (1, 8, SERVE_BEAM, WINDOWS * SERVE_BEAM):
            x = rand(m, 576, dtype=dtype)
            add("w8_matmul", f"{dn} M={m} [576,31744]", 50,
                int8_gemm.w8_matmul, int8_gemm.w8_matmul_plain,
                (x, packs[0].t(), sw, bb), {}, Y.w8_work, Y.w8_library)
            cases[-1]["replaced"] = Y.w8_replaced_library(x, vocab_w,
                                                          vocab_b)
            if len(packs) > 1:
                w8_cold(f"{dn} cold L2 M={m} [576,31744]",
                        [(x, p.t(), sw, bb) for p in packs],
                        [(x, w, vocab_b) for w in (
                            vocab_w, vocab_w.clone(), vocab_w.clone())])
        for label, m, k, n, bias in (("", 3, 576, 31744, True),
                                     ("", 16, 576, 31744, True),
                                     ("", 32, 576, 31744, True),
                                     ("", 8, 576, 1000, True),
                                     ("", 8, 144, 1000, True),
                                     ("no bias ", 8, 576, 31744, False)):
            pack = packs[0] if (n, k) == (31744, 576) else int8(n, k)
            add("w8_matmul", f"{dn} edge: {label}M={m} [{k},{n}]", 10,
                int8_gemm.w8_matmul, int8_gemm.w8_matmul_plain,
                (rand(m, k, dtype=dtype), pack.t(), sw[:n],
                 bb[:n] if bias else None), {}, Y.w8_work, Y.w8_library)
        del packs

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
        if dtype == torch.bfloat16:
            # the tensor-core K8's edges: D = 32 on packed heads, Lq = 1,
            # Lkv below one 64-key tile, bidirectional with no mask, and a
            # batch row whose keys are all masked (the uniform average)
            fmask = torch.rand(2, 333, generator=g).to(dev) > 0.5
            fmask[1] = False
            for label, args, kw in (
                    ("D=32 [2,4,300,32] prefix 260",
                     packed_heads(2, 300, 4, 32, dtype)
                     + (rand(2, 4, 300, 32, dtype=dtype),),
                     dict(causal=True, prefix_len=260)),
                    (f"Lq=1 [3,4,1x200,{d}]",
                     tuple(rand(3, 4, n, d, dtype=dtype)
                           for n in (1, 200, 200, 1)), {}),
                    (f"Lkv=37 [2,4,150x37,{d}] prefix 20",
                     tuple(rand(2, 4, n, d, dtype=dtype)
                           for n in (150, 37, 37, 150)),
                     dict(causal=True, prefix_len=20)),
                    (f"bidirectional [2,3,200x333,{d}]",
                     tuple(rand(2, 3, n, d, dtype=dtype)
                           for n in (200, 333, 333, 200)), {}),
                    (f"fully masked batch row [2,3,200x333,{d}]",
                     tuple(rand(2, 3, n, d, dtype=dtype)
                           for n in (200, 333, 333, 200)),
                     dict(kv_mask=fmask))):
                add("flash_attention_bwd", f"{dn} edge: {label}", 3,
                    attention.flash_attention_bwd,
                    attention.flash_attention_bwd_plain, args, kw,
                    Y.flash_bwd_work, Y.flash_bwd_library)
        # K9 at the train step's four shapes, then at its edges
        # (correctness only): one image, a channel count no group size
        # divides, 1 x 1 and 5 x 9 planes
        for label, shape in (
                ("stage0", (WINDOWS * FRAMES, 384, 56, 56)),
                ("stage1", (WINDOWS * FRAMES, 192, 28, 28)),
                ("stage2", (WINDOWS * FRAMES, 384, 14, 14)),
                ("stage3", (WINDOWS * FRAMES, 576, 7, 7)),
                ("edge: one image", (1, 384, 14, 14)),
                ("edge: C=3", (8, 3, 28, 28)),
                ("edge: 1x1 planes", (8, 64, 1, 1)),
                ("edge: 5x9 planes", (4, 40, 5, 9))):
            add("dw3x3_wgrad", f"{dn} {label} [{','.join(map(str, shape))}]",
                20, depthwise.dw3x3_wgrad, depthwise.dw3x3_wgrad_plain,
                tuple(rand(*shape, dtype=dtype) for _ in range(2)), {},
                Y.dw3x3_wgrad_work, Y.dw3x3_wgrad_library)
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
            flash(f"{dn} beam prefill [{b},{h},{prefix},{d}]",
                  packed_heads(b, prefix, h, d, dtype),
                  dict(causal=True, prefix_len=prefix))
            # K4n and K8n, the input-dtype softmax: K4's joint, key-masked
            # (its last batch row with every key masked), dropout and beam
            # prefill cases, then a fully masked batch row and a ragged
            # length (correctness only); K8's joint, key-masked ragged and
            # dropout cases
            fa, fb = "flash_attention_native", "flash_attention_bwd_native"
            mode = native_mode
            mode(fa, f"{dn} joint [{b},{h},{lq},{d}] prefix {prefix}", heads,
                 joint, 10)
            mode(fa, f"{dn} key-masked [{b},{h},{lq},{d}]", heads,
                 dict(joint, kv_mask=mask), 10)
            mode(fa, f"{dn} dropout 0.1 joint [{b},{h},{lq},{d}]", heads,
                 dict(joint, **drop), 10)
            mode(fa, f"{dn} beam prefill [{b},{h},{prefix},{d}]",
                 packed_heads(b, prefix, h, d, dtype),
                 dict(causal=True, prefix_len=prefix), 10)
            mode(fa, f"{dn} edge: fully masked batch row [2,3,200x333,{d}]",
                 odd, dict(kv_mask=omask), 10)
            mode(fa, f"{dn} edge: Lq=200 Lkv=333 [2,3,200x333,{d}] prefix "
                     f"150", odd, dict(causal=True, prefix_len=150), 10)
            g_joint = rand(b, h, lq, d, dtype=dtype)
            mode(fb, f"{dn} joint [{b},{h},{lq},{d}] prefix {prefix}",
                 heads + (g_joint,), joint, 3)
            mode(fb, f"{dn} key-masked ragged [2,{h},1000x1037,{d}] prefix "
                     f"900", ragged + (rand(2, h, 1000, d, dtype=dtype),),
                 dict(causal=True, prefix_len=900, kv_mask=rmask), 3)
            mode(fb, f"{dn} dropout 0.1 joint [{b},{h},{lq},{d}]",
                 heads + (g_joint,), dict(joint, **drop), 3)
            mode(fb, f"{dn} standalone joint [{b},{h},{lq},{d}] prefix "
                     f"{prefix}", heads + (g_joint,), joint, 3,
                 standalone=True)
            # the stats-only launch K8n's standalone call makes
            native_stats(f"{dn} joint [{b},{h},{lq},{d}] prefix {prefix}",
                         heads[:2], joint)
            native_stats(f"{dn} key-masked [{b},{h},{lq},{d}]", heads[:2],
                         dict(joint, kv_mask=mask))
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
        # K7 at the teacher's sites, then at its edges (correctness only):
        # one row, rows past one 64-row warpgroup, K below and off the
        # 128-byte stage, an odd N, the vocab's ragged N at a beam's rows,
        # no bias
        for label, m, k, n, bias in (
                ("clip qkv", rows, 1024, 3072, True),
                ("clip c_fc", rows, 1024, 4096, True),
                ("clip c_proj", rows, 4096, 1024, True),
                ("joint fc2", joint_rows, 3072, 768, True),
                ("vocab", WINDOWS * CAPTION_LEN, 768, 30522, True),
                ("vocab", WINDOWS, 768, 30522, True),
                ("edge: one row", 1, 1024, 3072, True),
                ("edge: rows past a warpgroup", 65, 1024, 3072, True),
                ("edge: K below a stage", 300, 16, 520, True),
                ("edge: K off the stage", 300, 144, 520, True),
                ("edge: odd N", 65, 144, 257, True),
                ("edge: vocab N at a beam's rows", 8, 144, 30522, True),
                ("edge: no bias", 1000, 1024, 3072, False)):
            xq, pack = int8(m, k), int8(n, k)
            sx = torch.rand(m, generator=g).to(dev) * 0.02 + 1e-3
            swn = torch.rand(n, generator=g).to(dev) * 1e-3 + 1e-4
            add("w8a8_matmul", f"{dn} {label} M={m} [{k}->{n}]", 10,
                int8_gemm.w8a8_matmul, int8_gemm.w8a8_matmul_plain,
                (xq, sx, pack.t(), swn,
                 rand(n, scale=0.1) if bias else None, dtype), {},
                Y.w8a8_work, Y.w8a8_library)
    return cases


def k8n_after_forward(q, k, v, g, *, causal=False, prefix_len=0,
                      kv_mask=None, scale=None, dropout_rate=0.0, seed=None):
    """K8n as ``loss.backward()`` runs it after a forward in the input-dtype
    softmax: the forward (K4n, run here once) leaves the rows' statistics,
    which each call of the returned function hands to K8n."""
    from rtvc_tpu_torch.ops import attention
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    stats = attention._stats_buffer(q)
    attention._flash_forward(q, k, v, kv_mask, causal, prefix_len, scale,
                             dropout_rate, seed, True, stats=stats)
    return lambda *_, **__: attention._flash_backward(
        q, k, v, g, kv_mask, causal, prefix_len, scale, dropout_rate, seed,
        True, row_stats=stats)


def native_probe(dev) -> dict:
    """K4n/K8n's exact fast exponential and dropout division
    (``native_exp``, ``native_div`` in csrc/flash_attention_sm90.cuh)
    on every input of their bf16 domains (d <= 0 and -inf; p in [0, 1] at
    rate 0.1) against the per-score ``bf16r(expf(d))`` and ``bf16r(p / keep_b)``,
    by ``attention.native_probe``. It fails on any mismatch, on an input whose
    normal expf(d) the exponential's bracket misses, or on a short
    domain."""
    import struct
    from rtvc_tpu_torch.ops import attention
    n = attention.native_probe(dev, 0.1)
    rec = dict(exp_inputs=n[0], exp_mismatches=n[1], exp_fallback_pairs=n[2],
               exp_bracket_misses=n[3],
               exp_max_rel_err=struct.unpack("<f", struct.pack("<i", n[4]))[0],
               div_inputs=n[5], div_mismatches=n[6], div_fallback_pairs=n[7])
    log(f"  probe: exponential {n[0]} inputs, {n[1]} mismatches, {n[2]} took "
        f"expf, {n[3]} normal expf(d) outside the bracket, largest "
        f"relative error {rec['exp_max_rel_err']:.3e}; dropout division "
        f"{n[5]} inputs, {n[6]} mismatches, {n[7]} divided")
    if n[1] or n[3] or n[6] or n[0] != 32642 or n[5] != 16257:
        raise AssertionError(f"the exact fast exponential or division "
                             f"differs from the per-score formula: {rec}")
    return rec


def library_ms(yardstick, reps: int, samples: int = 1) -> tuple:
    """(device ms per call or None, the call's name, "graph" or "eager",
    every timing in ms) of a library yardstick: the median of ``samples``
    timings. A call the card's torch refuses (a shape or type it does not
    take) is recorded as none, with the reason."""
    if yardstick.fn is None:
        return None, yardstick.name, None, []
    try:
        runs = [device_ms(yardstick.fn, reps) for _ in range(samples)]
    except (RuntimeError, NotImplementedError) as e:
        reason = str(e).strip().splitlines()[0][:120]
        return None, f"none: {yardstick.name} raised {reason}", None, []
    times = sorted(ms for ms, _ in runs)
    timing = "/".join(sorted({how for _, how in runs}))
    return times[len(times) // 2], yardstick.name, timing, [ms for ms, _ in
                                                            runs]


def kernel_phase(dev):
    """Each case of kernel_cases held against its plain version; every case
    but the edge cases (correctness only) timed. The phase fails after its
    last case if any case failed, naming each."""
    import torch
    g = torch.Generator().manual_seed(SEED)
    log(f"  torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32} (K9's float32 yardstick, "
        f"conv2d_weight, runs in TF32 where True)")
    records, failed = [], []
    for c in kernel_cases(dev, g):
        name, label, reps = c["name"], c["label"], c["reps"]
        got = c["kern"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [
            (got, want)]
        dtype = str(pairs[0][1].dtype).removeprefix("torch.")
        finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
        if "check" in c:
            passed, err, ulps = c["check"](got, want)
            ok = passed and finite
            line = (f"  {name:20s} {label:52s} max_abs_err {err:.3e}, max "
                    f"bit for bit, 1 / z within {ulps} bf16 ulp (tol 1)")
            rec = dict(name=name, case=label, max_abs_err=err, ulps=ulps)
        else:
            tol, floor = limit(name, dtype)
            errs = [rel_err(a, b, floor) for a, b in pairs]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            ok = rel <= tol and finite
            scale = "max(1, max|plain|)" if floor == 1.0 else "max|plain|"
            line = (f"  {name:20s} {label:52s} max_abs_err {err:.3e} = "
                    f"{rel:.2e} of {scale} (tol {tol:g})")
            rec = dict(name=name, case=label, max_abs_err=err, rel_err=rel,
                       tol=tol, tol_of=scale)
        if name in DETERMINISTIC:
            same = torch.equal(got, c["kern"]())
            line += f" second run {'bitwise equal' if same else 'DIFFERS'}"
            rec.update(bitwise_repeat=same)
            ok = ok and same
        if "off" in c:
            # the discriminating gate: the bf16 limit alone would pass a
            # kernel that ignored the mode
            off = c["off"]()
            gates = [native_gate(a, b, o) for (a, b), o in zip(
                pairs, off if isinstance(off, tuple) else (off,))]
            passed = all(gt[0] for gt in gates)
            line += (" gate " + "/".join(f"{gt[1]:.2e}<{gt[2] / 2:.2e}"
                                         for gt in gates)
                     + (" ok" if passed else " FAIL"))
            rec.update(gate_mean_err=[gt[1] for gt in gates],
                       gate_mean_off_gap=[gt[2] for gt in gates],
                       gate_passed=passed)
            ok = ok and passed
            del off
        del got, want, pairs
        if "edge:" in label:
            log(f"{line} correctness only {'ok' if ok else 'FAIL'}")
        else:
            ms, timing = device_ms(c["kern"], reps)
            plain_ms, plain_timing = device_ms(c["plain"], reps)
            # SDPA's backward, bf16 K8's and K8n's yardstick, moved between
            # runs (1541-3226 us at the joint shape): the median of three
            samples = 3 if dtype == "bfloat16" and name in (
                "flash_attention_bwd", "flash_attention_bwd_native") else 1
            lib_ms, lib_call, lib_timing, lib_runs = library_ms(
                c["library"](), reps, samples)
            bound_s, bound_by = c["work"].bound()
            if "off_kern" in c:
                # the mode-off kernel on the same inputs, timed beside
                off_ms, _ = device_ms(c["off_kern"], reps)
                line += f" mode-off kernel {off_ms * 1e3:.2f} us"
                rec.update(off_kernel_ms=off_ms)
            lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
            if len(lib_runs) > 1:
                lib += " (median of " + ", ".join(
                    f"{t * 1e3:.2f}" for t in lib_runs) + ")"
            if "replaced" in c:
                # not a yardstick: what the kernel's path replaces
                rep_ms, rep_call, rep_timing, _ = library_ms(c["replaced"],
                                                             reps)
                lib += f"; replaces {rep_call} {rep_ms * 1e3:.2f} us"
                rec.update(replaced_us=rep_ms * 1e3, replaced_call=rep_call,
                           replaced_timing=rep_timing)
            log(f"{line} kernel {ms * 1e3:10.2f} us  plain "
                f"{plain_ms * 1e3:10.2f} us  bound {bound_s * 1e6:.2f} us "
                f"({bound_by}, {bound_s * 1e3 / ms:.1%})  library {lib}  "
                f"[{timing}/{plain_timing}/{lib_timing or '-'}] "
                f"{'ok' if ok else 'FAIL'}")
            rec.update(
                ms=ms, plain_ms=plain_ms, timing=timing,
                plain_timing=plain_timing, bound_us=bound_s * 1e6,
                bound_by=bound_by, roofline_share=bound_s * 1e3 / ms,
                library_us=None if lib_ms is None else lib_ms * 1e3,
                library_call=lib_call, library_timing=lib_timing,
                library_samples_us=[t * 1e3 for t in lib_runs])
        records.append(rec)
        if not ok:
            failed.append(f"{name} {label} ({err:.3e})")
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(failed))
    return records


def flash_grad_path(dev, native: bool = False) -> dict:
    """K8's caller: ``flash_attention(...).backward()`` at the joint shape,
    bf16, dropout 0.1 drawn from a CPU generator. Launch counts are reset
    before and read after; K4 and K8 must launch once each, and the
    gradients must equal ``flash_attention_bwd_plain`` with the same seed
    (the seed is the generator's next draw). With ``native``, in the
    input-dtype softmax: K4n and K8n must launch once each, K4, K8 and the
    stats-only K4n not (K8n takes the forward's statistics), and the
    gradients must also pass the discriminating gate; then a standalone
    ``flash_attention_bwd`` call must launch the stats-only K4n and K8n
    once each and give the same gradients, and a forward under
    ``torch.no_grad()`` must allocate its output alone (no statistics)."""
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
        softmax_in_input_dtype=native, **kw).backward(go)
    torch.cuda.synchronize()
    launched = counts()
    want = attention.flash_attention_bwd_plain(
        q, k, v, go, seed=seed, softmax_in_input_dtype=native, **kw)
    suffix = "_native" if native else ""
    tol, floor = limit("flash_attention_bwd" + suffix, "bfloat16")
    err = max(rel_err(t.grad, w, floor)[1] for t, w in zip(leaves, want))
    gate = ""
    passed = True
    if native:
        off = attention.flash_attention_bwd_plain(q, k, v, go, seed=seed,
                                                  **kw)
        gates = [native_gate(t.grad, w, o)
                 for t, w, o in zip(leaves, want, off)]
        passed = all(gt[0] for gt in gates)
        gate = ", gate " + "/".join(f"{gt[1]:.2e}<{gt[2] / 2:.2e}"
                                    for gt in gates)
    label = "flash_attention autograd" + (" (input-dtype softmax)"
                                          if native else "")
    log(f"  {label}, dropout 0.1: launches {launched}, grads vs plain "
        f"{err:.3e} of max|plain| (tol {tol:g}){gate}")
    want_launches = {"flash_attention" + suffix: 1,
                     "flash_attention_bwd" + suffix: 1}
    if native:
        want_launches.update(flash_attention=0, flash_attention_bwd=0,
                             flash_attention_stats_native=0)
    check_launches(label, launched, want_launches)
    if not (err <= tol and passed):
        raise AssertionError(f"{label}: gradients disagree with "
                             f"flash_attention_bwd_plain")
    if native:
        torch.cuda.synchronize()
        reset_counts()
        alone = attention.flash_attention_bwd(
            q, k, v, go, seed=seed, softmax_in_input_dtype=True, **kw)
        torch.cuda.synchronize()
        standalone = counts()
        err_alone = max(rel_err(a, w, floor)[1] for a, w in zip(alone, want))
        # the statistics buffers a forward allocates, without and with
        # grad
        made, allocs, real = [], [], attention._stats_buffer
        attention._stats_buffer = lambda t: made.append(1) or real(t)
        try:
            for grad in (False, True):
                with torch.set_grad_enabled(grad):
                    attention.flash_attention(
                        *leaves, seed=seed, softmax_in_input_dtype=True, **kw)
                allocs.append(len(made) - sum(allocs))
        finally:
            attention._stats_buffer = real
        log(f"  flash_attention_bwd standalone (input-dtype softmax): "
            f"launches {standalone}, grads vs plain {err_alone:.3e} of "
            f"max|plain|; statistics buffers of a forward without / with "
            f"grad: {allocs[0]} / {allocs[1]}")
        check_launches("standalone flash_attention_bwd", standalone, {
            "flash_attention_stats_native": 1,
            "flash_attention_bwd_native": 1, "flash_attention_native": 0})
        if err_alone > tol or allocs != [0, 1]:
            raise AssertionError("standalone flash_attention_bwd, or the "
                                 "forward's statistics buffers")
        launched["flash_attention_stats_native"] = standalone[
            "flash_attention_stats_native"]
    return launched


def native_f32_check(dev) -> dict:
    """The input-dtype softmax is a no-op for float32, as JAX demotes it:
    at the joint shape with dropout 0.1, ``flash_attention`` with the mode
    on gives the mode-off call's output and gradients bit for bit, and
    launches K4 and K8, not K4n and K8n."""
    import torch
    from rtvc_tpu_torch.ops import attention
    g = torch.Generator().manual_seed(SEED + 7)
    b, h, lq, d = WINDOWS, 12, FRAMES * 257 + CAPTION_LEN, 64
    q, k, v, go = (torch.randn(b, h, lq, d, generator=g).to(dev)
                   for _ in range(4))
    kw = dict(causal=True, prefix_len=FRAMES * 257, dropout_rate=0.1,
              seed=DROPOUT_SEED)
    runs = []
    for native in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        reset_counts()
        out = attention.flash_attention(*leaves, softmax_in_input_dtype=native,
                                        **kw)
        out.backward(go)
        torch.cuda.synchronize()
        runs.append(([out.detach()] + [t.grad for t in leaves], counts()))
    same = all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    log(f"  float32 with the input-dtype softmax on: output and gradients "
        f"{'bitwise equal to' if same else 'DIFFER from'} the mode off; "
        f"launches {runs[1][1]}")
    check_launches("float32 with the mode on", runs[1][1], {
        "flash_attention": 1, "flash_attention_bwd": 1,
        "flash_attention_native": 0, "flash_attention_bwd_native": 0})
    if not same:
        raise AssertionError("float32 flash_attention with the input-dtype "
                             "softmax differs from the mode off")
    return {"native_f32_bitwise_equal": same}


def add_ln_grad_check(dev) -> dict:
    """K6 under autograd at the CLIP tower's [12336, 1024], bf16: (dx,
    ddelta, dweight, dbias) of ``fused_add_layer_norm`` (the kernel
    forward, launched once, and the closed-form backward) against
    ``fused_add_layer_norm_bwd_plain`` of the plain forward's rounded sum,
    at K6's bf16 limit."""
    import torch
    from rtvc_tpu_torch.ops import layernorm
    g = torch.Generator().manual_seed(SEED + 8)
    rows, width = WINDOWS * FRAMES * 257, 1024

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(
            dev, torch.bfloat16)
    x, delta, gy, gh = (rand(rows, width, scale=2.0) for _ in range(4))
    w, b = rand(width), rand(width)
    leaves = [t.clone().requires_grad_() for t in (x, delta, w, b)]
    torch.cuda.synchronize()
    reset_counts()
    y, hn = layernorm.fused_add_layer_norm(*leaves)
    torch.autograd.backward((y, hn), (gy, gh))
    torch.cuda.synchronize()
    launched = counts()
    y_plain, _ = layernorm.fused_add_layer_norm_plain(x, delta, w, b)
    want = layernorm.fused_add_layer_norm_bwd_plain(y_plain, w, gy, gh)
    tol, floor = limit("fused_add_layer_norm", "bfloat16")
    errs = [rel_err(t.grad, wt, floor) for t, wt in zip(leaves, want)]
    log(f"  fused_add_layer_norm autograd [{rows},{width}] bf16: launches "
        f"{launched['fused_add_layer_norm']}, (dx, ddelta, dweight, dbias) "
        f"vs plain " + ", ".join(f"{r:.3e}" for _, r in errs)
        + f" of max(1, max|plain|) (tol {tol:g})")
    check_launches("fused_add_layer_norm autograd", launched,
                   {"fused_add_layer_norm": 1})
    if not all(r <= tol for _, r in errs):
        raise AssertionError("K6's gradients disagree with "
                             "fused_add_layer_norm_bwd_plain")
    return {"add_ln_grad_rel_err": [r for _, r in errs],
            "add_ln_grad_max_abs_err": [e for e, _ in errs]}


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


def check_rows(rows, vocab: int, cls_id: int,
               width: int = 1 + MAX_LEN) -> None:
    """int32 rows ``[B, width]`` (greedy: 1 + MAX_LEN; beam: MAX_LEN),
    CLS first, every id in the vocabulary."""
    import torch
    if rows.dtype != torch.int32 or rows.shape[1] != width:
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


def wrapper_paths() -> dict:
    """Each kernel's wrapper as ``module:function``, for the dry-run
    worker to count in its ranks (a job's ``kernels``)."""
    return {k: f"{fn.__module__}:{fn.__name__}"
            for k, fn in wrappers().items()}


def counters() -> dict:
    """Each kernel's (wrapper, its count's attribute), by the kernel's name
    in KERNELS: K4n and K8n count on K4's and K8's wrappers, the stats-only
    K4n on ``flash_attention_stats``."""
    out = {name: (fn, "launches") for name, fn in wrappers().items()}
    out["flash_attention_native"] = (out["flash_attention"][0],
                                     "native_launches")
    out["flash_attention_bwd_native"] = (out["flash_attention_bwd"][0],
                                         "native_launches")
    from rtvc_tpu_torch.ops import attention
    out["flash_attention_stats_native"] = (attention.flash_attention_stats,
                                           "launches")
    return out


def counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def serve(student, windows, vocab_int8: bool, beam: int = 0):
    """The main path: 8 windows one by one, then as one batch of 8, greedy
    or with ``beam`` beams. Returns (rows at batch 1, rows at batch 8, ms
    per window at batch 1, ms per window at batch 8, launch counts of this
    run)."""
    from rtvc_tpu_torch.serving import make_caption_step
    return run_step(make_caption_step(student, max_len=MAX_LEN, beam=beam,
                                      vocab_int8=vocab_int8), windows)


def run_step(step, windows):
    """:func:`serve` for any ``step(frames_u8) -> rows`` on the card: a
    warm-up pass, then the 8 windows one by one and as one batch of 8, each
    call between CUDA events, the launch counts reset before and read
    after."""
    import torch
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


def slice_inputs(dev) -> tuple:
    """(the full-width float32 student on the CPU, random weights from
    SEED; its bfloat16 copy on the card with the int8 vocab pack; the 8
    windows on the CPU), shared by the slice and serve phases."""
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.models.student import random_init_, student_from_config
    from rtvc_tpu_torch.serving import with_vocab_w8

    g = torch.Generator().manual_seed(SEED)
    student_f32 = random_init_(student_from_config(cfg, device="cpu"),
                               g).eval()
    windows_cpu = make_windows(g)
    student = copy.deepcopy(student_f32).to(dev, cfg.dtype)
    with_vocab_w8(student)
    return student_f32, student, windows_cpu


def slice_phase(dev, student_f32, student, windows_cpu) -> dict:
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.serving import truncate_at_sep

    windows = windows_cpu.to(dev)
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
# phase 5: the serving surface
# ---------------------------------------------------------------------------

def f32_beam_report(student_f32, windows_cpu, dev) -> float:
    """The f32 beam step on the card (kernels, TF32 off) against the same
    step on the CPU (plain versions): the share of rows whose first word
    differs. Reported, not gated: random weights give near-flat logits."""
    import torch
    from rtvc_tpu_torch.serving import make_caption_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = copy.deepcopy(student_f32).to(dev)
    rows_cpu = make_caption_step(student_f32, max_len=MAX_LEN,
                                 beam=SERVE_BEAM)(windows_cpu)
    rows_card = make_caption_step(card, max_len=MAX_LEN, beam=SERVE_BEAM)(
        windows_cpu.to(dev)).cpu()
    del card
    return first_token_divergence(rows_card, rows_cpu)


def http_client():
    """A urllib opener that never reads a proxy from the environment: the
    requests go to the loopback front and nowhere else."""
    import urllib.request
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http_burst(base: str, windows) -> list:
    """The windows posted at once, one client thread each: even ones as raw
    ``application/octet-stream`` with ``X-Frames-Shape``, odd ones as JSON
    ``frames_b64``. Returns (status, caption or error, seconds) per
    window, the seconds from sending to the whole answer."""
    import base64
    import threading
    import urllib.error
    import urllib.request
    opener = http_client()
    reqs = []
    for i, w in enumerate(windows):
        if i % 2 == 0:
            reqs.append(urllib.request.Request(
                base + "/v1/caption", data=w.tobytes(), method="POST",
                headers={"Content-Type": "application/octet-stream",
                         "X-Frames-Shape": ",".join(map(str, w.shape))}))
        else:
            reqs.append(urllib.request.Request(
                base + "/v1/caption", method="POST",
                headers={"Content-Type": "application/json"},
                data=json.dumps({
                    "frames_b64": base64.b64encode(w.tobytes()).decode(),
                    "shape": list(w.shape)}).encode()))
    out = [None] * len(reqs)

    def post(i):
        t0 = time.perf_counter()
        try:
            with opener.open(reqs[i], timeout=300) as r:
                code, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        out[i] = (code, body.get("caption", body.get("error")),
                  time.perf_counter() - t0)

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def decodable(row, tok) -> int:
    """How many of a row's generated ids the synthetic vocabulary holds as
    a word or piece (not a special id, an ``[unused_*]`` filler or an id
    past its 2048 entries, which decodes to ``[UNK]``)."""
    return sum(1 for t in row[1:]
               if t not in tok._special_ids
               and not tok.inv_vocab.get(int(t), "[UNK]").startswith(
                   ("[unused_", "[UNK]")))


def server_run(student, windows_cpu, dev, beam: int) -> dict:
    """``BatchCaptionServer`` (max_batch 8, one bucket of 8, the synthetic
    tokenizer) behind ``CaptionHTTPFrontend`` on 127.0.0.1, port 0. Gates:
    the 8 windows submitted at once from 8 streams form one batch whose
    rows equal the direct step's on the same batch, truncated at SEP, bit
    for bit; then HTTP_ROUNDS bursts of the 8 windows over HTTP (4 raw, 4
    JSON) all answer 200 with the in-process caption; /healthz and
    /v1/stats answer. Every pad row is a zero window, and a row's result
    does not depend on the rest of its batch at a fixed shape, so any
    batch the bursts form must give the in-process texts."""
    import numpy as np
    from rtvc_tpu_torch.serving import (BatchCaptionServer, make_caption_step,
                                        truncate_at_sep)
    from rtvc_tpu_torch.serving_http import CaptionHTTPFrontend
    from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

    tok = BertWordPieceTokenizer()
    wins = windows_cpu.numpy()
    direct = make_caption_step(student, max_len=MAX_LEN, beam=beam)(
        windows_cpu.to(dev)).cpu().numpy()
    t0 = time.perf_counter()
    server = BatchCaptionServer(
        student, tok, max_batch=WINDOWS, buckets=(WINDOWS,),
        max_wait_ms=SERVER_WAIT_MS, max_len=MAX_LEN, beam=beam,
        frame_shape=FRAME_HW + (3,), window=FRAMES)
    warm_s = time.perf_counter() - t0
    try:
        futs = [server.submit(w, stream_id=f"cam{i}")
                for i, w in enumerate(wins)]
        rows = [f.tokens(timeout=300) for f in futs]
        texts = [f.result(timeout=300) for f in futs]
        sizes = list(server.batch_sizes)
        if sizes != [WINDOWS]:
            raise AssertionError(f"8 submits at once formed batches {sizes}")
        bad = [i for i, (r, d) in enumerate(zip(rows, direct))
               if not np.array_equal(r, truncate_at_sep(d))]
        if bad:
            raise AssertionError(f"served rows {bad} differ from the direct "
                                 f"step's")
        with CaptionHTTPFrontend(server, host="127.0.0.1", port=0) as fe:
            base = f"http://127.0.0.1:{fe.port}"
            with http_client().open(base + "/healthz", timeout=60) as r:
                health = (r.status, json.loads(r.read()))
            answers, walls = [], []
            for _ in range(HTTP_ROUNDS):
                t0 = time.perf_counter()
                answers.append(http_burst(base, wins))
                walls.append(time.perf_counter() - t0)
            with http_client().open(base + "/v1/stats", timeout=60) as r:
                http_stats = (r.status, json.loads(r.read()))
        stats = server.stats()
    finally:
        server.close()
    if health != (200, {"ok": True}) or http_stats[0] != 200:
        raise AssertionError(f"/healthz {health}, /v1/stats {http_stats}")
    wrong = [(n, i, a[:2]) for n, burst in enumerate(answers)
             for i, a in enumerate(burst) if a[:2] != (200, texts[i])]
    if wrong:
        raise AssertionError(f"HTTP answers (round, window, (status, "
                             f"caption)) differ from in-process: {wrong}")
    lat = sorted(a[2] for burst in answers for a in burst)
    by_format = {fmt: sorted(a[2] * 1e3 for burst in answers
                             for i, a in enumerate(burst) if i % 2 == odd)
                 for fmt, odd in (("raw", 0), ("json", 1))}
    result = dict(
        warmup_s=warm_s, batch_sizes=list(server.batch_sizes),
        stats=stats, http_requests=len(lat),
        http_latency_p50_ms=lat[len(lat) // 2] * 1e3,
        http_latency_p95_ms=lat[int(len(lat) * 0.95)] * 1e3,
        http_latency_ms_by_format=by_format,
        http_windows_per_s=len(lat) / sum(walls), http_round_s=walls,
        captions=texts,
        decodable_ids=[decodable(r, tok) for r in rows],
        generated_ids=[len(r) - 1 for r in rows])
    mode = f"beam={beam}" if beam else "greedy"
    log(f"  server {mode:7s} warm-up {warm_s:.2f} s; in-process batch of 8 "
        f"rows equal the direct step's; {len(lat)} HTTP requests "
        f"({HTTP_ROUNDS} bursts of 8, half raw, half JSON) all 200 with the "
        f"in-process captions; batches {result['batch_sizes']}")
    log(f"  server {mode:7s} stats() {json.dumps(stats)}")
    log(f"  server {mode:7s} HTTP latency p50 {result['http_latency_p50_ms']:.1f}"
        f" ms p95 {result['http_latency_p95_ms']:.1f} ms, "
        f"{result['http_windows_per_s']:.2f} windows/s over the bursts; "
        f"median raw {by_format['raw'][len(by_format['raw']) // 2]:.1f} ms,"
        f" JSON {by_format['json'][len(by_format['json']) // 2]:.1f} ms")
    log(f"  server {mode:7s} synthetic-vocab words per row (of "
        f"{result['generated_ids']} generated ids; random weights pick ids "
        f"across all 30522, the 2048-entry vocabulary holds few: the rest "
        f"print as [UNK] or [unused_*]): {result['decodable_ids']}")
    for i in range(3):
        log(f"  server {mode:7s} window {i} caption {texts[i][:120]!r}")
    return result


def serve_phase(dev, student_f32, student, windows_cpu) -> dict:
    """The beam step (k = SERVE_BEAM), default and ``vocab_int8``, at batch 1
    and 8 with its launch counts, the f32 beam's card-vs-CPU report, then
    the server in greedy and beam mode behind its HTTP front."""
    import torch
    from rtvc_tpu_torch.config import cfg

    windows = windows_cpu.to(dev)
    vocab, cls_id = cfg.student.vocab_size, cfg.student.cls_token_id
    steps = MAX_LEN - 1      # decode_step calls of one beam step
    calls = WINDOWS + 1      # 8 at batch 1, one at batch 8
    result = {"beam": SERVE_BEAM, "launches": {}}
    for mode, vocab_int8 in (("default", False), ("vocab_int8", True)):
        rows1, rows8, ms1, ms8, launched = serve(student, windows, vocab_int8,
                                                 beam=SERVE_BEAM)
        for rows in (rows1, rows8):
            check_rows(rows, vocab, cls_id, width=MAX_LEN)
        same = float((rows1 == rows8).all(dim=1).float().mean())
        log(f"  beam {SERVE_BEAM} {mode:10s} launches {launched}")
        log(f"  beam {SERVE_BEAM} {mode:10s} ms/window batch 1 {ms1:.3f}  "
            f"batch 8 {ms8:.3f}  batch-1 rows equal to batch-8 rows: "
            f"{same:.3f}")
        for i, row in enumerate(rows1.tolist()[:2]):
            log(f"  beam {SERVE_BEAM} {mode:10s} window {i} tokens {row}")
        need = ["window_attention", "layer_norm"] + (
            ["w8_matmul"] if vocab_int8 else [])
        missing = [k for k in need if launched[k] == 0]
        if missing:
            raise AssertionError(f"{mode} beam step never launched {missing}")
        # the decoder's three norms a layer at each of the fixed steps
        dec_norms = 3 * cfg.student.num_decoder_layers * steps * calls
        if launched["layer_norm"] < dec_norms:
            raise AssertionError(f"{mode} beam step: {launched['layer_norm']}"
                                 f" K2 launches, fewer than the decoder's "
                                 f"{dec_norms}")
        if vocab_int8 and launched["w8_matmul"] != steps * calls:
            raise AssertionError(f"vocab_int8 beam step: "
                                 f"{launched['w8_matmul']} K3 launches, not "
                                 f"one a step ({steps * calls})")
        for k, n in launched.items():
            result["launches"][k] = result["launches"].get(k, 0) + n
        result[f"beam_{mode}"] = dict(
            ms_per_window_b1=ms1, ms_per_window_b8=ms8, b1_equals_b8=same,
            rows_b1=rows1.tolist())
    result["f32_beam_first_token_divergence"] = f32_beam_report(
        student_f32, windows_cpu, dev)
    log(f"  beam {SERVE_BEAM} first-token divergence, f32 card vs f32 cpu: "
        f"{result['f32_beam_first_token_divergence']:.3f} (reported, not "
        f"gated)")
    result["server"] = {
        "greedy": server_run(student, windows_cpu, dev, 0),
        f"beam{SERVE_BEAM}": server_run(student, windows_cpu, dev,
                                        SERVE_BEAM)}
    return result


# ---------------------------------------------------------------------------
# phase 5b: the exported and compiled caption programs
# ---------------------------------------------------------------------------

def caption_launches(student, decode_calls: int) -> dict:
    """K1 and K2 launches of one caption-step call, from the layer counts:
    K1 a TinyViT attention block, K2 its two norms, and the decoder's three
    norms a layer at each of ``decode_calls`` decode steps; no other
    kernel."""
    blocks = sum(student.image_encoder["model"].config.depths[1:])
    want = dict(KERNEL_ZERO)
    want.update(window_attention=blocks,
                layer_norm=2 * blocks
                + 3 * len(student.decoder["layers"]) * decode_calls)
    return want


def trace_kernels(logdir: str) -> dict:
    """Device kernel events of the Chrome trace ``profile_trace`` wrote
    into ``logdir``: their number, their summed µs, the µs from the first
    kernel's start to the last one's end, and the events of K1's and K2's
    symbols."""
    import glob
    import re
    (path,) = glob.glob(f"{logdir}/*.json")
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in kernels]
    span = (max(e["ts"] + e["dur"] for e in kernels)
            - min(e["ts"] for e in kernels)) if kernels else 0.0
    return {"kernel_events": len(names),
            "kernel_us": sum(e["dur"] for e in kernels), "span_us": span,
            **{name: sum(bool(re.search(r"\b" + sym + r"\b", n))
                         for n in names)
               for name, sym in TRACE_SYMBOLS.items()}}


def dispatch_host_us(dev) -> dict:
    """Host µs a call of K1 (stage 1, b1: [64, 6, 49, 32] bf16) and K2
    ([8, 576] bf16), each through its ``rtvc::`` operator and through the
    direct launch, 1000 calls after warm-up (``time.perf_counter``, no
    graph, one synchronise at the end)."""
    import torch
    from rtvc_tpu_torch.ops import attention, layernorm
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k, v = (torch.randn(64, 6, 49, 32, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.randn(6, 49, 49, generator=g, device=dev)
    x = torch.randn(8, 576, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(576, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(576, generator=g, device=dev).to(torch.bfloat16)
    scale = 32 ** -0.5
    calls = {
        "K1 op": lambda: torch.ops.rtvc.window_attention(q, k, v, bias,
                                                         scale, False),
        "K1 direct": lambda: attention._window_kernel(q, k, v, bias, scale,
                                                      False),
        "K2 op": lambda: torch.ops.rtvc.layer_norm(x, w, b, 1e-5),
        "K2 direct": lambda: layernorm._layer_norm_kernel(x, w, b, 1e-5)}
    out = {}
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            for name, fn in calls.items():
                for _ in range(100):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    fn()
                torch.cuda.synchronize()
                out[name] = (time.perf_counter() - t0) / 1000 * 1e6
    log("  host µs a call, operator vs direct launch: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def dispatch_decision(dispatch: dict, sl: dict, student) -> dict:
    """What the operators' dispatch adds to the b1 greedy caption step:
    (operator − direct) µs of K1 and K2 times their launches in one b1 step
    (10 K1; 20 + 6 a decode step K2, at the slice phase's mean decode
    steps), as a share of the slice phase's b1 ms per window. Over 5%
    would send eager calls to the direct launch."""
    import torch
    per = caption_launches(student, 1)
    steps = [decode_steps(torch.tensor([r]), student.sep_token_id)
             for r in sl["default"]["rows_b1"]]
    k2 = per["layer_norm"] - 3 * len(student.decoder["layers"])
    k2 += 3 * len(student.decoder["layers"]) * sum(steps) / len(steps)
    extra_ms = ((dispatch["K1 op"] - dispatch["K1 direct"])
                * per["window_attention"]
                + (dispatch["K2 op"] - dispatch["K2 direct"]) * k2) / 1e3
    share = extra_ms / sl["default"]["ms_per_window_b1"]
    log(f"  operator dispatch adds {extra_ms:.3f} ms to a b1 greedy step "
        f"of {sl['default']['ms_per_window_b1']:.3f} ms ({100 * share:.2f}%"
        f", limit 5%)")
    return {"dispatch_extra_ms_b1": extra_ms, "dispatch_share_b1": share}


def export_phase(dev, student, windows_cpu) -> dict:
    """``export.save_bundle`` of the serve phase's bf16 student (buckets 1
    and 8 greedy, 1 and 8 at beam SERVE_BEAM; 480×640 6-frame windows,
    MAX_LEN 25), loaded back with ``load_bundle``. Gates: every exported
    program's rows equal the live ``make_caption_step``'s bit for bit at
    b1 × 8, b8 and beam b1 × 8, b8 (greedy rows as the host-stop step
    leaves them: 0 after its stop); each call launches K1 and K2 exactly
    the layer counts (greedy: all MAX_LEN decode steps; beam: MAX_LEN - 1)
    and nothing else; a ``profile_trace`` of one exported b8 call names
    K1's and K2's kernels. Then ``save_compiled`` at b8 greedy on a
    ``lively_`` copy, COMPILED_MAX_LEN tokens: its rows equal that copy's
    live step's, its launches the layer counts. Times (CUDA events)
    beside the live step's."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rtvc_export_") as tmp:
        result = export_runs(dev, student, windows_cpu.to(dev), tmp)
    result["seconds"] = time.perf_counter() - t0
    return result


def export_runs(dev, student, windows, tmp: str) -> dict:
    """:func:`export_phase`'s runs, their artifacts in ``tmp``."""
    import os
    import torch
    from rtvc_tpu_torch import export
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.serving import make_caption_step
    from rtvc_tpu_torch.utils.profiling import profile_trace

    sep = cfg.student.sep_token_id
    frame_shape = FRAME_HW + (3,)
    variables = export.serving_variables(student)
    params_bytes = sum(t.numel() * t.element_size()
                       for t in variables.values())
    want = {0: caption_launches(student, MAX_LEN),
            SERVE_BEAM: caption_launches(student, MAX_LEN - 1)}
    result = {"params_bytes": params_bytes, "programs": {},
              "launches": dict(KERNEL_ZERO)}

    def read_counts() -> dict:
        launched = counts()
        for k, n in launched.items():
            result["launches"][k] += n
        return launched

    export_s = []
    inner = export.export_caption_program

    def timed_export(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        export_s.append(time.perf_counter() - t0)
        return out

    export.export_caption_program = timed_export
    try:
        bundles = {}
        for beam in (0, SERVE_BEAM):
            out = os.path.join(tmp, f"beam{beam}")
            manifest = export.save_bundle(
                out, student, variables, buckets=(1, WINDOWS),
                window=FRAMES, frame_shape=frame_shape, max_len=MAX_LEN,
                beam=beam, device=dev)
            for b, seconds in zip(manifest["buckets"], export_s[-2:]):
                name = manifest["programs"][str(b)]
                size = os.path.getsize(os.path.join(out, name))
                key = f"beam{beam}_b{b}"
                result["programs"][key] = dict(export_s=seconds, bytes=size)
                log(f"  export {key}: {seconds:.2f} s, {name} {size} bytes "
                    f"(params {params_bytes} bytes, {size / params_bytes:.4f}"
                    f" of them)")
                if size >= params_bytes / 10:
                    raise AssertionError(f"{key}: the program file holds "
                                         f"more than a tenth of the params' "
                                         f"bytes")
            t0 = time.perf_counter()
            bundles[beam] = export.load_bundle(out)
            result[f"beam{beam}_load_s"] = time.perf_counter() - t0
    finally:
        export.export_caption_program = inner

    for beam, cap in bundles.items():
        live = make_caption_step(student, max_len=MAX_LEN, beam=beam)
        for label, frames in ([(f"b1 window {i}", windows[i:i + 1])
                               for i in range(WINDOWS)]
                              + [("b8", windows)]):
            reset_counts()
            got = cap(frames)
            torch.cuda.synchronize()
            launched = read_counts()
            ref = live(frames)
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"exported beam={beam} {label}: rows differ from the live"
                    f" step's at {int((got != ref).sum())} ids")
            check_launches(f"exported beam={beam} {label}", launched,
                           want[beam])
        _, _, ms1_x, ms8_x, launched_x = run_step(cap, windows)
        for k, n in launched_x.items():
            result["launches"][k] += n
        rows1_l, rows8_l, ms1_l, ms8_l, _ = run_step(live, windows)
        check_launches(f"exported beam={beam} timed run", launched_x,
                       {k: n * (WINDOWS + 1) for k, n in want[beam].items()})
        mode = f"beam{beam}" if beam else "greedy"
        entry = dict(exported_ms_per_window_b1=ms1_x,
                     exported_ms_per_window_b8=ms8_x,
                     live_ms_per_window_b1=ms1_l,
                     live_ms_per_window_b8=ms8_l,
                     launches_per_call=want[beam])
        if not beam:
            entry.update(
                live_decode_steps_b1=[decode_steps(rows1_l[i:i + 1], sep)
                                      for i in range(WINDOWS)],
                live_decode_steps_b8=decode_steps(rows8_l, sep),
                exported_decode_steps=MAX_LEN)
        result[mode] = entry
        log(f"  {mode:6s} rows equal the live step's (b1 x 8, b8); launches"
            f" a call {want[beam]['window_attention']} K1, "
            f"{want[beam]['layer_norm']} K2")
        log(f"  {mode:6s} ms/window exported b1 {ms1_x:.3f} b8 {ms8_x:.3f};"
            f" live b1 {ms1_l:.3f} b8 {ms8_l:.3f}"
            + ("" if beam else f" (live decode steps b1 "
               f"{entry['live_decode_steps_b1']}, b8 "
               f"{entry['live_decode_steps_b8']}; exported {MAX_LEN})"))

    result["trace"] = {}
    live = make_caption_step(student, max_len=MAX_LEN)
    for label, step in (("exported", bundles[0]), ("live", live)):
        logdir = os.path.join(tmp, f"trace_{label}")
        step(windows)  # warm
        torch.cuda.synchronize()
        with profile_trace(logdir):
            step(windows)
            torch.cuda.synchronize()
        result["trace"][label] = trace_kernels(logdir)
        log(f"  profile_trace of one {label} greedy b8 call: "
            f"{json.dumps(result['trace'][label])}")
    seen = result["trace"]["exported"]
    missing = [k for k in TRACE_SYMBOLS if not seen[k]]
    if missing:
        raise AssertionError(f"the trace names no kernel of {missing}")

    lively = copy.deepcopy(student)
    lively_(lively)
    path = os.path.join(tmp, f"compiled_b{WINDOWS}.pt2")
    t0 = time.perf_counter()
    # the package's C++ wrapper at -O0: ~167 s of save_compiled instead of
    # ~307 s at Inductor's default -O1 (25 tokens), at ~5.0 instead of
    # ~3.3 ms a window (PERF.md §6); it keeps the whole script near half
    # its time limit
    with torch._inductor.config.patch(
            {"aot_inductor.compile_wrapper_opt_level": "O0"}):
        export.save_compiled(path, lively, export.serving_variables(lively),
                             batch=WINDOWS, window=FRAMES,
                             frame_shape=frame_shape,
                             max_len=COMPILED_MAX_LEN, device=dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, meta = export.load_compiled(path)
    load_s = time.perf_counter() - t0
    lively_vars = export.serving_variables(lively)
    with torch.inference_mode():
        reset_counts()
        got = fn(lively_vars, windows)
        torch.cuda.synchronize()
        launched = read_counts()
    ref = make_caption_step(lively, max_len=COMPILED_MAX_LEN)(windows)
    if not torch.equal(got, ref):
        raise AssertionError(f"compiled b8: rows differ from the lively "
                             f"student's live step at "
                             f"{int((got != ref).sum())} ids")
    want_c = caption_launches(student, COMPILED_MAX_LEN)
    check_launches("compiled b8", launched, want_c)
    with torch.inference_mode():
        ms_c = cuda_ms(lambda: fn(lively_vars, windows), reps=5,
                       warmup=2) / WINDOWS
    ms_l = cuda_ms(lambda: make_caption_step(
        lively, max_len=COMPILED_MAX_LEN)(windows), reps=5,
        warmup=2) / WINDOWS
    result["compiled"] = dict(
        max_len=COMPILED_MAX_LEN,
        compile_s=compile_s, load_s=load_s, bytes=os.path.getsize(path),
        ms_per_window_b8=ms_c, lively_live_ms_per_window_b8=ms_l,
        live_decode_steps_b8=decode_steps(ref, sep),
        distinct_rows=len({tuple(r) for r in ref.tolist()}))
    log(f"  compiled b8 (lively_, {COMPILED_MAX_LEN} tokens): "
        f"save_compiled {compile_s:.1f} s, load "
        f"{load_s:.2f} s, {result['compiled']['bytes']} bytes; rows equal "
        f"the live step's ({result['compiled']['distinct_rows']} distinct); "
        f"launches {want_c['window_attention']} K1, "
        f"{want_c['layer_norm']} K2; ms/window {ms_c:.3f} against live "
        f"{ms_l:.3f}")
    del lively
    return result


# ---------------------------------------------------------------------------
# phase 6: the evaluation path
# ---------------------------------------------------------------------------

def write_eval_tree(root: str, splits=(("test", EVAL_CLIPS),)) -> None:
    """An MSRVTT-format tree under ``root``, in the config's relative
    layout, from numpy, csv, json and pickle only: for each (split, count)
    of ``splits`` that many clips of EVAL_CLIP_FRAMES uint8 BGR frames at
    MSRVTT's 320×240 (smooth random scenes plus pixel noise, each clip at
    its own brightness), and EVAL_CAPTIONS captions a clip of 6-12 words
    drawn from the synthetic vocabulary's whole words, encoded by the
    port's tokenizer (``encoded_captions.pkl``) and written raw to
    ``MSR_VTT.json``."""
    import csv
    import os
    import pickle
    import numpy as np
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.tokenization import (BertWordPieceTokenizer,
                                             encode_caption)
    rng = np.random.default_rng(SEED + 9)
    tok = BertWordPieceTokenizer()
    words = sorted(t for t in tok.vocab if t.isalpha() and t.islower())
    data = cfg.data
    for path in (data.videos_path, os.path.dirname(data.captions_path),
                 os.path.dirname(data.annotation_path)):
        os.makedirs(os.path.join(root, path), exist_ok=True)
    h, w = EVAL_HW
    rows, encoded, cap_id = [], {}, 0
    # brightness levels in a seeded order, so that neighbouring clips (and
    # batches) differ in what they show
    split_of = [name for name, n in splits for _ in range(n)]
    clips = len(split_of)
    levels = 0.3 + 0.7 * rng.permutation(clips) / (clips - 1)
    for i in range(clips):
        vid = f"video{7000 + i}"
        coarse = rng.random((EVAL_CLIP_FRAMES, h // 40, w // 40, 3))
        scene = coarse.repeat(40, axis=1).repeat(40, axis=2)
        noise = rng.random((EVAL_CLIP_FRAMES, h, w, 3))
        clip = ((0.8 * scene + 0.2 * noise) * levels[i] * 255).astype(
            np.uint8)
        np.save(os.path.join(root, data.videos_path, vid + ".npy"), clip)
        for _ in range(EVAL_CAPTIONS):
            caption = " ".join(rng.choice(words,
                                          size=int(rng.integers(6, 13))))
            rows.append({"image_id": vid, "id": cap_id, "caption": caption,
                         "split": split_of[i]})
            encoded[cap_id] = encode_caption(caption, tok)
            cap_id += 1
    with open(os.path.join(root, data.captions_path), "w", newline="") as f:
        out = csv.DictWriter(f, fieldnames=["image_id", "id", "caption",
                                            "split"])
        out.writeheader()
        out.writerows(rows)
    with open(os.path.join(root, data.encoded_caption_ids), "wb") as f:
        pickle.dump(encoded, f)
    with open(os.path.join(root, data.annotation_path), "w") as f:
        json.dump({"annotations": [
            {"image_id": r["image_id"], "caption": r["caption"],
             "id": r["id"]} for r in rows]}, f)


def lively_(student) -> None:
    """Scale, in place, the vocab projection and each decoder layer's
    cross-attention output projection by 10, as the CPU parity tests do
    (tests/test_torch_evaluate.py ``lively``). At the random init's scales
    every clip decodes to the same row, which would leave a loader fault
    in the frames, their order, the preprocess or the dtype unseen; with
    these the rows depend on the clip."""
    import torch
    with torch.no_grad():
        student.linear.weight.mul_(EVAL_LIVELY)
        student.linear.bias.mul_(EVAL_LIVELY)
        for layer in student.decoder["layers"]:
            layer.multihead_attn.out_proj.weight.mul_(EVAL_LIVELY)


def check_scores(label: str, scores: dict) -> None:
    if set(scores) != EVAL_KEYS:
        raise AssertionError(f"{label}: score keys {sorted(scores)}")
    bad = {k: v for k, v in scores.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{label}: non-finite scores {bad}")


def eval_launches(label: str, launched: dict, forwards: int,
                  decode_calls: int) -> None:
    """K1 10 a TinyViT forward, K2 20 a forward and 6 a decode step (the
    decoder's 3 norms a layer), no other kernel."""
    want = {name: 0 for name in launched}
    want.update(window_attention=10 * forwards,
                layer_norm=20 * forwards + 6 * decode_calls)
    check_launches(label, launched, want)


def eval_rows_gate(student, loader, tok, preds, dev) -> tuple:
    """The eval's own decode (``train.make_eval_step``) on each loader
    batch against ``make_caption_step``'s on the same clips' uint8 frames,
    as ``load_clip_frames`` picks them, in the same batches: equal bit for
    bit. The preds file must name each test clip once and hold the
    tokenizer's decode of those rows. Returns (the rows per batch, each
    batch's ms, the decode_step calls per batch, the first batch's
    frames)."""
    import numpy as np
    import torch
    from rtvc_tpu_torch.data.dataset import load_clip_frames
    from rtvc_tpu_torch.serving import make_caption_step
    from rtvc_tpu_torch.train import make_eval_step
    eval_step = make_eval_step(student, EVAL_MAX_LEN)
    caption_step = make_caption_step(student, max_len=EVAL_MAX_LEN)
    ds = loader.dataset
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    rows, ms, steps, texts, vids, first = [], [], [], [], [], None
    for batch in loader:
        first = batch["frames"] if first is None else first
        ev[0].record()
        got = eval_step(batch["frames"])
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        u8 = torch.from_numpy(np.stack([
            load_clip_frames(ds.data_path, v, ds.num_frames)
            for v in batch["vid-id"]])).to(dev)
        want = caption_step(u8)
        if not torch.equal(got, want):
            raise AssertionError(
                f"eval rows differ from make_caption_step's on "
                f"{batch['vid-id']}: {int((got != want).sum())} ids")
        rows.append(got.cpu())
        steps.append(decode_steps(got, student.sep_token_id))
        texts += [tok.decode(r.tolist(), skip_special_tokens=True)
                  for r in got.cpu()]
        vids += batch["vid-id"]
    distinct = len({tuple(r) for b in rows for r in b.tolist()})
    log(f"  {distinct} distinct eval rows of {len(vids)} clips (by batch "
        f"{[len({tuple(r) for r in b.tolist()}) for b in rows]})")
    if distinct < 2:
        raise AssertionError("every clip decoded to the same row: the gate "
                             "against make_caption_step would see no fault "
                             "in the loader's frames or order")
    if sorted(p["image_id"] for p in preds) != sorted(ds.vid_ids) or len(
            preds) != len(set(p["image_id"] for p in preds)):
        raise AssertionError("the preds file must name each test clip once")
    if [(p["image_id"], p["caption"]) for p in preds] != list(zip(vids,
                                                                   texts)):
        raise AssertionError("the preds file's texts are not the decode of "
                             "the eval rows")
    return rows, ms, steps, first


def eval_phase(dev) -> dict:
    """The evaluation slice on a seeded MSRVTT-format tree: the bf16 serving
    student, made lively (:func:`lively_`), saved as a checkpoint and scored
    through ``python -m rtvc_tpu_torch.evaluate --ckpt`` (greedy,
    ``max_len`` 45, batches of 8, 8 and 4), gated on its scores and preds
    files, on its launch counts and on its rows against
    ``make_caption_step``'s; then ``evaluate_checkpoint`` greedy and with
    beam 3, timed (wall, loader included); the pruning sweep at 0.5 and
    ``pruning_test.test`` on the pruned checkpoint; and the first batch's
    f32 greedy rows, card vs CPU, reported."""
    import dataclasses
    import os
    import tempfile
    import torch
    from rtvc_tpu_torch import evaluate, metrics, pruning, pruning_test
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.data.io import (load_kd_student_params,
                                        load_pruned_params, save_checkpoint)
    from rtvc_tpu_torch.serving import build_serving_student
    from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer
    from rtvc_tpu_torch.train import make_eval_step

    t_phase = time.perf_counter()
    tok = BertWordPieceTokenizer()
    result = {"clips": EVAL_CLIPS, "max_len": EVAL_MAX_LEN, "launches": {}}

    def add(launched):
        for k, n in launched.items():
            result["launches"][k] = result["launches"].get(k, 0) + n

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        write_eval_tree(root)
        os.chdir(root)   # the config's data paths are relative
        try:
            student = build_serving_student(device=dev)
            lively_(student)
            save_checkpoint("ckpt", {"state_dict": student.state_dict()})
            loader = evaluate.split_loader(cfg, "test", device=dev)
            batches = len(loader)

            # the CLI, greedy
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            evaluate.main(["--ckpt", "ckpt", "--out", "scores.json",
                           "--device", str(dev)])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launched = counts()
            with open("scores.json") as f:
                scores = json.load(f)
            with open("scores.json.preds.json") as f:
                preds = json.load(f)
            check_scores("greedy CLI", scores)
            rows, batch_ms, steps, first = eval_rows_gate(
                student, loader, tok, preds, dev)
            eval_launches("greedy CLI", launched, batches, sum(steps))
            add(launched)
            log(f"  greedy CLI ({cli_s:.2f} s, student build included): "
                f"scores {json.dumps(scores)}; launches {launched}; decode "
                f"steps per batch {steps}; rows equal make_caption_step's")
            for i, r in enumerate(rows[0][:2].tolist()):
                log(f"  clip {i} tokens {r}")

            # evaluate_checkpoint, greedy and beam 3, timed
            annotations = metrics.load_coco_annotations(
                cfg.data.annotation_path)
            timing = {}
            for mode, beam in (("greedy", 0), (f"beam{EVAL_BEAM}",
                                               EVAL_BEAM)):
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                sc, outputs = evaluate.evaluate_checkpoint(
                    cfg, loader, tok, student=student, beam_size=beam,
                    annotations=annotations, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = counts()
                check_scores(mode, sc)
                calls = (EVAL_MAX_LEN - 1) * batches if beam else sum(steps)
                eval_launches(mode, launched, batches, calls)
                add(launched)
                if not beam and sc != scores:
                    raise AssertionError("evaluate_checkpoint's greedy "
                                         "scores differ from the CLI's")
                timing[mode] = dict(wall_s=wall,
                                    clips_per_s=EVAL_CLIPS / wall,
                                    loader_wait_s=loader.wait_s,
                                    scores=sc, launches=launched)
                log(f"  {mode:6s} evaluate_checkpoint {wall * 1e3:.1f} ms "
                    f"wall for {EVAL_CLIPS} clips: "
                    f"{EVAL_CLIPS / wall:.2f} clips/s; consumer waited "
                    f"{loader.wait_s * 1e3:.1f} ms on the loader's queue; "
                    f"launches {launched}")
            result.update(timing, greedy_cli=dict(
                seconds=cli_s, scores=scores, decode_steps=steps))

            # parts of a batch of 8: encode, decode per token
            with torch.inference_mode():
                enc_ms = cuda_ms(lambda: student.forward_image_enc(first),
                                 reps=5, warmup=1)
            b8 = [m for m, r in zip(batch_ms, rows) if len(r) == 8]
            b8_steps = [s for s, r in zip(steps, rows) if len(r) == 8]
            per_token = [(m - enc_ms) / s for m, s in zip(b8, b8_steps)]
            result.update(ms_per_batch8=b8, encode_ms_b8=enc_ms,
                          decode_ms_per_token=per_token)
            log(f"  batch of 8: make_eval_step {[round(m, 2) for m in b8]}"
                f" ms, encode {enc_ms:.2f} ms, decode "
                f"{[round(t, 3) for t in per_token]} ms a token "
                f"({b8_steps} steps)")

            # prune at 0.5, then the pruned model's test epoch
            reset_counts()
            pruning.main(["--ckpt", "ckpt", "--ratios", str(PRUNE_RATIO),
                          "--out_dir", "pruned"])
            before = pruning.sparsity_report(
                load_kd_student_params("ckpt")["state_dict"])
            after = pruning.sparsity_report(load_pruned_params(
                f"pruned/pruned_{PRUNE_RATIO}")["state_dict"])
            want = round(PRUNE_RATIO * before["total"])
            log(f"  pruned {PRUNE_RATIO}: zeros {after['zeros']} of "
                f"{after['total']} prunable (want {want}; "
                f"{before['zeros']} before, which lie below any threshold)")
            if before["zeros"] > want or after["zeros"] != want:
                raise AssertionError(f"pruning at {PRUNE_RATIO} zeroed "
                                     f"{after['zeros']}, not {want}")
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            bleu = pruning_test.test(cfg, loader, tok,
                                     f"pruned/pruned_{PRUNE_RATIO}",
                                     device=dev)
            torch.cuda.synchronize()
            launched = counts()
            log(f"  pruned test epoch: BLEU-4 {bleu} in "
                f"{time.perf_counter() - t0:.2f} s; launches {launched}")
            if not math.isfinite(bleu):
                raise AssertionError("pruned BLEU-4 is not finite")
            calls = launched["layer_norm"] - 20 * batches
            if (launched["window_attention"] != 10 * batches or calls <= 0
                    or calls % 6 or any(
                        n for k, n in launched.items()
                        if k not in ("window_attention", "layer_norm"))):
                raise AssertionError(f"pruned eval launches {launched}")
            add(launched)
            result["pruned"] = dict(ratio=PRUNE_RATIO, zeros=after["zeros"],
                                    zeros_before=before["zeros"],
                                    total=after["total"], bleu4=bleu,
                                    launches=launched)

            # f32, card vs CPU, the first batch's greedy rows
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            f32 = dataclasses.replace(cfg, compute_dtype="float32")
            cpu_student = build_serving_student(device="cpu", config=f32)
            lively_(cpu_student)
            card = copy.deepcopy(cpu_student).to(dev)
            rows_card = make_eval_step(card, EVAL_MAX_LEN)(first).cpu()
            rows_cpu = make_eval_step(cpu_student, EVAL_MAX_LEN)(
                first.cpu())
            div = first_token_divergence(rows_card, rows_cpu)
            result["f32_first_token_divergence"] = div
            log(f"  f32 first-batch greedy, card vs cpu: first-token "
                f"divergence {div:.3f} (reported, not gated)")
            del card, cpu_student
        finally:
            os.chdir(home)
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 7: the frozen teacher
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
    input on the card, to K7's limit: bit for bit."""
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
        tol = limit("w8a8_matmul", site.split()[0])[0]
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
# phase 7b: the teacher in the input-dtype softmax, sampled beam, generate
# ---------------------------------------------------------------------------

def check_beam_rows(label: str, preds, vocab: int) -> None:
    """Beam rows ``[BEAM_BATCH, BEAM_STEPS]``, int32: SOS first, every id
    in the vocabulary, and EOS from a row's first EOS on (its padding)."""
    import torch
    check_tensor(label, preds.float(), (BEAM_BATCH, BEAM_STEPS))
    sos, eos = 101, 102
    if preds.dtype != torch.int32 or not bool((preds[:, 0] == sos).all()):
        raise AssertionError(f"{label}: rows {preds.tolist()}")
    if not bool(((preds >= 0) & (preds < vocab)).all()):
        raise AssertionError(f"{label}: ids out of range")
    for row in preds.tolist():
        if eos not in row[1:]:
            raise AssertionError(f"{label}: a row without EOS {row}")
        first = row.index(eos, 1)
        if any(t != eos for t in row[first:]):
            raise AssertionError(f"{label}: no EOS padding in {row}")


def generate_f32_check(frames, dev) -> dict:
    """The depth-cut float32 teacher (2 CLIP blocks, 2 joint layers, full
    widths, TF32 off) runs the sampled beam on the card and on the CPU with
    the same CPU-generator noise; the share of rows whose first token
    differs is reported, not gated (random weights give near-flat logits,
    where the two devices' sums in another order can swap a sample)."""
    import torch
    from rtvc_tpu_torch.config import GITConfig, clip_vit_l14_config
    from rtvc_tpu_torch.decode import teacher_beam
    from rtvc_tpu_torch.models.git_teacher import GITTeacher, random_init_
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 2)
    cut = GITConfig(clip=clip_vit_l14_config(layers=2), num_layers=2)
    cpu_model = random_init_(GITTeacher(cut), g).eval()
    card = copy.deepcopy(cpu_model).to(dev)
    fr = frames[:BEAM_BATCH].float().cpu()
    rows = {}
    for where, model, x in (("card", card, fr.to(dev)),
                            ("cpu", cpu_model, fr)):
        rows[where] = teacher_beam(
            model, x, beam_size=BEAMS, max_steps=BEAM_STEPS,
            generator=torch.Generator().manual_seed(SEED), **SAMPLE
        ).predictions.cpu()
    div = first_token_divergence(rows["card"], rows["cpu"])
    same = torch.equal(rows["card"], rows["cpu"])
    log(f"  f32 sampled beam, card vs cpu: first-token divergence {div:.3f}"
        f", rows {'equal' if same else 'differ'} (reported, not gated)")
    return {"f32_sampled_first_token_divergence": div,
            "f32_sampled_rows_equal": same}


def generate_phase(dev, exact_beam_ms: float) -> dict:
    """The teacher phase's full-width bf16 teacher (the same seed, weights
    and windows) with ``set_softmax_native_pallas(True)``: the forward, the
    sampled and the exact beam and ``teacher_generate`` in the input-dtype
    softmax, every K4 launch a K4n launch; then the f32 card-vs-CPU sampled
    beam. The switch is turned off again whatever happens."""
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.decode import teacher_beam, teacher_generate
    from rtvc_tpu_torch.models.git_teacher import (random_init_,
                                                   teacher_from_config)
    from rtvc_tpu_torch.ops import attention
    from rtvc_tpu_torch.ops.preprocess import clip_preprocess
    from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

    g = torch.Generator().manual_seed(SEED + 1)
    teacher = random_init_(teacher_from_config(cfg, device=dev), g).eval()
    tc = teacher.config
    blocks, joint, vocab = tc.clip.layers, tc.num_layers, tc.vocab_size
    windows = make_windows(g).to(dev)
    frames = clip_preprocess(windows.reshape((-1,) + windows.shape[2:]))
    frames = frames.reshape((WINDOWS, FRAMES) + frames.shape[1:])
    captions = torch.randint(1000, vocab, (WINDOWS, CAPTION_LEN),
                             generator=g)
    captions[:, 0] = 101
    captions = captions.to(dev)
    result = {"launches": dict(KERNEL_ZERO)}

    def add(launched):
        for k, n in launched.items():
            result["launches"][k] += n

    def forward():
        return teacher.forward_output_logits(frames, captions)[0].float()

    encode = {"blhd_attention": blocks, "fused_add_layer_norm": blocks,
              "flash_attention": 0, "flash_attention_native": joint}

    def beam_launches(steps):
        return dict(encode, layer_norm=blocks + 2 + (1 + 2 * joint)
                    * (1 + steps))

    with torch.inference_mode():
        off, off_ms, _ = timed_run("forward, f32 softmax", forward)
    attention.set_softmax_native_pallas(True)
    try:
        with torch.inference_mode():
            on, on_ms, launched = timed_run("forward, bf16 softmax", forward)
        check_launches("forward in the input-dtype softmax", launched, dict(
            encode, layer_norm=blocks + 4 + 2 * joint))
        add(launched)
        check_tensor("logits in the input-dtype softmax", on,
                     (WINDOWS, CAPTION_LEN, vocab))
        delta = (on - off).abs()
        agree = float((on.argmax(-1) == off.argmax(-1)).float().mean())
        log(f"  logits, bf16 vs f32 softmax: max delta "
            f"{float(delta.max()):.4e}, mean {float(delta.mean()):.4e}, "
            f"argmax agreement {agree:.4f}")
        result.update(forward_native_ms=on_ms, forward_off_ms=off_ms,
                      logits_max_delta=float(delta.max()),
                      logits_mean_delta=float(delta.mean()),
                      argmax_agreement=agree)
        del off, on, delta

        def sampled(seed):
            return teacher_beam(
                teacher, frames[:BEAM_BATCH], beam_size=BEAMS,
                max_steps=BEAM_STEPS,
                generator=torch.Generator().manual_seed(seed), **SAMPLE)

        first, samp_ms, launched = timed_run("sampled beam",
                                             lambda: sampled(SEED))
        check_launches("sampled beam", launched,
                       beam_launches(first.num_steps))
        add(launched)
        again, other = sampled(SEED), sampled(SEED + 1)
        check_beam_rows("sampled beam", first.predictions, vocab)
        check_beam_rows("sampled beam, second seed", other.predictions,
                        vocab)
        if not torch.equal(first.predictions, again.predictions):
            raise AssertionError("sampled beam: one seed, two row sets")
        if torch.equal(first.predictions, other.predictions):
            raise AssertionError("sampled beam: two seeds, one row set")
        log(f"  sampled beam {first.num_steps} steps, rows "
            f"{first.predictions.tolist()}; seed {SEED + 1}: "
            f"{other.predictions.tolist()}")

        with torch.inference_mode():
            exact, ex_ms, launched = timed_run("exact beam", lambda: (
                teacher_beam(teacher, frames[:BEAM_BATCH], beam_size=BEAMS,
                             max_steps=BEAM_STEPS)))
        check_launches("exact beam", launched, beam_launches(exact.num_steps))
        add(launched)
        check_beam_rows("exact beam", exact.predictions, vocab)

        tok = BertWordPieceTokenizer()
        torch.cuda.synchronize()
        reset_counts()
        gen = teacher_generate(teacher, frames[:BEAM_BATCH], tok,
                               beam_size=BEAMS, max_steps=BEAM_STEPS)
        torch.cuda.synchronize()
        launched = counts()
        add(launched)
        if launched["flash_attention_native"] != joint or launched[
                "flash_attention"]:
            raise AssertionError(f"teacher_generate launches {launched}")
        if len(gen) != BEAM_BATCH:
            raise AssertionError(f"teacher_generate: {len(gen)} results")
        for r in gen:
            if set(r) != {"predictions", "cap", "output", "logprobs"}:
                raise AssertionError(f"teacher_generate keys {sorted(r)}")
            n = min(len(r["cap"].split(" ")), BEAM_STEPS - 1)
            check_tensor("teacher_generate output", r["output"],
                         (1, r["output"].shape[1], vocab))
            if (r["output"].device != frames.device
                    or not 1 <= r["output"].shape[1] <= n
                    or r["cap"] != tok.decode(r["predictions"])
                    or not math.isfinite(r["logprobs"])):
                raise AssertionError(
                    f"teacher_generate result {r['cap']!r} "
                    f"{tuple(r['output'].shape)} {r['logprobs']}")
        log(f"  teacher_generate: caps {[r['cap'] for r in gen]}, outputs "
            f"{[tuple(r['output'].shape) for r in gen]}")
    finally:
        attention.set_softmax_native_pallas(False)
    log(f"  times (CUDA events): forward b{WINDOWS} bf16 softmax {on_ms:.3f}"
        f" ms vs f32 softmax {off_ms:.3f} ms; beam b{BEAM_BATCH}x{BEAMS} "
        f"sampled {samp_ms:.3f} ms, exact {ex_ms:.3f} ms (bf16 softmax), "
        f"exact {exact_beam_ms:.3f} ms (teacher phase, f32 softmax)")
    result.update(sampled_beam_ms=samp_ms, exact_beam_native_ms=ex_ms,
                  exact_beam_off_ms=exact_beam_ms,
                  sampled_steps=first.num_steps,
                  sampled_predictions=first.predictions.tolist(),
                  generate_caps=[r["cap"] for r in gen])
    del teacher
    torch.cuda.empty_cache()
    result.update(generate_f32_check(frames, dev))
    return result


# ---------------------------------------------------------------------------
# phase 8: the distillation train step
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


# ---------------------------------------------------------------------------
# phase 9: the training loop
# ---------------------------------------------------------------------------

# the loop phase's MSRVTT-format tree: 3 steps of 8 an epoch, one batch of
# 8 to validate and one to test
LOOP_SPLITS = (("train", 24), ("validate", 8), ("test", 8))
LOOP_EPOCHS = 2
LOOP_BEAM_TOP_K = 128          # the beam cache's top-K consensus rows
LOOP_KILL = (2, 1)             # SIGTERM before batch 1 of the 2nd epoch
REMAT_STEPS = 2


def _sub(a: dict, b: dict) -> dict:
    return {k: a[k] - b.get(k, 0) for k in a}


def _add(*parts: dict, times: int = 1) -> dict:
    out = dict(KERNEL_ZERO)
    for part in parts:
        for k, n in part.items():
            out[k] += n * times
    return out


class EvalCounts:
    """A validation loader that reads the kernels' launch counts as each of
    its passes starts and ends: what launched between two passes is one
    epoch's training."""

    def __init__(self, loader):
        self.loader, self.starts, self.ends = loader, [], []

    def __iter__(self):
        self.starts.append(counts())
        yield from self.loader
        self.ends.append(counts())


class KillAt:
    """A train loader that sends this process SIGTERM before batch ``at[1]``
    of its pass ``at[0]`` (``train()`` reads one batch of pass 0 before its
    loop, so the loop's epoch e is pass 1 + e)."""

    def __init__(self, loader, at):
        self.loader, self.at, self.passes = loader, at, 0

    def __iter__(self):
        import os
        import signal
        p = self.passes
        self.passes += 1
        for i, batch in enumerate(self.loader):
            if (p, i) == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def loop_loaders(config, dev):
    from rtvc_tpu_torch.data.dataset import (CaptionDataset, DeviceLoader,
                                             load_labels)
    data, encoded = load_labels(config.data.captions_path,
                                config.data.encoded_caption_ids)
    out = {}
    for split, _ in LOOP_SPLITS:
        ds = CaptionDataset(config.data.videos_path, data.video_ids(split),
                            data, encoded, num_frames=config.data.num_frames,
                            random_state=config.seed)
        out[split] = DeviceLoader(ds, config.train.batch_size,
                                  shuffle=split == "train", seed=config.seed,
                                  drop_last=split == "train", device=dev)
    return out


def check_eval_launches(label: str, launched: dict, batches: int) -> int:
    """A validation or test pass: K1 10 a TinyViT forward, K2 20 a forward
    and 6 a decode step, nothing else. Returns the decode steps."""
    calls, rest = divmod(launched["layer_norm"] - 20 * batches, 6)
    others = {k: n for k, n in launched.items()
              if k not in ("window_attention", "layer_norm") and n}
    if (launched["window_attention"] != 10 * batches or rest or others
            or not batches <= calls <= EVAL_MAX_LEN * batches):
        raise AssertionError(f"{label}: eval launches {launched}")
    return calls


def loop_phase(dev) -> dict:
    """The training loop at full width (the bf16 TinyViT-21M student over
    float32 masters, the bf16 GIT-Large teacher, batches of 8, two epochs
    of three steps) on a seeded MSRVTT-format tree: ``train()`` live; with
    a full-vocab ``TeacherLogitsCache`` (its losses the live run's within
    1e-5); preempted by SIGTERM after step 4 and resumed with
    ``resume_schedule`` (its end state the live run's bit for bit); beam-KD
    through a top-K ``TeacherBeamCache`` (the hit epoch launches no teacher
    kernel); ``python -m rtvc_tpu_torch.train``, then ``python -m
    rtvc_tpu_torch.evaluate`` on its newest checkpoint (rows equal to its
    test epoch's). Every epoch's and every eval pass's launches are checked
    against the layer counts. Then the beam-KD step with the live beam in
    it, and peak memory with and without ``remat_encoder``. The phase runs
    under ``torch.use_deterministic_algorithms(True)``."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch
    from rtvc_tpu_torch import decode, evaluate, train
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.data import io
    from rtvc_tpu_torch.data.teacher_cache import (TeacherBeamCache,
                                                   TeacherLogitsCache)
    from rtvc_tpu_torch.distill import LossWeights
    from rtvc_tpu_torch.models import git_teacher, student as student_lib
    from rtvc_tpu_torch.serving import build_serving_student
    from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

    t_phase = time.perf_counter()
    tok = BertWordPieceTokenizer()
    config = dataclasses.replace(
        cfg, wandb=dataclasses.replace(cfg.wandb, mode="disabled"),
        train=dataclasses.replace(cfg.train, trainer=dataclasses.replace(
            cfg.train.trainer, max_epochs=LOOP_EPOCHS)))
    beam_kd = LossWeights(ce_teacher=1.0, kd_source="beam_consensus")
    result = {"launches": dict(KERNEL_ZERO), "runs": {}}
    template = student_lib.random_init_(
        student_lib.student_from_config(cfg, device="cpu"),
        torch.Generator().manual_seed(cfg.seed))
    teacher = git_teacher.random_init_(
        git_teacher.teacher_from_config(cfg, device=dev),
        torch.Generator().manual_seed(cfg.seed + 1))
    per_step = train_launches_per_step(template, teacher)
    student_part = dict(per_step, flash_attention=0, blhd_attention=0,
                        fused_add_layer_norm=0,
                        layer_norm=per_step["layer_norm"]
                        - (teacher.config.clip.layers + 4
                           + 2 * teacher.config.num_layers))
    tc = teacher.config
    beam_steps = []
    real_beam = decode.teacher_beam

    def recording_beam(*a, **k):
        out = real_beam(*a, **k)
        beam_steps.append(out.num_steps)
        return out

    def beam_call(steps):
        return dict(KERNEL_ZERO, blhd_attention=tc.clip.layers,
                    fused_add_layer_norm=tc.clip.layers,
                    flash_attention=tc.num_layers,
                    layer_norm=tc.clip.layers + 2
                    + (1 + 2 * tc.num_layers) * (1 + steps))

    home = os.getcwd()
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    # timings comparable with the other phases: no NaN fill of new tensors
    torch.utils.deterministic.fill_uninitialized_memory = False
    root = tempfile.mkdtemp()
    try:
        write_eval_tree(root, LOOP_SPLITS)
        os.chdir(root)

        def run(label, want_epochs, kill=None, **kw):
            """One ``train()`` with fresh loaders and a fresh copy of the
            student; checks each epoch's launches against ``want_epochs``
            (one dict a trained epoch) and each eval pass's; prints and
            returns the run's numbers."""
            loaders = loop_loaders(config, dev)
            val = EvalCounts(loaders["validate"])
            feed = loaders["train"] if kill is None else KillAt(
                loaders["train"], kill)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            state, hist = train.train(
                config, feed, val, loaders["test"], tok, run_name=label,
                student=copy.deepcopy(template).to(dev), teacher=teacher,
                device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = counts()
            # launches between the end of one validation pass and the
            # start of the next are an epoch's training; after the last,
            # the test pass (or, preempted, the interrupted epoch's steps)
            trained = [_sub(start, end) for start, end in zip(
                val.starts, [KERNEL_ZERO] + val.ends)]
            evals = [_sub(end, start)
                     for start, end in zip(val.starts, val.ends)]
            tail = _sub(total, val.ends[-1] if val.ends else KERNEL_ZERO)
            if hist.get("preempted"):
                trained.append(tail)
            else:
                evals.append(tail)
            if want_epochs is not None:
                if len(trained) != len(want_epochs):
                    raise AssertionError(f"{label}: {len(trained)} epochs")
                for e, (got, want) in enumerate(zip(trained, want_epochs)):
                    check_launches(f"{label} epoch {e}", got, want)
            calls = [check_eval_launches(f"{label} eval pass {e}", n, 1)
                     for e, n in enumerate(evals)]
            rec = dict(wall_s=wall, steps=state.step,
                       train_loss=hist["train_loss"],
                       epoch_step_ms=hist["epoch_step_ms"],
                       epoch_n_steps=hist["epoch_n_steps"],
                       first_dispatch_s=hist["epoch_first_dispatch_s"],
                       epoch_fetch_s=hist["epoch_fetch_s"],
                       step_device_ms=hist["epoch_step_device_ms"],
                       eval_s=hist["epoch_eval_s"],
                       ckpt_wait_s=hist.get("ckpt_wait_s"),
                       ckpt_snapshot_s=hist.get("ckpt_snapshot_s"),
                       eval_decode_steps=calls,
                       epoch_launches=trained, launches=total)
            # the loop's host share: each epoch's wall less its steps'
            # spans on the card's stream
            rec["host_s"] = [ms * n / 1e3 - sum(d) / 1e3 for ms, n, d in zip(
                hist["epoch_step_ms"], hist["epoch_n_steps"],
                hist["epoch_step_device_ms"])]
            for k in ("teacher_cache", "teacher_beam_cache", "preempted",
                      "test_loss"):
                if k in hist:
                    rec[k] = hist[k]
            if not all(map(math.isfinite, hist["train_loss"])):
                raise AssertionError(f"{label}: losses {hist['train_loss']}")
            shown = {k: v for k, v in rec.items()
                     if k not in ("epoch_launches", "launches")}
            log(f"  {label}: {json.dumps(shown)}")
            for k, n in total.items():
                result["launches"][k] += n
            result["runs"][label] = rec
            return state, hist

        live_epoch = _add(per_step, times=3)
        hit_epoch = _add(student_part, times=3)
        # 1. live teacher, async checkpoints
        state, live = run("live", [live_epoch, live_epoch])
        live_end = train.train_state_tree(state)
        live_ref = {n: t.detach().cpu().clone() for n, t in
                    live_end["state_dict"].items()}
        live_mu = [m.detach().cpu().clone() for m in state.opt_state.mu]
        live_nu = [m.detach().cpu().clone() for m in state.opt_state.nu]
        live_test = live["test_outputs"]
        del state, live_end
        # 2. a full-vocab logit cache: misses, then hits
        cache = TeacherLogitsCache(os.path.join(root, "logits"))
        state, cached = run("logit_cache", [live_epoch, hit_epoch],
                            teacher_cache=cache)
        del state
        shutil.rmtree(os.path.join(root, "logits"))
        if cached["teacher_cache"] != {"hits": 24, "misses": 24}:
            raise AssertionError(f"logit cache {cached['teacher_cache']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(cached["train_loss"],
                                                      live["train_loss"]))
        log(f"  logit cache epoch losses vs live: max rel {rel:.3e} "
            f"(limit 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError("cache-hit losses differ from live ones")
        result["cache_vs_live_rel"] = rel
        # 3. preempted after step 4, then resumed to the end
        run_dir = os.path.join(config.logger.save_dir, "run")
        state, pre = run("preempt", [live_epoch, _add(per_step)],
                         kill=LOOP_KILL)
        if not (pre.get("preempted") and state.step == 4):
            raise AssertionError(f"preempted run ended at {state.step}")
        ckpt = os.path.join(run_dir, "preempt", "ckpt_preempt")
        meta = io.checkpoint_meta(ckpt)
        if (meta["epoch"], meta["steps_into_epoch"]) != (1, 1):
            raise AssertionError(f"ckpt_preempt meta {meta}")
        del state
        state, res = run("resume", [_add(per_step, times=2)],
                         resume_from=ckpt, resume_schedule=True)
        tree = train.train_state_tree(state)
        names = list(tree["opt_state"]["mu"])
        diff = [n for n, t in tree["state_dict"].items()
                if not torch.equal(t.cpu(), live_ref[n])]
        diff += [f"mu {n}" for n, a, b in zip(names, state.opt_state.mu,
                                              live_mu)
                 if not torch.equal(a.cpu(), b)]
        diff += [f"nu {n}" for n, a, b in zip(names, state.opt_state.nu,
                                              live_nu)
                 if not torch.equal(a.cpu(), b)]
        log(f"  resumed end state vs live: {len(diff)} of "
            f"{len(live_ref) + 2 * len(names)} tensors differ; step "
            f"{state.step}; test rows equal: "
            f"{res['test_outputs'] == live_test}")
        if diff or state.step != 6 or res["test_outputs"] != live_test:
            raise AssertionError(f"resume is not bitwise: {diff[:5]}")
        result["resume_bitwise"] = True
        del state, tree, live_mu, live_nu
        # 4. beam-KD through a top-K beam cache: live beam, then replay
        bcache = TeacherBeamCache(
            os.path.join(root, "beams"), top_k=LOOP_BEAM_TOP_K,
            beam_size=cfg.teacher.beam_size, max_steps=cfg.teacher.max_steps,
            length_penalty=cfg.teacher.length_penalty)
        decode.teacher_beam = recording_beam
        try:
            beam_steps.clear()
            # epoch 1's launches depend on each live beam's steps: checked
            # below, once they are recorded
            state, beam = run("beam_kd_cache", None, loss_weights=beam_kd,
                              teacher_beam_cache=bcache)
        finally:
            decode.teacher_beam = real_beam
        del state
        rec = result["runs"]["beam_kd_cache"]
        want = [_add(hit_epoch, *[beam_call(s) for s in beam_steps]),
                hit_epoch]
        if len(beam_steps) != 3:
            raise AssertionError(f"{len(beam_steps)} live beams")
        for e, (got, w) in enumerate(zip(rec["epoch_launches"], want)):
            check_launches(f"beam_kd_cache epoch {e}", got, w)
        if beam["teacher_beam_cache"] != {"hits": 24, "misses": 24}:
            raise AssertionError(f"beam cache {beam['teacher_beam_cache']}")
        rec["beam_steps"] = list(beam_steps)
        log(f"  beam-KD: live beams ran {beam_steps} steps; the hit epoch "
            f"launched {rec['epoch_launches'][1]}")
        shutil.rmtree(os.path.join(root, "beams"))
        shutil.rmtree(run_dir)
        # 5. the CLI, then evaluate on its newest checkpoint
        train.default_cfg = config
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            state, hist = train.main(["--device", str(dev)])
        finally:
            train.default_cfg = cfg
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launched = counts()
        steps = LOOP_EPOCHS * 3
        want = _add(per_step, times=steps)
        evals = LOOP_EPOCHS + 1
        check_launches("train CLI", dict(launched, layer_norm=0,
                                         window_attention=0),
                       dict(want, layer_norm=0, window_attention=0))
        check_eval_launches("train CLI evals",
                            _sub(launched, _add(per_step, times=steps)),
                            evals)
        for k, n in launched.items():
            result["launches"][k] += n
        run_name = os.listdir(run_dir)[0]
        reset_counts()
        evaluate.main([run_name, "--out", "scores.json", "--device",
                       str(dev)])
        with open("scores.json") as f:
            scores = json.load(f)
        with open("scores.json.preds.json") as f:
            preds = json.load(f)
        check_scores("train CLI checkpoint", scores)
        for k, n in counts().items():
            result["launches"][k] += n
        newest = io.latest_checkpoint(os.path.join(run_dir, run_name))
        scored = build_serving_student(newest, device=dev)
        test = loop_loaders(config, dev)["test"]
        rows_equal = all(
            torch.equal(train.make_eval_step(state.model.eval(),
                                             EVAL_MAX_LEN)(b["frames"]),
                        train.make_eval_step(scored, EVAL_MAX_LEN)(
                            b["frames"])) for b in test)
        log(f"  train CLI {cli_s:.2f} s ({steps} steps, {evals} eval "
            f"passes, student and teacher built); evaluate on "
            f"{os.path.basename(newest)}: corpus BLEU-4 "
            f"{scores['corpus_bleu4']} (test epoch {hist['test_loss']}), "
            f"preds equal: {preds == hist['test_outputs']}, rows equal: "
            f"{rows_equal}")
        if not (rows_equal and preds == hist["test_outputs"]
                and scores["corpus_bleu4"] == hist["test_loss"]):
            raise AssertionError("evaluate's scoring of the CLI's "
                                 "checkpoint differs from its test epoch")
        result["cli"] = dict(seconds=cli_s, scores=scores,
                             epoch_step_ms=hist["epoch_step_ms"],
                             launches=launched)
        del state, scored
        torch.cuda.empty_cache()
    finally:
        os.chdir(home)
        shutil.rmtree(root, ignore_errors=True)
        torch.use_deterministic_algorithms(deterministic)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    result.update(loop_steps_phase(dev, template, teacher, beam_kd))
    result["seconds"] = time.perf_counter() - t_phase
    return result


def loop_steps_phase(dev, template, teacher, beam_kd) -> dict:
    """``make_train_step`` alone on one batch of 8: the beam-KD step with
    the live beam inside it (REMAT_STEPS steps, CUDA events), and the
    default step's peak memory with and without ``remat_encoder`` (the
    same first step's losses equal): each part's (teacher; student
    forward, losses and backward, where the encoder's kept activations
    count; optimizer), split at ``make_train_step``'s marks."""
    import torch
    from rtvc_tpu_torch.config import cfg
    from rtvc_tpu_torch.train import (Adam, create_train_state,
                                      make_train_step, step_generator)
    g = torch.Generator().manual_seed(SEED + 10)
    batch = train_batch(g, dev)
    out = {}
    for label, weights, remat in (("beam_kd_live_step", beam_kd, False),
                                  ("plain_step", None, False),
                                  ("remat_step", None, True)):
        student = copy.deepcopy(template).to(dev)
        student.remat_encoder = remat
        opt = Adam(cfg.train.lr)
        state = create_train_state(student, opt, cfg.dtype)
        kw = {} if weights is None else dict(weights=weights)
        parts = {}

        def mark(name):
            if name in ("student", "optimizer", "end"):
                prev = {"student": "teacher", "optimizer": "student",
                        "end": "optimizer"}[name]
                parts.setdefault(prev, []).append(
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30)
                torch.cuda.reset_peak_memory_stats(dev)

        step = make_train_step(student, teacher, opt, mark=mark, **kw)
        ms, peak, losses = [], [], []
        for i in range(REMAT_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            m = step(state, batch, step_generator(cfg.seed + 2, state.step))
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            peak.append(max(parts[p][-1] for p in parts))
            losses.append({k: float(v) for k, v in m.items()})
        if not all(math.isfinite(v) for l in losses for v in l.values()):
            raise AssertionError(f"{label}: {losses}")
        out[label] = dict(ms=ms, peak_gb=peak, part_peak_gb=parts,
                          losses=losses)
        log(f"  {label}: {json.dumps(out[label])}")
        del student, state, step
        torch.cuda.empty_cache()
    plain, remat = out["plain_step"], out["remat_step"]
    gap = max(abs(a[k] - b[k]) / max(1.0, abs(b[k]))
              for a, b in zip(remat["losses"], plain["losses"]) for k in b)
    log(f"  remat_encoder: peak {max(remat['peak_gb']):.3f} GiB against "
        f"{max(plain['peak_gb']):.3f} without; student forward + backward "
        f"{max(remat['part_peak_gb']['student']):.3f} against "
        f"{max(plain['part_peak_gb']['student']):.3f}; losses of both "
        f"steps differ by {gap:.3e} (relative)")
    if not gap <= 1e-5:
        raise AssertionError("remat_encoder changed the step's losses")
    out["remat_loss_rel_gap"] = gap
    return out

# ---------------------------------------------------------------------------
# phase 10: the parallel layer
# ---------------------------------------------------------------------------

PAR_STEPS = 3                  # dp = 2 steps at full width
PAR_TIMEOUT = 300.0            # each multi-rank job's limit, in seconds
# dp = 2 (or tp = 2) against one rank in float32, compare_runs' worst
# differences: kl/ce/total and grad_norm relative; every step's gradient
# leaves of max(leaf max, GRAD_FLOOR x largest) (dp = 2 runs every GEMM
# at 4 rows where one rank runs 8, and the encoder's train-mode
# BatchNorms amplify the sums' order: 1.77e-5 read on an H100); the
# BatchNorm statistics of max(1, max|x|), 1e-5; the final master weights
# as tests/test_torch_train_loop.py holds them, 1e-4 of max(1, max|w|),
# less the elements whose gradients differ in sign between the runs at
# some step: at most 1% of them (signs differ only where a gradient is
# at the noise), each within Adam's reach of the other run ("moved", in
# units of 2 steps lr: two runs from one start, each moving an element at
# most (1 + 0.004) lr a step in its first three steps)
PAR_LIMITS = {"losses": 1e-5, "grad_norm": 1e-4, "grad": 1e-4,
              "bn": 1e-5, "params": 1e-4, "undecided": 1e-2,
              "moved": 1.01}
# the four weights tp splits over the vocab
TP_SPLIT = {"student": ("linear.weight", "embed.weight"),
            "teacher": ("textual.output.weight",
                        "textual.embedding.words.weight")}


def par_batches(batch: int, steps: int) -> dict:
    """The full-width step's global batches, as the dry-run worker makes
    them from a seed: frames [batch, 6, 224, 224, 3], 40-token captions."""
    from rtvc_tpu_torch.config import cfg
    return dict(seed=SEED + 21, n=steps, batch=batch, frames=FRAMES,
                size=224, caption_len=CAPTION_LEN,
                vocab=cfg.student.vocab_size)


def rounding_noise(student, name: str, shape):
    """The elements of a trained entry whose gradient is zero in exact
    arithmetic, where each run's rounding noise, which Adam turns into
    steps of ±lr, decides the value at every step: the key bias of every
    attention (the softmax is shift-invariant in it), the MLP output bias
    of every stage but the last (it feeds only the next stage's 1x1 conv
    and its train-mode BatchNorm), and the running means of those
    BatchNorms."""
    import numpy as np
    mask = np.zeros(shape, bool)
    parts = name.split(".")
    enc = student.image_encoder["model"]
    last = len(enc.stages) - 1
    if name.endswith("in_proj_bias"):
        d = shape[0] // 3
        mask[d:2 * d] = True
    elif name.endswith("attn.qkv.bias"):
        heads = enc.stages[int(parts[3])]["blocks"][0].attn.num_heads
        mask.reshape(heads, 3, -1)[:, 1] = True
    elif name.endswith("mlp.fc2.bias") and int(parts[3]) < last:
        mask[:] = True
    elif (name.endswith("downsample.conv1.bn.running_mean")
          and int(parts[3]) > 1):
        mask[:] = True
    return mask


def compare_runs(got: dict, want: dict, student, lr: float) -> dict:
    """The worst differences of two dry-run ``step`` jobs' results, as
    tests/test_torch_train_loop.py compares two runs, every one less the
    :func:`rounding_noise` elements:

    - ``losses``: kl, ce and total of each step, relative to max(1,
      |want|); ``grad_norm`` the same;
    - ``grad``: each step's gradient leaves, of max(the leaf's max,
      GRAD_FLOOR × the largest leaf's max);
    - ``params``: the final master weights, of max(1, max|want|), less
      the elements whose gradients differ in sign between the runs at
      some step, where Adam moves each by ±lr on the sign of the noise:
      ``undecided`` is their share, and ``moved`` their worst difference
      in units of 2 · steps · lr (each run moves an element at most about
      lr a step from the same start);
    - ``bn``: the BatchNorm statistics at the end, of max(1, max|want|).

    ``worst_grad`` and ``worst_params`` name the step and leaf of the
    worst ``grad``, and the leaf of the worst ``params``."""
    import torch

    def rel(a, b):
        return abs(a - b) / max(1.0, abs(b))

    out = {"losses": max(rel(a[k], b[k]) for a, b in
                         zip(got["steps"], want["steps"])
                         for k in ("kl", "ce", "total")),
           "grad_norm": max(rel(a["grad_norm"], b["grad_norm"]) for a, b in
                            zip(got["steps"], want["steps"])),
           "grad": 0.0, "worst_grad": None, "params": 0.0, "worst_params": None, "undecided": 0.0,
           "moved": 0.0, "bn": 0.0}
    steps = len(want["grads"])
    tops = [max(float(g.abs().max()) for g in step.values())
            for step in want["grads"]]
    n_undecided = n_kept = 0
    for name, v in want["params"].items():
        keep = ~torch.from_numpy(rounding_noise(student, name,
                                                tuple(v.shape)))
        if not keep.any():
            continue
        undecided = torch.zeros_like(keep)
        for t, (mine, ref) in enumerate(zip(got["grads"], want["grads"])):
            a, b = mine[name], ref[name]
            scale = max(float(b[keep].abs().max()), GRAD_FLOOR * tops[t])
            err = float((a - b)[keep].abs().max()) / scale
            if err > out["grad"]:
                out["grad"], out["worst_grad"] = err, (t, name)
            undecided |= torch.sign(a) != torch.sign(b)
        undecided &= keep
        w = got["params"][name]
        decided = keep & ~undecided
        if decided.any():
            err = float((w - v)[decided].abs().max()) / max(
                1.0, float(v.abs().max()))
            if err > out["params"]:
                out["params"], out["worst_params"] = err, name
        if undecided.any():
            out["moved"] = max(out["moved"], float(
                (w - v)[undecided].abs().max()) / (2 * steps * lr))
        n_undecided += int(undecided.sum())
        n_kept += int(keep.sum())
    out["undecided"] = n_undecided / max(1, n_kept)
    for name, b in want["bn"].items():
        keep = ~torch.from_numpy(rounding_noise(student, name,
                                                tuple(b.shape)))
        if keep.any():
            out["bn"] = max(out["bn"], float(
                (got["bn"][name] - b)[keep].abs().max())
                / max(1.0, float(b.abs().max())))
    return out


def par_compare(label: str, got: dict, want: dict, student,
                lr: float) -> dict:
    errs = compare_runs(got, want, student, lr)
    log(f"  {label}: worst differences {json.dumps(errs)} (limits "
        f"{json.dumps(PAR_LIMITS)})")
    bad = {k: v for k, v in errs.items()
           if k in PAR_LIMITS and not v <= PAR_LIMITS[k]}
    if bad:
        raise AssertionError(f"{label}: over the limit {bad}")
    return errs


def par_timing(label: str, ranks: list, one: dict, smi: str) -> dict:
    """ms a step (wall, synchronised) of each rank against the one-rank
    run, and each rank's time from process start to its first step."""
    import statistics
    out = {"dp2_step_ms": [r["step_ms"] for r in ranks],
           "dp1_step_ms": one["step_ms"],
           "collective_ms": [r["collective_ms"] for r in ranks],
           "start_to_first_step_s": [r["start_to_first_step_s"]
                                     for r in ranks]}
    log(f"  {label}: ms a step dp=2 ranks "
        f"{[[round(t, 2) for t in r['step_ms']] for r in ranks]}, one rank "
        f"{[round(t, 2) for t in one['step_ms']]} (medians "
        f"{[round(statistics.median(r['step_ms']), 2) for r in ranks]} vs "
        f"{round(statistics.median(one['step_ms']), 2)}); process start to "
        f"first step {[round(t, 2) for t in out['start_to_first_step_s']]}"
        f" s; collectives alone, ms (gloo, the ranks on one card) "
        f"{out['collective_ms']} | {smi}")
    return out


def parallel_phase(dev, smi: str) -> dict:
    """Phase 10 on the one card: (a) dp = 2 full-width bf16 train steps on
    two gloo ranks, (b) dp = 2 against one rank in float32, (c) tp = 2
    against tp = 1, (d) the dp caption server, (e) a one-rank NCCL group
    carrying the mesh's collectives."""
    import os
    import shutil
    import tempfile
    import types
    import numpy as np
    import torch
    from rtvc_tpu_torch.config import GITConfig, cfg, clip_vit_l14_config
    from rtvc_tpu_torch.models import student as student_lib
    from rtvc_tpu_torch.parallel import dryrun, make_mesh
    from rtvc_tpu_torch.serving import (BatchCaptionServer,
                                        make_caption_step, with_vocab_w8)
    from rtvc_tpu_torch.tokenization import BertWordPieceTokenizer

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="rtvc_parallel_")
    out = {"device": smi}
    launches = dict(KERNEL_ZERO)
    try:
        # (a) dp = 2, full width, bf16 over float32 masters, dropout on
        job = {"kind": "step", "models": "full", "seed": SEED + 20,
               "dtype": "bfloat16", "lr": cfg.train.lr, "steps": PAR_STEPS,
               "device": str(dev), "threads": 3, "kernels": wrapper_paths(),
               "batches": par_batches(WINDOWS, 1)}
        ranks = dryrun.spawn(dict(job, mesh=(2, 1)), 2, work, PAR_TIMEOUT)
        one = dryrun.run_job(job)
        # the full-width student (the layer counts, the comparisons' masks
        # and the server of (d)); the teacher's layer counts from its config
        student = student_lib.random_init_(
            student_lib.student_from_config(cfg, device="cpu"),
            torch.Generator().manual_seed(SEED + 22))
        teacher = types.SimpleNamespace(config=GITConfig(
            num_layers=cfg.teacher.num_layers, clip=clip_vit_l14_config()))
        per_step = train_launches_per_step(student, teacher)
        want = {k: n * PAR_STEPS for k, n in per_step.items()}
        for r, rank in enumerate(ranks):
            check_launches(f"dp=2 rank {r}", rank["launches"], want)
            for k, n in rank["launches"].items():
                launches[k] += n
        if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
            raise AssertionError(f"dp=2: two ranks sharing {dev} took "
                                 f"{[r['backend'] for r in ranks]}")
        same = all(torch.equal(w, ranks[1]["params"][n])
                   for n, w in ranks[0]["params"].items())
        if not same:
            raise AssertionError("dp=2: the ranks' master weights differ")
        losses = [[s["total"] for s in r["steps"]] for r in ranks]
        if not all(map(math.isfinite, sum(losses, []))):
            raise AssertionError(f"dp=2: non-finite losses {losses}")
        log(f"  (a) dp=2 full-width bf16, {PAR_STEPS} steps of 8 rows (4 a "
            f"rank): total losses ranks {losses}, one rank "
            f"{[s['total'] for s in one['steps']]}; launches a rank "
            f"{ranks[0]['launches']} = layer counts x {PAR_STEPS}; masters "
            f"equal across ranks bit for bit")
        out["a"] = dict(losses=losses,
                        one_rank_losses=[s["total"] for s in one["steps"]],
                        launches=[r["launches"] for r in ranks],
                        **par_timing("(a) bf16", ranks, one, smi))
        del one, ranks

        # (b) dp = 2 against one rank, float32, TF32 off, depth-cut teacher.
        # The one rank's BatchNorms take the dp path's statistics (flax's
        # E[x²] - E[x]² from summed moments, over a group of itself), so
        # only the order of the sums differs (on an H100, against the
        # plain one rank, whose F.batch_norm centres first, the gradients
        # moved 2.4e-5 of their scale where these move 1.8e-5). The dp
        # ranks take step 2 from the one rank's state after step 1: run
        # free, Adam's ±lr steps on the noise-signed elements of step 1
        # move every later gradient (29% of the elements beyond 1e-4 of
        # their leaf's scale at step 2, up to 9.2%, on an H100)
        states = os.path.join(work, "one_rank_state")
        job = dict(job, models="full_cut", dtype="float32", tf32=False,
                   steps=2, dropout=None, batches=par_batches(WINDOWS, 2))
        one = dryrun.spawn(dict(job, mesh=(1, 1), bn_sums=True,
                                save_states=states), 1, work,
                           PAR_TIMEOUT)[0]
        ranks = dryrun.spawn(dict(job, mesh=(2, 1), load_states=states), 2,
                             work, PAR_TIMEOUT)
        out["b"] = dict(errors=[par_compare(f"(b) f32 dp=2 rank {r} vs one",
                                            rank, one, student, job["lr"])
                                for r, rank in enumerate(ranks)],
                        **par_timing("(b) f32", ranks, one, smi))
        del one, ranks

        # (c) tp = 2 against tp = 1: one float32 step (dp = 1: the
        # BatchNorms of both runs centre first)
        job = dict(job, steps=1)
        ranks = dryrun.spawn(dict(job, mesh=(1, 2)), 2, work, PAR_TIMEOUT)
        one = dryrun.run_job(job)
        half = cfg.student.vocab_size // 2
        for r, rank in enumerate(ranks):
            shapes = {"student": rank["local_shapes"],
                      "teacher": rank["teacher_local_shapes"]}
            rows = {n: shapes[m][n][0] for m, names in TP_SPLIT.items()
                    for n in names}
            if set(rows.values()) != {half}:
                raise AssertionError(f"tp=2 rank {r}: vocab rows {rows}")
        out["c"] = dict(errors=[par_compare(f"(c) f32 tp=2 rank {r} vs one",
                                            rank, one, student, job["lr"])
                                for r, rank in enumerate(ranks)],
                        tp2_step_ms=[r["step_ms"] for r in ranks],
                        tp1_step_ms=one["step_ms"])
        log(f"  (c) tp=2: each rank holds {half} vocab rows of "
            f"{sorted(n for v in TP_SPLIT.values() for n in v)}; step ms "
            f"{out['c']['tp2_step_ms']} vs tp=1 {out['c']['tp1_step_ms']}")
        del one, ranks

        # (d) the dp caption server: two replicas on the card, vocab_int8
        student = student.to(dev).to(cfg.dtype).eval()
        windows = make_windows(torch.Generator().manual_seed(SEED + 23))
        wins = windows.numpy()
        server = BatchCaptionServer(
            student, BertWordPieceTokenizer(), max_batch=WINDOWS,
            buckets=(WINDOWS,), max_wait_ms=SERVER_WAIT_MS, max_len=MAX_LEN,
            frame_shape=FRAME_HW + (3,), window=FRAMES, vocab_int8=True,
            mesh=make_mesh((2, 1), devices=[dev, dev]), warmup=False)
        per_replica = []

        def counted(i, step):
            def run(frames):
                torch.cuda.synchronize()
                reset_counts()
                rows = step(frames)
                torch.cuda.synchronize()
                per_replica.append((i, counts(), rows.cpu()))
                return rows
            return run

        server._steps = [counted(i, st) for i, st in enumerate(server._steps)]
        try:
            server.warmup()
            per_replica.clear()
            t0 = time.perf_counter()
            futs = [server.submit(w, stream_id=f"cam{i}")
                    for i, w in enumerate(wins)]
            rows = [f.tokens(timeout=300) for f in futs]
            serve_s = time.perf_counter() - t0
            sizes = list(server.batch_sizes)
        finally:
            server.close()
        if sizes[-1:] != [WINDOWS]:
            raise AssertionError(f"dp server: 8 submits formed {sizes}")
        step4 = make_caption_step(with_vocab_w8(student), max_len=MAX_LEN,
                                  vocab_int8=True)
        halves = [step4(windows[i * 4:(i + 1) * 4].to(dev)).cpu()
                  for i in range(2)]
        from rtvc_tpu_torch.serving import truncate_at_sep
        direct = torch.cat(halves).numpy()
        bad = [i for i, (r, d) in enumerate(zip(rows, direct))
               if not np.array_equal(r, truncate_at_sep(d))]
        if bad:
            raise AssertionError(f"dp server rows {bad} differ from "
                                 f"make_caption_step's at b4")
        replica_launches = {}
        for i, launched, got in per_replica:
            if not torch.equal(got, halves[i]):
                raise AssertionError(f"replica {i}'s rows differ")
            calls = decode_steps(got, cfg.student.sep_token_id)
            want = caption_launches(student, calls)
            want["w8_matmul"] = calls
            check_launches(f"dp server replica {i}", launched, want)
            replica_launches[i] = launched
            for k, n in launched.items():
                launches[k] += n
        if sorted(replica_launches) != [0, 1]:
            raise AssertionError(f"replicas run {sorted(replica_launches)}")
        out["d"] = dict(batch_sizes=sizes, serve_s=serve_s,
                        replica_launches=replica_launches)
        log(f"  (d) dp server, 2 replicas on {dev}, vocab_int8: one batch "
            f"of 8 split 4 + 4 in {serve_s * 1e3:.1f} ms; rows equal "
            f"make_caption_step at b4 on each half bit for bit; launches "
            f"per replica {replica_launches}")
        del student, server

        # (e) NCCL: a one-rank group carries the collectives
        nccl = dryrun.spawn({"kind": "nccl", "device": str(dev),
                             "mesh": (1, 1)}, 1, work, PAR_TIMEOUT)[0]
        if nccl["backend"] != "nccl":
            raise AssertionError(f"a rank that owns {dev} took the "
                                 f"{nccl['backend']} backend")
        out["e"] = nccl
        log(f"  (e) NCCL one-rank group (the backend initialize_distributed"
            f" picks for a rank that owns its card): all-reduce, all-gather "
            f"(all_gather_into_tensor), broadcast exact on bf16 and f32 "
            f"({nccl['bfloat16_ms']:.3f} / "
            f"{nccl['float32_ms']:.3f} ms for the three, first call) | {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every measurement to this "
                                  "JSON file")
    args = ap.parse_args(argv)

    import os
    # the loop phase runs deterministic algorithms, which cuBLAS gives with
    # a fixed workspace; it must be set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    for family, ops in sass.items():
        log(f"[build] {family} tensor-core kernels' SASS: "
            + ", ".join(f"{ops[op]} {op}" for op in SASS_OPS)
            + f", registers {ops['registers']}")
        op = SASS_FAMILIES[family][1]
        if ops[op] == 0:
            raise AssertionError(f"the {family} kernels hold no {op}")
        if op != "HMMA" and ops["WARPGROUP.DEPBAR"] >= ops[op]:
            raise AssertionError(f"the {family} kernels wait after every "
                                 f"{op}: ptxas serialised the products")
    probe = native_probe(dev)

    t0 = time.perf_counter()
    log("[kernels] kernel vs plain on the card")
    records = kernel_phase(dev)
    grad_path = flash_grad_path(dev)
    grad_path.update({k: n for k, n in flash_grad_path(dev, native=True)
                      .items() if k.endswith("_native")})
    extra = native_f32_check(dev)
    extra.update(add_ln_grad_check(dev))
    dispatch = dispatch_host_us(dev)
    log(f"[slice] full-width student, caption steps (kernel phase took "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    student_f32, student, windows_cpu = slice_inputs(dev)
    sl = slice_phase(dev, student_f32, student, windows_cpu)
    log(f"[serve] full-width student, beam {SERVE_BEAM} and the HTTP server "
        f"(slice phase took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sv = serve_phase(dev, student_f32, student, windows_cpu)
    log(f"[export] exported bundle (greedy and beam {SERVE_BEAM}, buckets 1 "
        f"and {WINDOWS}) and compiled package (serve phase took "
        f"{time.perf_counter() - t0:.1f} s)")
    xp = export_phase(dev, student, windows_cpu)
    xp["dispatch_host_us"] = dispatch
    xp.update(dispatch_decision(dispatch, sl, student))
    del student_f32, student, windows_cpu
    torch.cuda.empty_cache()
    log(f"[eval] evaluation path: MSRVTT-format split, evaluate CLI, beam "
        f"{EVAL_BEAM}, pruning (export phase took {xp['seconds']:.1f} s)")
    ev = eval_phase(dev)
    torch.cuda.empty_cache()
    log(f"[teacher] full-width GIT-Large teacher, bf16 (eval phase took "
        f"{ev['seconds']:.1f} s)")
    t0 = time.perf_counter()
    te = teacher_phase(dev)
    log(f"[generate] the teacher in the input-dtype softmax: forward, "
        f"sampled and exact beam, teacher_generate (teacher phase took "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    gn = generate_phase(dev, te["beam_ms"])
    log(f"[train] distillation train step, full-width student and teacher "
        f"(generate phase took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    tr = train_phase(dev)
    log(f"[loop] training loop, full width: live, logit cache, preempt and "
        f"resume, beam-KD cache, CLI (train phase took "
        f"{time.perf_counter() - t0:.1f} s)")
    lp = loop_phase(dev)
    log(f"[parallel] dp=2 and tp=2 train steps on two gloo ranks of the "
        f"card, the dp server, NCCL (loop phase took {lp['seconds']:.1f} s)")
    pp = parallel_phase(dev, smi)
    log(f"[parallel] parallel phase took {pp['seconds']:.1f} s")

    # the row per kernel: its largest error over all cases; its times at
    # its headline bf16 case (the main path's heaviest, but K2 at the
    # decode's [8, 576], its most launched shape, and K3 with the cold L2
    # its bound assumes, its warm time beside them); its launches on the
    # main paths, the beam steps of the serve phase and the eval phase's
    # runs included (K8 has no caller there: its launches are those of
    # flash_attention's gradient in the kernel phase)
    primary = {"window_attention": "bfloat16 stage1 b8",
               "layer_norm": "bfloat16 [8,576]",
               "w8_matmul": "bfloat16 cold L2 M=8",
               "flash_attention": "bfloat16 joint",
               "blhd_attention": "bfloat16 clip",
               "fused_add_layer_norm": "bfloat16 [",
               "w8a8_matmul": "bfloat16 clip qkv",
               "flash_attention_bwd": "bfloat16 joint",
               "dw3x3_wgrad": "bfloat16 stage0",
               "flash_attention_native": "bfloat16 joint",
               "flash_attention_bwd_native": "bfloat16 joint",
               "flash_attention_stats_native": "bfloat16 joint"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        head = next(r for r in mine if r["case"].startswith(primary[name]))
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=sl["launches"][name] + sv["launches"][name]
                   + xp["launches"][name]
                   + ev["launches"][name] + te["launches"][name]
                   + gn["launches"][name] + tr["launches"][name]
                   + lp["launches"][name] + pp["launches"][name],
                   max_abs_err=max(r["max_abs_err"] for r in mine),
                   ms=head["ms"], plain_ms=head["plain_ms"],
                   bound_ms=head["bound_us"] / 1e3,
                   bound_by=head["bound_by"],
                   library_ms=None if head["library_us"] is None
                   else head["library_us"] / 1e3,
                   library_call=head["library_call"],
                   library_timing=head["library_timing"], case=head["case"])
        if name == "w8_matmul":
            warm = next(r for r in mine
                        if r["case"].startswith("bfloat16 M=8"))
            row.update(warm_ms=warm["ms"],
                       replaced_ms=warm["replaced_us"] / 1e3,
                       replaced_call=warm["replaced_call"])
        if name in ("flash_attention_bwd", "flash_attention_bwd_native"):
            row.update(launches=grad_path[name],
                       launches_from="flash_attention autograd, kernel phase")
        if name == "flash_attention_stats_native":
            row.update(launches=grad_path[name],
                       launches_from="standalone flash_attention_bwd, "
                                     "kernel phase")
        if "off_kernel_ms" in head:
            row.update(mode_off_ms=head["off_kernel_ms"])
        kernels.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, sass=sass, kernels=kernels,
                           cases=records, grad_checks=extra,
                           native_probe=probe, slice=sl,
                           serve=sv, export=xp, eval=ev, teacher=te, generate=gn,
                           train=tr, loop=lp, parallel=pp), f,
                      indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
