"""What each step of K4n's and K8n's design gives, on a CUDA card: the
input-dtype softmax's flash kernels whole and with one step taken back.

    python -m rtvc_tpu_torch.profile_native

Run from the repository root. Builds the flash-attention sources
(``csrc/flash_attention*.cu`` and their header) once per variant with
``nvcc`` into ``build/profile_native/``: as they are; with ``expf`` for the
exact fast exponential; with a float32 division for the exact fast dropout
division; with each sweep's products waited before its arithmetic (no
tile in flight); with two blocks an SM for K4n (the first design's
occupancy); with K4n's ring three stages deep, as K4's; and with the row
max taken score by score (the first design's first sweep). Each variant
computes the same function, so its outputs must equal the whole design's
bit for bit. Each is timed in bf16 at chip_smoke.py's K4n and K8n cases
(K8n after a K4n forward, as autograd runs it) and at the mode-off K4 and
K8 joint cases (which the variants leave alone), each a CUDA graph of 10
calls replayed between CUDA events. The variants differ from the sources
only by the edits in ``VARIANTS``; each must apply as often as it says.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch

from . import _build
from .ops import attention
from .profile_w8a8 import graph_us

SOURCES = ("flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_bwd_sm90.cu")
HEADERS = ("common.cuh", "flash_attention_sm90.cuh")
OUT_DIR = _build.BUILD_DIR / "profile_native"
_HEADER = "flash_attention_sm90.cuh"
_FWD = "flash_attention_sm90.cu"
# variant -> ((file, old, new, times), ...)
VARIANTS = {
    "whole design": (),
    "expf exponential": (
        (_HEADER, "uint32_t (&e2)[N],\n" + " " * 43
                  + "int* slow = nullptr) {\n",
         "uint32_t (&e2)[N],\n" + " " * 43 + "int* slow = nullptr) {\n"
         "  if (slow == nullptr) {\n"
         "    for (int q = 0; q < N; ++q)\n"
         "      e2[q] = pack_bf16(expf(lo_half(d2[q])),\n"
         "                        expf(hi_half(d2[q])));\n"
         "    return;\n  }\n", 1),),
    "float32 dropout division": (
        (_HEADER, "float keep_b,\n" + " " * 43 + "int* slow = nullptr) {\n",
         "float keep_b,\n" + " " * 43 + "int* slow = nullptr) {\n"
         "  if (slow == nullptr) {\n"
         "    for (int q = 0; q < N; ++q)\n"
         "      p2[q] = pack_bf16(lo_half(p2[q]) / keep_b, hi_half(p2[q]) / "
         "keep_b);\n"
         "    return;\n  }\n", 1),),
    "sweeps waited": (
        (_HEADER, "    wgmma_wait_n<kGroups>();", "    wgmma_wait();", 2),),
    "two blocks an SM": (
        (_FWD, "__launch_bounds__(kThreads, 3)\n"
               "    attention_native_sm90_kernel",
         "__launch_bounds__(kThreads, 2)\n"
         "    attention_native_sm90_kernel", 1),),
    "three ring stages": (
        (_FWD, "constexpr int kNStages = 4;", "constexpr int kNStages = 3;",
         1),),
    "max score by score": (
        (_FWD, "const bool monotone = scale_b > 0.f;",
         "const bool monotone = false;", 1),),
}


def variant_dir(i: int, name: str):
    """Variant ``name``'s copies of the sources, edited, in its own
    directory."""
    out = OUT_DIR / f"variant{i}"
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (_build.CSRC / f).read_text() for f in SOURCES + HEADERS}
    for f, old, new, times in VARIANTS[name]:
        if texts[f].count(old) != times:
            raise RuntimeError(f"{name}: an edit does not apply to {f}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    return out


def build_variants() -> dict:
    """Variant name -> its loaded library, built by nvcc in parallel."""
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    nvcc = _build._nvcc()
    jobs = {}
    for i, name in enumerate(VARIANTS):
        src = variant_dir(i, name)
        lib = src / "variant.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               *(str(src / f) for f in SOURCES)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for fn in ("rtvc_flash_attention", "rtvc_flash_attention_bwd"):
            getattr(handle, fn).argtypes = _build.SIGNATURES[fn]
            getattr(handle, fn).restype = ctypes.c_int
        libs[name] = handle
    return libs


def cases(dev) -> list:
    """(label, the call) at chip_smoke.py's K4n/K8n cases and the mode-off
    K4/K8 joint cases: the joint attention of 8 windows (1542 visual + 40
    text tokens, heads of one packed QKV product), key-masked (one batch row
    with every key masked), dropout 0.1, the beam's visual prefill."""
    g = torch.Generator().manual_seed(0)
    b, h, lq, d, prefix = 8, 12, 1582, 64, 1542

    def heads(n):
        qkv = torch.randn(b, n, 3, h, d, generator=g).to(dev, torch.bfloat16)
        return tuple(t.transpose(1, 2) for t in qkv.unbind(2))

    q, k, v = heads(lq)
    go = torch.randn(b, h, lq, d, generator=g).to(dev, torch.bfloat16)
    mask = torch.rand(b, lq, generator=g).to(dev) > 0.1
    mask[-1] = False
    joint = dict(causal=True, prefix_len=prefix)
    drop = dict(joint, dropout_rate=0.1, seed=12345)
    pq, pk, pv = heads(prefix)
    out = []
    for label, args, kw in (("joint", (q, k, v), joint),
                            ("key-masked", (q, k, v),
                             dict(joint, kv_mask=mask)),
                            ("dropout 0.1", (q, k, v), drop),
                            ("beam prefill", (pq, pk, pv),
                             dict(causal=True, prefix_len=prefix))):
        out.append((f"K4n {label}", lambda a=args, kw=kw: attention
                    .flash_attention(*a, softmax_in_input_dtype=True, **kw)))
    for label, kw in (("joint", joint), ("dropout 0.1", drop)):
        def k8n(kw=kw):
            # the forward's statistics, then K8n as autograd runs it
            stats = attention._stats_buffer(q)
            attention._flash_forward(q, k, v, None, True, prefix,
                                     d ** -0.5, kw.get("dropout_rate", 0.0),
                                     kw.get("seed"), True, stats=stats)
            return lambda: attention._flash_backward(
                q, k, v, go, None, True, prefix, d ** -0.5,
                kw.get("dropout_rate", 0.0), kw.get("seed"), True,
                row_stats=stats)
        out.append((f"K8n {label}", k8n))
    out.append(("K4 joint (mode off)",
                lambda: attention.flash_attention(q, k, v, **joint)))
    out.append(("K8 joint (mode off)", lambda: attention.flash_attention_bwd(
        q, k, v, go, **joint)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_native: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    dev = torch.device("cuda", 0)
    print("case, then device us per call: " + ", ".join(libs), flush=True)
    saved = _build.lib()
    try:
        for label, make in cases(dev):
            times, first = [], None
            for name, lib in libs.items():
                _build._lib = lib
                fn = make() if label.startswith("K8n") else make
                got = fn()
                torch.cuda.synchronize()
                if first is None:
                    first = got
                elif not all(torch.equal(a, b) for a, b in zip(
                        *(t if isinstance(t, tuple) else (t,)
                          for t in (got, first)))):
                    raise AssertionError(f"{label}: variant {name} differs "
                                         f"from the whole design")
                times.append(graph_us(fn))
            print(f"  {label}: " + ", ".join(f"{t:.2f}" for t in times),
                  flush=True)
    finally:
        _build._lib = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
