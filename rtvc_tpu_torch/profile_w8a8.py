"""Where K7's time goes, on a CUDA card: the W8A8 GEMM at the teacher's
shapes, whole and with parts of its epilogue left out.

    python -m rtvc_tpu_torch.profile_w8a8

Run from the repository root. Builds ``csrc/w8a8_matmul_sm90.cu`` three
times with ``nvcc`` into ``build/profile_w8a8/``: as it is, with its global
stores left out (the epilogue's arithmetic and shared-memory staging still
run) and with the whole epilogue left out (the main loop: TMA ring and
wgmma products). Each is timed in bf16 at the six timed K7 cases of
``chip_smoke.py`` (CUDA graph of 10 calls replayed between CUDA events),
beside ``torch._int_mm`` (the int32 product alone) where it takes the
shape. The whole kernel is first held bit for bit against
``w8a8_matmul_plain``. The variants differ from the source only by the
edits in ``VARIANTS``; each must apply exactly once.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from . import _build
from .ops.int8_gemm import w8a8_matmul_plain

SOURCE = _build.CSRC / "w8a8_matmul_sm90.cu"
OUT_DIR = _build.BUILD_DIR / "profile_w8a8"
# the stores of the staged rows (16-byte pieces; words), and the start of
# the epilogue
_STORE = "*reinterpret_cast<uint4*>(out + (size_t)grow * a.N + gcol) = v;"
_WORDS = "if (grow >= a.M || gcol >= a.N) continue;"
_EPILOGUE = "    const int r0 = 64 * wg + 16 * (warp % 4);"
VARIANTS = {
    "whole kernel": (),
    "no global stores": (
        (_STORE, "if (v.x == 0x7fffffffu && v.y == 1u) " + _STORE),
        (_WORDS, "if (grow >= a.M || gcol >= a.N || v != 0x7fffffffu) "
                 "continue;")),
    "main loop only": ((_EPILOGUE, "    if (a.K > 0) {\n"
                                   "      if (ct == 0) out[0] = from_f<T>("
                                   "(float)acc[0] + acc[kAcc - 1]);\n"
                                   "      continue;\n    }\n"
                                   + _EPILOGUE),),
}


def variant_source(name: str) -> str:
    """The kernel source with variant ``name``'s edits applied."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: an edit does not apply to "
                               f"{SOURCE.name}")
        text = text.replace(old, new)
    return text


# (label, M, K, N): chip_smoke.py's timed K7 cases at batch 8
CASES = [("clip qkv", 12336, 1024, 3072), ("clip c_fc", 12336, 1024, 4096),
         ("clip c_proj", 12336, 4096, 1024), ("joint fc2", 12656, 3072, 768),
         ("vocab", 320, 768, 30522), ("vocab", 8, 768, 30522)]


def build_variants() -> dict:
    """Variant name -> its loaded library, built by nvcc in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for i, name in enumerate(VARIANTS):
        path = OUT_DIR / f"variant{i}.cu"
        path.write_text(variant_source(name))
        lib = OUT_DIR / f"variant{i}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
               "-o", str(lib), str(path),
               str(_build.CSRC / "window_attention_sm90.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        handle.rtvc_w8a8_matmul.argtypes = _build.SIGNATURES[
            "rtvc_w8a8_matmul"]
        handle.rtvc_w8a8_matmul.restype = ctypes.c_int
        libs[name] = handle
    return libs


def graph_us(fn, reps: int = 10) -> float:
    """Device µs per call: ``reps`` calls captured into a CUDA graph and
    replayed once between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_w8a8: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    print("case, then device us per call: " + ", ".join(libs)
          + ", torch._int_mm")
    for label, m, k, n in CASES:
        xq = torch.randint(-127, 128, (m, k), generator=g,
                           dtype=torch.int8).to(dev)
        pack = torch.randint(-127, 128, (n, k), generator=g,
                             dtype=torch.int8).to(dev)
        sx = (torch.rand(m, generator=g) * 0.02 + 1e-3).to(dev)
        sw = (torch.rand(n, generator=g) * 1e-3 + 1e-4).to(dev)
        bias = (torch.randn(n, generator=g) * 0.1).to(dev)
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        times = []
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                err = lib.rtvc_w8a8_matmul(
                    xq.data_ptr(), sx.data_ptr(), pack.data_ptr(),
                    sw.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k,
                    1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            call()
            if not VARIANTS[name]:
                want = w8a8_matmul_plain(xq, sx, pack.t(), sw, bias,
                                         torch.bfloat16)
                if not torch.equal(out, want):
                    raise AssertionError(f"{label}: K7 differs from its "
                                         f"plain version")
            times.append(graph_us(call))
        lib_us = (graph_us(lambda: torch._int_mm(xq, pack.t()))
                  if n % 8 == 0 else None)
        print(f"  {label} M={m} [{k}->{n}]: "
              + ", ".join(f"{t:.2f}" for t in times)
              + (f", {lib_us:.2f}" if lib_us is not None else ", none"),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
