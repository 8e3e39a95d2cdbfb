"""Where K3's time goes, on a CUDA card: the bf16 int8 vocab GEMV at the
decode's shapes, whole and with its weight read or its products left out.

    python -m rtvc_tpu_torch.profile_w8

Run from the repository root. Builds ``csrc/w8_matmul.cu`` five times with
``nvcc`` into ``build/profile_w8/``: as it is, with every warp's tile copy
issued at once (not six at a time), without the products (the
weight is still copied into shared memory and waited for), without the
weight copy (the products run on whatever shared memory holds), and with
neither (the launch, the staging of x, the barriers and the epilogue).
Each is timed at M = 1 and 8 rows of x [M, 576] against the [31744, 576] vocab pack, with a
warm L2 (one pack) and a cold one (each call the next of 5 packs, 91.5 MB),
as ``chip_smoke.py`` times K3 (CUDA graph of 50 calls replayed between
CUDA events). The whole kernel is first held against ``w8_matmul_plain``.
The variants differ from the source only by the edits in ``VARIANTS``;
each must apply exactly once.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess

import torch

from . import _build
from .ops.int8_gemm import w8_matmul_plain
from .profile_w8a8 import graph_us

SOURCE = _build.CSRC / "w8_matmul.cu"
OUT_DIR = _build.BUILD_DIR / "profile_w8"
# the bf16 kernel's chunk loop; the tile copy's arrival on the warp's
# barrier, which without the copy arrives with no bytes to wait for
_LOOP = "for (int c = 0; c * kChunkK < kg; ++c) {"
_EXPECT = "  mbar_expect_tx(bar, (uint32_t)(rows * kg));"
_NO_PRODUCTS = (_LOOP, "for (int c = 0; c * kChunkK < kg && K < 0; ++c) {")
_NO_COPY = (_EXPECT, "  mbar_arrive(bar);\n  return;")
VARIANTS = {
    "whole kernel": (),
    "every copy at once": (("constexpr int kAhead = 6;",
                            "constexpr int kAhead = kWarps;"),),
    "no products": (_NO_PRODUCTS,),
    "no weight copy": (_NO_COPY,),
    "neither": (_NO_PRODUCTS, _NO_COPY),
}
N, K, PACKS = 31744, 576, 5


def variant_source(name: str) -> str:
    """The kernel source with variant ``name``'s edits applied."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: an edit does not apply to "
                               f"{SOURCE.name}")
        text = text.replace(old, new)
    return text


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
        handle.rtvc_w8_matmul.argtypes = _build.SIGNATURES["rtvc_w8_matmul"]
        handle.rtvc_w8_matmul.restype = ctypes.c_int
        libs[name] = handle
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_w8: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    packs = [torch.randint(-127, 128, (N, K), generator=g,
                           dtype=torch.int8).to(dev) for _ in range(PACKS)]
    sw = (torch.rand(N, generator=g) / (127 * 24)).to(dev)
    bias = (torch.randn(N, generator=g) * 0.1).to(dev)
    print("case, then device us per call: " + ", ".join(libs))
    for m in (1, 8):
        x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
        out = torch.empty(m, N, dtype=torch.bfloat16, device=dev)
        for cold in (False, True):
            turn = itertools.cycle(packs if cold else packs[:1])
            times = []
            for name, lib in libs.items():
                def call(lib=lib, name=name):
                    err = lib.rtvc_w8_matmul(
                        x.data_ptr(), next(turn).data_ptr(), sw.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), m, K, N, 1,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                if not VARIANTS[name]:
                    turn = itertools.cycle(packs if cold else packs[:1])
                    call()
                    want = w8_matmul_plain(x, packs[0].t(), sw, bias)
                    err = float((out.float() - want.float()).abs().max())
                    if not err <= 2e-2 * max(1.0, float(want.abs().max())):
                        raise AssertionError(f"M={m}: K3 differs from its "
                                             f"plain version by {err}")
                times.append(graph_us(call, reps=50))
            print(f"  M={m} {'cold' if cold else 'warm'} L2: "
                  + ", ".join(f"{t:.2f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
