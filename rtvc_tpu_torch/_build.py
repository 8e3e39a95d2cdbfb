"""Build the CUDA kernels in ``csrc/`` into one shared library and load it.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into one library in
``build/`` at the repository root, named by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
The kernels have a plain C interface (pointers, sizes and the stream) and
are bound with ``ctypes``: no PyTorch header is compiled, which keeps the
build to seconds. Each C entry point returns ``cudaGetLastError()`` after
its launch; :func:`check` raises on anything but 0. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint
# the dropout arguments of K4 and K8: seed, threshold, 1 - rate, on; then
# the input-dtype softmax flag
_DROPOUT = [_U, _U, _F, _I, _I]
# C entry point -> argument types (every pointer and the stream as void*)
SIGNATURES = {
    "rtvc_window_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                              _I, _P],
    "rtvc_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rtvc_add_layer_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rtvc_w8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ... then K4n's row statistics (or null) and stats-only flag
    "rtvc_flash_attention": [_P] * 5 + [_I] * 5 + [_L] * 12
                            + [_F, _I, _I] + _DROPOUT + [_P, _I, _I, _P],
    # ... then K8n's Delta scratch (or null)
    "rtvc_flash_attention_bwd": [_P] * 9 + [_I] * 5 + [_L] * 12
                                + [_F, _I, _I] + _DROPOUT + [_P, _I, _P],
    "rtvc_native_probe": [_P, _F, _P],
    "rtvc_blhd_attention": [_P] * 4 + [_I] * 4 + [_L] * 9 + [_F, _I, _P],
    "rtvc_w8a8_matmul": [_P] * 6 + [_I] * 4 + [_P],
    "rtvc_dw3x3_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of rtvc_tpu_torch cannot be built")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtvc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library for the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    work = BUILD_DIR / f"objects.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"),
               str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    failed = []
    for cmd, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
            *(str(work / f"{src.stem}.o") for src in sources())]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
