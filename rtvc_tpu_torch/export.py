"""Deployment artifacts: exported caption programs and compiled packages.

Counterpart of ``rtvc_tpu/export.py``. A serving host that unpickles the
whole model (the reference's ``torch.load('results/student_model.pt')``)
needs the model code and rebuilds the module at every start. Here the
caption step is exported ahead of time, in two strengths:

1. **Portable programs** (``torch.export``): each serving bucket's
   preprocess + decode program (``serving.make_caption_step``, the function
   ``BatchCaptionServer`` runs) is traced into an ``ExportedProgram`` and
   saved as a ``.pt2`` file. Loading needs torch and this package's
   operators (``rtvc_tpu_torch.ops``: kernels K1 and K2 are the
   ``torch.library`` ops ``rtvc::window_attention`` and
   ``rtvc::layer_norm``, which the program keeps as graph nodes), and none
   of the model code: nothing of ``models``, ``decode`` or ``serving``.
   The greedy program reads nothing back from the device
   (``host_stop=False``): it always runs ``max_len`` steps and writes 0
   after an all-rows SEP, as JAX's while-loop leaves the rows.

2. **Compiled packages** (AOTInductor, ``torch._inductor``): one bucket's
   program compiled to a shared library in a ``.pt2`` package, so that a
   serving restart skips tracing and compiling. The package is tied to the
   device kind and the torch build that compiled it; bundles are the
   portable form. ``save_compiled`` loads the package back and holds its
   rows on a fixed probe input equal to the exported program's.

The weights are an argument of every program, never a constant of it:
``(variables, frames_u8) -> tokens``, where ``variables`` is the student's
state dict (parameters and persistent buffers by name). A program is for
one device: the device of the caches and of the preprocess constants is
traced into it, and the manifest names it.

A bundle directory::

    bundle/
      manifest.json       # buckets, window, frame shape, max_len, beam,
                          # device, the variables' names, n_params
      program_b{B}.pt2    # torch.export.save, one per bucket
      params/             # data/io.save_checkpoint of the variables

CLI (writes a bundle from a checkpoint, random weights if omitted)::

    python -m rtvc_tpu_torch.export --out bundle/ [--ckpt DIR]
        [--buckets 1,2,4,8] [--max-len 25] [--beam K] [--device cuda]
        [--compiled]
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# registers the rtvc:: operators the programs call
from .ops import attention, layernorm  # noqa: F401

MANIFEST = "manifest.json"
PARAMS_DIR = "params"
_FORMAT_VERSION = 1

Variables = Dict[str, torch.Tensor]


def serving_variables(student: nn.Module) -> Variables:
    """The student's parameters and persistent buffers by state-dict name:
    the ``variables`` argument of every program."""
    return dict(student.state_dict())


class _CaptionProgram(nn.Module):
    """``(variables, frames_u8) -> tokens``: ``make_caption_step`` with the
    student's weights read from ``variables`` (``torch.func.
    functional_call``). The student is held outside the module tree, so
    that export lifts none of its weights into the program; its
    non-persistent buffers (TinyViT's bias index tables, the positional
    table) stay constants."""

    def __init__(self, student: nn.Module, max_len: int, beam: int):
        super().__init__()
        from .serving import make_caption_step

        runner = nn.Module()
        runner.student = student
        step = make_caption_step(student, max_len=max_len, beam=beam,
                                 host_stop=False)
        runner.forward = step
        self._runner = (runner,)

    def forward(self, variables: Variables,
                frames_u8: torch.Tensor) -> torch.Tensor:
        named = {f"student.{k}": v for k, v in variables.items()}
        return torch.func.functional_call(self._runner[0], named,
                                          (frames_u8,))


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _ordered(expected: Sequence[str], variables: Variables) -> Variables:
    """``variables`` in the order of ``expected`` (the program's input
    order), or a ValueError naming what is missing or unexpected."""
    known = set(expected)
    missing = [k for k in expected if k not in variables]
    unexpected = [k for k in variables if k not in known]
    if missing or unexpected:
        raise ValueError(f"variables do not match the program's: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
    return {k: variables[k] for k in expected}


def export_caption_program(student: nn.Module, variables: Variables, *,
                           batch: int, window: int = 6,
                           frame_shape: Sequence[int] = (224, 224, 3),
                           max_len: int = 25, beam: int = 0, device=None
                           ) -> torch.export.ExportedProgram:
    """Trace one serving bucket into a ``torch.export.ExportedProgram``.

    Its signature is the serving one: ``(variables, frames_u8[batch,
    window, *frame_shape] uint8) -> int32 tokens``, the weights a runtime
    argument. The program is exported on ``device`` (``cuda`` by default),
    where the student and ``variables`` must lie, and runs there only."""
    dev = _device(device)
    variables = _ordered(list(serving_variables(student)), variables)
    for name, t in variables.items():
        if t.device != dev:
            raise ValueError(f"variables[{name!r}] is on {t.device}, not "
                             f"on the export device {dev}")
    frames = torch.zeros((batch, window) + tuple(frame_shape),
                         dtype=torch.uint8, device=dev)
    program = _CaptionProgram(student, max_len=max_len, beam=beam)
    return torch.export.export(program, (variables, frames))


def save_bundle(out_dir: str, student: nn.Module, variables: Variables, *,
                buckets: Sequence[int] = (1, 2, 4, 8), window: int = 6,
                frame_shape: Sequence[int] = (224, 224, 3),
                max_len: int = 25, beam: int = 0, device=None,
                save_params: bool = True) -> Dict[str, Any]:
    """Write a deployment bundle: one exported program per bucket, the
    manifest and (``save_params``) the variables. Returns the manifest.
    ``save_params=False`` writes programs and manifest only; the loader
    then needs ``variables=``."""
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    os.makedirs(out_dir, exist_ok=True)
    dev = _device(device)
    variables = _ordered(list(serving_variables(student)), variables)
    manifest: Dict[str, Any] = {
        "format_version": _FORMAT_VERSION,
        "buckets": list(buckets),
        "window": int(window),
        "frame_shape": list(frame_shape),
        "max_len": int(max_len),
        "beam": int(beam),
        "device": str(dev),
        "n_params": sum(int(t.numel()) for t in variables.values()),
        "has_params": bool(save_params),
        "variables": list(variables),
        "programs": {},
    }
    for b in buckets:
        program = export_caption_program(
            student, variables, batch=b, window=window,
            frame_shape=frame_shape, max_len=max_len, beam=beam, device=dev)
        program.example_inputs = None  # they hold the weights
        name = f"program_b{b}.pt2"
        torch.export.save(program, os.path.join(out_dir, name))
        manifest["programs"][str(b)] = name
    if save_params:
        from .data.io import save_checkpoint
        save_checkpoint(os.path.join(out_dir, PARAMS_DIR),
                        {"state_dict": dict(variables)})
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedCaptioner:
    """Serve captions from a bundle directory, without the model code.

    The ``BatchCaptionServer`` bucket policy: a request batch is padded with
    zero windows to the smallest covering bucket and the pad rows are
    dropped. Rows are independent and the all-rows-SEP stop only runs
    longer with more rows, so a row truncated at its first SEP is the same
    in any bucket. Token rows come back untruncated; pair them with
    ``serving.truncate_at_sep`` and a tokenizer for text."""

    def __init__(self, path: str, variables: Optional[Variables] = None):
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(
                f"bundle format {self.manifest['format_version']} is newer "
                f"than this loader ({_FORMAT_VERSION})")
        self.window = int(self.manifest["window"])
        self.frame_shape = tuple(self.manifest["frame_shape"])
        self.max_len = int(self.manifest["max_len"])
        self.beam = int(self.manifest["beam"])
        self.device = torch.device(self.manifest["device"])
        self.buckets = tuple(sorted(int(b)
                                    for b in self.manifest["buckets"]))
        self._programs = {}
        for b, name in self.manifest["programs"].items():
            program = torch.export.load(os.path.join(path, name))
            self._programs[int(b)] = program.module()
        if variables is None:
            if not self.manifest.get("has_params", True):
                raise ValueError(
                    "bundle has no params/: pass variables= explicitly")
            from .data.io import restore_checkpoint
            variables = restore_checkpoint(
                os.path.join(path, PARAMS_DIR))["state_dict"]
        self.variables = {k: v.to(self.device) for k, v in
                          _ordered(self.manifest["variables"],
                                   variables).items()}

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch {n} exceeds largest exported bucket {self.buckets[-1]}")

    def caption_tokens(self, windows: np.ndarray) -> np.ndarray:
        """``[B, window, H, W, 3]`` uint8 → ``[B, tokens]`` int32 rows."""
        windows = np.asarray(windows, np.uint8)
        if windows.ndim != 5 or windows.shape[1:] != \
                (self.window,) + self.frame_shape:
            raise ValueError(
                f"expected [B, {self.window}, {self.frame_shape}] uint8, "
                f"got {windows.shape}")
        n = windows.shape[0]
        b = self.bucket_for(n)
        if b != n:
            pad = np.zeros((b - n,) + windows.shape[1:], np.uint8)
            windows = np.concatenate([windows, pad], axis=0)
        return self(torch.from_numpy(windows).to(self.device)).cpu() \
            .numpy()[:n]

    def __call__(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """The program of bucket ``frames_u8.shape[0]`` on uint8 frames
        already on the bundle's device → int32 token rows there."""
        program = self._programs.get(int(frames_u8.shape[0]))
        if program is None:
            raise ValueError(f"no exported bucket of {frames_u8.shape[0]} "
                             f"(buckets {self.buckets})")
        with torch.inference_mode():
            return program(self.variables, frames_u8)


def load_bundle(path: str,
                variables: Optional[Variables] = None) -> ExportedCaptioner:
    return ExportedCaptioner(path, variables=variables)


# ---------------------------------------------------------------------------
# Compiled packages (AOTInductor): tracing- and compile-free restarts

def _probe_input(batch: int, window: int, frame_shape: Sequence[int]):
    """Deterministic uint8 probe batch shared by write and verify."""
    shape = (batch, window) + tuple(frame_shape)
    return (np.arange(int(np.prod(shape))) % 251).reshape(shape) \
        .astype(np.uint8)


def _meta_path(path: str) -> str:
    return path + ".json"


def _links_openmp(cxx: str) -> bool:
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probe.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        proc = subprocess.run([cxx, "-fopenmp", src, "-o",
                               os.path.join(d, "probe")],
                              capture_output=True, timeout=120)
    return proc.returncode == 0


def _openmp_cxx() -> str:
    """The C++ compiler for AOTInductor's package: Inductor links the
    package's wrapper with ``-fopenmp``, and a compiler installed without
    its OpenMP runtime (no ``libgomp.spec``) fails that link. The first of
    ``$CXX``, ``g++``, ``c++`` and ``clang++`` on ``PATH`` that links an
    OpenMP program."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        cxx = shutil.which(name) if name else None
        if cxx and _links_openmp(cxx):
            return cxx
    raise RuntimeError("no C++ compiler here links an OpenMP program "
                       "(-fopenmp), which an AOTInductor package needs")


def save_compiled(path: str, student: nn.Module, variables: Variables, *,
                  batch: int, window: int = 6,
                  frame_shape: Sequence[int] = (224, 224, 3),
                  max_len: int = 25, beam: int = 0, device=None) -> None:
    """Compile one bucket with AOTInductor into the package ``path``
    (``.pt2``), with its metadata in ``path + ".json"``.

    :func:`load_compiled` on the same device kind and torch build skips
    tracing and compiling. The package is verified before this returns: it
    is loaded back and run on a fixed probe input, and its rows must equal
    the exported program's on the same input, else RuntimeError."""
    dev = _device(device)
    variables = _ordered(list(serving_variables(student)), variables)
    program = export_caption_program(
        student, variables, batch=batch, window=window,
        frame_shape=frame_shape, max_len=max_len, beam=beam, device=dev)
    with torch._inductor.config.patch({"cpp.cxx": (None, _openmp_cxx())}):
        torch._inductor.aoti_compile_and_package(program,
                                                 package_path=path)
    meta = {"batch": int(batch), "window": int(window),
            "frame_shape": list(frame_shape), "max_len": int(max_len),
            "beam": int(beam), "device": str(dev),
            "variables": list(variables)}
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f, indent=2)
    probe = torch.from_numpy(_probe_input(batch, window, frame_shape)).to(dev)
    with torch.inference_mode():
        want = program.module()(dict(variables), probe)
        fn, _ = load_compiled(path)
        got = fn(variables, probe)
    if not torch.equal(got.cpu(), want.cpu()):
        raise RuntimeError(
            f"compiled package {path} failed verification: its rows on the "
            "probe differ from the exported program's")


def load_compiled(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load a :func:`save_compiled` package → (callable, meta dict).

    The callable has the serving signature ``(variables, frames_u8)``
    (tensors on the package's device) and runs the compiled library."""
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    meta["frame_shape"] = tuple(meta["frame_shape"])
    package = torch._inductor.aoti_load_package(path)
    names = meta["variables"]

    def run(variables: Variables, frames_u8: torch.Tensor) -> torch.Tensor:
        return package(_ordered(names, variables), frames_u8)

    return run, meta


# ---------------------------------------------------------------------------
# CLI

def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Export caption-serving artifacts (a bundle of "
                    "exported programs, optionally a compiled package)")
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (rtvc_tpu_torch.data.io layout); "
                        "random weights if omitted")
    p.add_argument("--buckets", default="1,2,4,8")
    p.add_argument("--max-len", type=int, default=25)
    p.add_argument("--beam", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the device the programs run on (cpu for a run "
                        "without a card)")
    p.add_argument("--compiled", action="store_true",
                   help="also compile the largest bucket into an "
                        "AOTInductor package for this device and torch")
    a = p.parse_args(argv)

    from .real_time_inference import WINDOW
    from .serving import build_serving_student

    # the one model-load block of every serving surface (serving.py)
    student = build_serving_student(a.ckpt, device=a.device)
    variables = serving_variables(student)
    buckets = tuple(int(b) for b in a.buckets.split(","))
    manifest = save_bundle(
        a.out, student, variables, buckets=buckets, window=WINDOW,
        max_len=a.max_len, beam=a.beam, device=a.device)
    print(f"bundle: {a.out} ({len(manifest['programs'])} programs, "
          f"{manifest['n_params'] / 1e6:.1f}M params)")
    if a.compiled:
        top = max(buckets)  # the largest bucket, whatever the CLI order
        path = os.path.join(a.out, f"compiled_b{top}.pt2")
        save_compiled(path, student, variables, batch=top, window=WINDOW,
                      max_len=a.max_len, beam=a.beam, device=a.device)
        print(f"compiled package: {path} (tied to {a.device} and torch "
              f"{torch.__version__})")


if __name__ == "__main__":
    main()
