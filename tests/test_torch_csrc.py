"""The port's CUDA sources against their Python wrappers, from the sources
alone (no nvcc, no card): every C entry point a wrapper launches is defined
by exactly one ``extern "C"`` function, every such function is launched by
some wrapper and has its ctypes signature, and every source opens with a
note that names the JAX package's function it replaces."""

import re
from pathlib import Path

import pytest

from rtvc_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "rtvc_tpu_torch" / "csrc"
OPS = ROOT / "rtvc_tpu_torch" / "ops"
SOURCES = sorted(CSRC.glob("*.cu"))


def _entry_points() -> dict:
    """C entry point name -> the sources that define it."""
    defined = {}
    for src in SOURCES:
        for name in re.findall(r'extern\s+"C"\s+int\s+(rtvc_\w+)\s*\(',
                               src.read_text()):
            defined.setdefault(name, []).append(src.name)
    return defined


def _launched() -> dict:
    """C entry point name -> the wrapper modules that launch it."""
    launched = {}
    for mod in sorted(OPS.glob("*.py")):
        for name in re.findall(r'_kernel\.launch\(\s*"(rtvc_\w+)"',
                               mod.read_text()):
            launched.setdefault(name, []).append(mod.name)
    return launched


def test_sources_and_wrappers_are_found():
    assert len(SOURCES) >= 9
    assert len(_entry_points()) >= 9 and len(_launched()) >= 9


@pytest.mark.parametrize("name", sorted(_launched()))
def test_every_launch_has_one_c_definition(name):
    assert len(_entry_points().get(name, [])) == 1, (
        f"{name} is launched by {_launched()[name]} but defined in "
        f"{_entry_points().get(name, [])}")


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_every_c_entry_point_is_launched_and_bound(name):
    assert name in _launched(), f"{name} is launched by no wrapper"
    assert name in _build.SIGNATURES, f"{name} has no ctypes signature"


def test_every_signature_names_an_entry_point():
    assert set(_build.SIGNATURES) == set(_entry_points())


@pytest.mark.parametrize("src", SOURCES, ids=[s.name for s in SOURCES])
def test_every_source_names_the_tpu_kernel_it_replaces(src):
    """The note at the top of each source names a file of the JAX package
    and, right after it, a function that file defines."""
    lines = src.read_text().splitlines()
    note = " ".join(line[2:].strip() for line in lines[:20]
                    if line.startswith("//"))
    cited = re.findall(r"(rtvc_tpu/[\w/]+\.py)\s+(\w+)", note)
    assert cited, f"{src.name}: its note names no rtvc_tpu/ function"
    for rel, fn in cited:
        code = (ROOT / rel).read_text()
        assert re.search(rf"^\s*def\s+{fn}\(", code, re.M), (
            f"{src.name}: {rel} defines no {fn}")


@pytest.mark.parametrize("src", [s for s in SOURCES if "sm90" in s.name],
                         ids=lambda s: s.name)
def test_tensor_core_sources_say_what_bounds_them(src):
    """Each tensor-core source's note says what bounds the kernel on the
    card, with the number, and how the design answers it."""
    note = src.read_text().split("#include")[0]
    assert "What bounds it on an H100" in note
    assert re.search(r"\d+(\.\d+)? us", note), f"{src.name}: no bound in us"
    assert "Design:" in note


def test_profile_w8a8_variants_apply_to_the_k7_source():
    """``python -m rtvc_tpu_torch.profile_w8a8`` times K7 with parts of its
    epilogue cut out by text edits of the source: each edit must still
    apply exactly once."""
    from rtvc_tpu_torch import profile_w8a8
    whole = profile_w8a8.SOURCE.read_text()
    for name in profile_w8a8.VARIANTS:
        src = profile_w8a8.variant_source(name)
        assert (src == whole) == (not profile_w8a8.VARIANTS[name]), name


@pytest.mark.parametrize("name", ["layer_norm.cu", "w8_matmul.cu"])
def test_redesigned_decode_sources_say_what_bounds_them(name):
    """K2 and K3, the decode's kernels, state their bound and design as the
    tensor-core sources do."""
    note = (CSRC / name).read_text().split("#include")[0]
    assert "What bounds it on an H100" in note
    assert re.search(r"\d+(\.\d+)? us", note), f"{name}: no bound in us"
    assert "Design:" in note


def test_profile_w8_variants_apply_to_the_k3_source():
    """``python -m rtvc_tpu_torch.profile_w8`` times K3 cut apart by text
    edits of the source: each edit must still apply exactly once."""
    from rtvc_tpu_torch import profile_w8
    whole = profile_w8.SOURCE.read_text()
    for name in profile_w8.VARIANTS:
        src = profile_w8.variant_source(name)
        assert (src == whole) == (not profile_w8.VARIANTS[name]), name
