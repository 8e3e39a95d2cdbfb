"""No module of the benchmark imports JAX, flax or the JAX package, and
the reference imports nothing of the program (top-level names compared
whole: ``rtvc_tpu_torch`` begins with ``rtvc_tpu``)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "rtvc_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): top_level_imports(p) & FORBIDDEN
             for p in sources()}
    assert not {k: v for k, v in found.items() if v}
    assert len(found) > 20


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert not top_level_imports(p) & (FORBIDDEN | {"rtvc_tpu_torch"}), p


def test_the_name_check_compares_whole_names():
    from benchlib import core
    import sys
    assert "rtvc_tpu_torch" not in core.FORBIDDEN
    before = core.forbidden_modules()
    sys.modules["rtvc_tpu.fake"] = sys.modules["json"]
    try:
        assert "rtvc_tpu" in core.forbidden_modules()
    finally:
        del sys.modules["rtvc_tpu.fake"]
    assert core.forbidden_modules() == before
