"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program; names are compared whole
by their top-level part (the port's name begins with the JAX package's)."""
import ast

import pytest

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ml_audio_restoration_tpu"}
FILES = sorted((ROOT / "benchmark").rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (ROOT / "benchmark" / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ml_audio_restoration_torch" not in top_level_imports(path)


def test_whole_name_comparison():
    """The port's top-level name is not the JAX package's."""
    assert "ml_audio_restoration_torch".split(".")[0] not in FORBIDDEN
    assert "ml_audio_restoration_tpu.ops".split(".")[0] in FORBIDDEN


def test_run_refuses_when_jax_was_loaded(monkeypatch):
    import sys
    import types

    from benchmark.harness import cell

    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert cell.forbidden_modules() == ["jax.numpy"]
