"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level name, whole: ``hypre_tpu_torch`` is not ``hypre_tpu``."""

import ast
import sys
import types

import pytest
import run
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "hypre_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"hypre_tpu_torch", "harness", "run"})
    assert names <= {"__future__", "json", "math", "pathlib", "torch",
                     "reference"}


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    for name in ("hypre_tpu_torch", "hypre_tpu_torch.amg", "hypre_tpuish"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "hypre_tpu", raising=False)
    assert "hypre_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hypre_tpu.amg",
                        types.ModuleType("hypre_tpu.amg"))
    assert "hypre_tpu" in run.forbidden_modules()
