"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the port: top-level names compared whole
(``repro_torch`` begins with ``repro`` but is not ``repro``)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from bench import run

BENCH = Path(__file__).resolve().parent
MODULES = sorted(BENCH.rglob("*.py"))


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "repro",
                                           "benchmarks"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert not _top_level_imports(path) & {"repro_torch", "repro", "bench"}


def test_forbidden_by_whole_top_level_name(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("x"))
    assert "repro_torch_probe" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert "repro.core" in run.loaded_forbidden()
