"""Nothing the benchmark runs imports JAX or the JAX package (names
compared whole, so ``repro_torch`` passes), and the references import
nothing of the program or of the benchmark's measuring side."""
from __future__ import annotations

import ast

import pytest

from checkout import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted((ROOT / "cxlbench").rglob("*.py"))


def imported(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((ROOT / "cxlbench" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    for name in imported(path):
        assert name.split(".")[0] != "repro_torch", name
        assert not name.startswith(("cxlbench.drivers", "cxlbench.metrics",
                                    "cxlbench.harness")), name
