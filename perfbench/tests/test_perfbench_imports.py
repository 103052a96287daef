"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the references import nothing of the program, and a run refuses to
report once either is loaded."""

import ast
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness
from .conftest import ROOT

BENCH = ROOT / "perfbench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def imported(path: Path) -> list[str]:
    """Top-level names of every absolute import in a file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append((node.module or "").split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            names += [str(a.value).split(".")[0] for a in node.args
                      if isinstance(a, ast.Constant)]
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT))
                                             for p in FILES])
def test_no_jax(path):
    bad = set(imported(path)) & {"jax", "jaxlib", "flax", "embeddings_tpu"}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "embeddings_tpu_torch" not in names
    assert set(names) <= {"__future__", "math", "torch"}, names


def test_only_the_adapter_imports_the_port():
    users = [p.name for p in FILES if "embeddings_tpu_torch" in imported(p)]
    assert users == ["program.py"]


def test_a_loaded_jax_is_found(monkeypatch):
    assert "embeddings_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "embeddings_tpu.models",
                        types.ModuleType("embeddings_tpu.models"))
    assert harness.forbidden_modules() == ["embeddings_tpu"]
    monkeypatch.delitem(sys.modules, "embeddings_tpu.models")
    monkeypatch.setitem(sys.modules, "embeddings_tpu_torch_x",
                        types.ModuleType("embeddings_tpu_torch_x"))
    assert harness.forbidden_modules() == []
