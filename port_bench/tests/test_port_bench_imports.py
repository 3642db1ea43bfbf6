"""What the benchmark's sources import, by top-level module name compared whole
(``foley_tpu_torch`` begins with ``foley_tpu``, so a prefix test would be wrong): nothing
under ``port_bench/`` imports JAX, jaxlib, flax or the JAX package, and the reference imports
nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "foley_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imports(path: Path):
    """Every module a source imports, by its full name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def top_level_imports(path: Path):
    return {n.split(".")[0] for n in imports(path)}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing", "torch", "port_bench"}
    for name in imports(path):
        assert name.split(".")[0] != "port_bench" or name.startswith("port_bench.reference")


def test_the_whole_name_is_compared():
    assert "foley_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "foley_tpu.models".split(".")[0] in FORBIDDEN
