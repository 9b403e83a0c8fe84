"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port either.  Imports are compared by
their whole top-level name: the port's package name begins with the JAX
package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "bundle_adjustment_tpu"}
PORT = "bundle_adjustment_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


def test_there_are_files():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert PORT not in names and "benchmark" not in names


def full_imports(path: Path) -> set:
    """Every module an import statement names, dotted in full."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.update(f"{node.module}.{a.name}" for a in node.names)
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_port_bench_or_measure(path):
    """What the benchmark runs copies the port's bench and measure
    arithmetic and imports neither (the tests pin the copies)."""
    assert not {m for m in full_imports(path)
                if m.startswith((f"{PORT}.bench", f"{PORT}.measure"))}


def test_whole_names(tmp_path):
    """The port's own name is not taken for the JAX package's."""
    p = tmp_path / "scratch.py"
    p.write_text("import bundle_adjustment_tpu_torch.parallel\n"
                 "import jaxtyping\nfrom jax import numpy\n")
    assert top_level_imports(p) & FORBIDDEN == {"jax"}
