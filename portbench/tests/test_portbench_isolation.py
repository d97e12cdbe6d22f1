"""No file of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: an AST scan of every
Python file under portbench/, each import's top-level name compared
whole (the program's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vqa_project_tpu"}
PROGRAM = "vqa_project_tpu_torch"


def imported(path: Path):
    """Top-level names of every import in ``path``, with their lines;
    importlib's dynamic imports of a literal name count too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


FILES = sorted(BENCH.rglob("*.py"))


def test_the_scan_sees_the_benchmark():
    names = {p.relative_to(BENCH).as_posix() for p in FILES}
    assert {"run.py", "reference/model.py", "drivers/train.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_anywhere(path):
    bad = [(n, line) for n, line in imported(path) if n in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    names = list(imported(path))
    assert all(n != PROGRAM for n, _ in names), f"{path}: {names}"
    # nor the harness, which drives the program: only the reference's
    # own modules of the benchmark
    own = [(n, line) for n, line in imported(path) if n == "portbench"]
    src = path.read_text()
    for _, line in own:
        assert "portbench.reference" in src.splitlines()[line - 1]


def test_whole_names_are_compared():
    # the program's top-level name is not the JAX package's
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "vqa_project_tpu" in FORBIDDEN
