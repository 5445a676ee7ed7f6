"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
plain reference and the input makers import nothing of the program
(top-level module names compared whole: ``tomojax_torch`` is not
``tomojax``)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in
                                  ("reference", "inputs")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_inputs_import_nothing_of_the_program(path):
    assert "tomojax_torch" not in top_level_imports(path)


def test_the_scan_sees_whole_names():
    p = BENCH / "tests" / "test_bench_imports.py"
    assert "tomojax_torch" not in harness.FORBIDDEN
    assert top_level_imports(p) >= {"ast", "pytest", "benchmark"}


def test_a_run_loads_no_jax():
    """In a fresh interpreter: a run of a cell leaves no JAX module
    loaded."""
    code = ("import torch; from benchmark.tests.conftest import run_tiny; "
            "from benchmark import harness; run_tiny('c5.cgls'); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
