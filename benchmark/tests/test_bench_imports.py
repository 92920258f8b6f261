"""What the benchmark imports: the reference nothing of the program or of
JAX, the harness no JAX, and the run's check finds a loaded JAX module."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "optax", "flax", "ptyrad_tpu"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & (JAX | {"ptyrad_tpu_torch"})


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_benchmark_imports_no_jax(path):
    assert not imported_tops(path) & JAX


def test_run_finds_a_loaded_jax_module(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "ptyrad_tpu_torch_like", object())
    assert "jaxlib" in run.forbidden_modules()
    assert "ptyrad_tpu_torch_like" not in run.forbidden_modules()
