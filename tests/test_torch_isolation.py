"""ptyrad_tpu_torch stands alone: it imports neither jax nor ptyrad_tpu (not
even ptyrad_tpu's NumPy-only modules), chip_smoke.py neither, and the package
imports without a CUDA compiler (kernels are built at first CUDA use)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "ptyrad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ptyrad_tpu", "optax", "flax")


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_reference_package(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_no_jax_and_needs_no_nvcc(tmp_path):
    """Import every module of the package in a fresh interpreter whose PATH
    holds no CUDA toolkit, then list what got loaded."""
    code = (
        "import sys, importlib, pkgutil, ptyrad_tpu_torch\n"
        "for m in pkgutil.walk_packages(ptyrad_tpu_torch.__path__, 'ptyrad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "import shutil; print('NVCC', shutil.which('nvcc'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "PYTHONPATH")}
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + "/usr/bin:/bin"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "NVCC None" in out.stdout, out.stdout
    assert not (PACKAGE / "_build").exists() or not any((PACKAGE / "_build").glob("*.so")), \
        "importing the package must not build the kernels"
