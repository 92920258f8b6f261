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


@pytest.mark.parametrize("module", ["ops/resize.py", "ops/masks.py", "ops/chain.py",
                                    "constraints.py", "initialization.py", "models/state.py",
                                    "ops/affine.py", "physics/constants.py", "physics/probe.py",
                                    "utils/image_proc.py", "utils/nested.py", "utils/common.py",
                                    "load.py", "save.py", "native/__init__.py",
                                    "params/__init__.py", "params/schema.py", "optim.py",
                                    "cli.py", "__main__.py", "engine/workflow.py",
                                    "engine/solver.py", "utils/system.py", "utils/logging.py",
                                    "models/forward.py", "optim_lbfgs.py",
                                    "engine/batching.py", "engine/tuner.py",
                                    "engine/hypertune.py", "visualization.py", "losses.py"])
def test_the_measurement_and_constraint_modules_are_covered(module):
    """The modules of the far-field / measurement-store slice and the host
    modules of the params-file and saving / CLI slices are among the sources
    the import check walks, and torch, numpy, scipy and the standard
    library's os and collections are all they need, besides what
    HOST_IMPORTS lists."""
    path = PACKAGE / module
    assert path in _sources()
    roots = set(_imported_roots(path))
    allowed = {"__future__", "torch", "numpy", "scipy", "ptyrad_tpu_torch", "dataclasses",
               "typing", "functools", "math", "warnings", "os", "collections"}
    allowed |= HOST_IMPORTS.get(module, set())
    assert roots <= allowed, sorted(roots - allowed)


# what the host modules of the params-file slice import besides the above:
# the standard library, and the optional packages imported inside the
# functions that need them (test_import_pulls_in_no_optional_host_package)
HOST_IMPORTS = {
    "utils/nested.py": {"ast"},
    "utils/common.py": {"re", "sys", "datetime"},
    "load.py": {"time", "json", "importlib", "types", "tomllib", "tomli", "yaml", "h5py", "PIL"},
    "save.py": {"h5py", "PIL", "shutil", "time", "datetime"},
    "optim.py": {"re"},
    "cli.py": {"argparse", "sys", "pathlib"},
    "__main__.py": {"sys"},
    "engine/solver.py": {"inspect", "time"},
    "engine/batching.py": {"sklearn"},
    "engine/tuner.py": {"json", "random", "sqlite3", "time", "statistics", "optuna"},
    "engine/hypertune.py": {"copy", "optuna"},
    "visualization.py": {"matplotlib"},
    "utils/system.py": {"platform", "shutil", "subprocess", "sys"},
    "utils/logging.py": {"io", "logging", "sys", "datetime"},
    "native/__init__.py": {"ctypes", "subprocess"},
    "params/schema.py": {"pathlib", "pydantic"},
}


OPTIONAL = ("pydantic", "h5py", "yaml", "PIL", "sklearn", "matplotlib", "optuna")


def test_import_pulls_in_no_optional_host_package():
    """The card's machine may lack pydantic, h5py, yaml, PIL, scikit-learn
    (which compact/sparse grouping imports when asked for), matplotlib (the
    figures) and optuna (hypertune's engine when it imports): importing
    every module of the package (the CLI, the workflow, hypertune,
    visualization and utils/system.py included) loads none of them (the
    schema module, which needs pydantic, is only imported by
    load_params(validate=True))."""
    names = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                   for p in PACKAGE.rglob("*.py") if "params" not in p.relative_to(PACKAGE).parts)
    code = (
        "import sys, importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"print('LOADED', sorted(n for n in sys.modules if n.split('.')[0] in {OPTIONAL!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


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
    # the kernel library; _build/ may also hold the host .raw reader
    # (native/fastraw.c), which other tests build with the system cc
    assert not (PACKAGE / "_build").exists() or \
        not any((PACKAGE / "_build").glob("libptyrad_kernels_*.so")), \
        "importing the package must not build the kernels"
