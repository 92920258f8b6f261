"""The port's spans (ptyrad_tpu_torch/utils/tracing.py): a profiled
iteration of a small solver holds every span PERF.md §3 documents, nested
as documented; with no profiler recording no span constructs a
record_function and the host table counts and times each one; the flag the
spans test is the one the profilers set; set-up's spans are recorded once.
"""

import copy
import json
import re
import time
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from ptyrad_tpu_torch.constraints import _ORDER, _SPANS
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.ops import _build
from ptyrad_tpu_torch.utils import tracing
from torch_port_helpers import ROOT, small_dataset, small_params

PACKAGE = ROOT / "ptyrad_tpu_torch"
MODEL = tuple(f"ptyrad.model.{p}" for p in ("patches", "probe", "propagators", "measurements",
                                           "multislice", "loss"))
# each span and the span it opens inside (set-up's open outside any)
PARENT = {
    "ptyrad.iter.batches": "ptyrad.iter",
    "ptyrad.step": "ptyrad.iter",
    "ptyrad.iter.table": "ptyrad.iter",
    "ptyrad.iter.constraints": "ptyrad.iter",
    "ptyrad.iter.end": "ptyrad.iter",
    "ptyrad.step.loss": "ptyrad.step",
    "ptyrad.step.backward": "ptyrad.step",
    "ptyrad.step.optimizer": "ptyrad.step",
    **{name: "ptyrad.step.loss" for name in MODEL},
}
# the fused route (loss_single and loss_sparse: fused_loss_terms) and forward()
# with combined_loss (loss_poissn turns the folded loss off)
LOSSES = {
    "fused": None,
    "forward": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
                "loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6}},
}


@pytest.fixture(scope="module")
def dataset():
    return small_dataset()


def solver_of(dataset, loss=None):
    params = small_params({"name": "Adam"}, niter=1)
    if loss is not None:
        params["loss_params"] = copy.deepcopy(loss)
    return PtyRADSolver(params, init_variables=copy.deepcopy(dataset), device="cpu",
                        verbose=False)


def span_literals() -> set:
    """Every name passed to span() as a string literal in the package."""
    found = set()
    for path in PACKAGE.rglob("*.py"):
        found |= set(re.findall(r'\bspan\(\s*"([^"]+)"', path.read_text()))
    return found


@pytest.mark.parametrize("route", sorted(LOSSES))
def test_profiled_iteration_exports_every_span_nested(dataset, route, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver = solver_of(dataset, LOSSES[route])
        solver.reconstruct()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("ptyrad.")]
    names = {e["name"] for e in ranges}
    constraints = {_SPANS[name] for name in solver.constraint_fn.active_names}
    # ptyrad.setup.kernels opens only where the CUDA kernel library loads
    expected = (set(PARENT) | constraints | {"ptyrad.iter", "ptyrad.setup.optimizer"})
    assert names == expected
    n_batches = solver.batch_idx.shape[0]
    counts = {name: sum(e["name"] == name for e in ranges) for name in names}
    assert counts["ptyrad.iter"] == 1 and counts["ptyrad.setup.optimizer"] == 1
    assert counts["ptyrad.step"] == counts["ptyrad.step.backward"] == n_batches

    def inside(child, parent_name):
        return any(p["name"] == parent_name and p["tid"] == child["tid"]
                   and p["ts"] <= child["ts"]
                   and child["ts"] + child["dur"] <= p["ts"] + p["dur"] for p in ranges)
    parent = {**PARENT, **{name: "ptyrad.iter.constraints" for name in constraints}}
    for e in ranges:
        if e["name"] in parent:
            assert inside(e, parent[e["name"]]), (e["name"], parent[e["name"]])


def test_no_profiler_no_record_function(dataset, monkeypatch):
    """With no profiler recording, neither a span nor the spans of a whole
    iteration of the solver construct a record_function (torch's own
    optimizer still opens its ranges), and the table counts and times
    every span."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function constructed with no profiler recording")
    monkeypatch.setattr(tracing, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    tracing.reset()
    for _ in range(2):
        with tracing.span("test.outer"):
            with tracing.span("test.inner"):
                time.sleep(0.002)
    totals = tracing.totals()
    assert totals["test.outer"][0] == totals["test.inner"][0] == 2
    assert totals["test.outer"][1] >= totals["test.inner"][1] >= 0.004
    tracing.reset()
    assert tracing.totals() == {}

    solver = solver_of(dataset)
    solver.reconstruct()
    totals = tracing.totals()
    n_batches = solver.batch_idx.shape[0]
    assert totals["ptyrad.iter"][0] == 1
    assert totals["ptyrad.step"][0] == totals["ptyrad.step.loss"][0] == n_batches
    assert totals["ptyrad.iter"][1] >= totals["ptyrad.step"][1] > 0
    tracing.reset()


def test_profiler_flag_is_set_by_the_profilers(monkeypatch):
    """The module flag the spans test exists, and profile() and emit_nvtx()
    set it. On a host without CUDA, emit_nvtx's synchronise and its
    profiler switch (CUDA-only) are stubbed: the flag is set around them."""
    assert autograd_profiler._is_profiler_enabled is False
    opened = []

    class Recorder:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False
    if not torch.cuda.is_available():
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(autograd_profiler, "_enable_profiler", lambda *a, **k: None)
        monkeypatch.setattr(autograd_profiler, "_disable_profiler", lambda *a, **k: None)
    monkeypatch.setattr(tracing, "record_function", Recorder)
    with autograd_profiler.emit_nvtx():
        assert autograd_profiler._is_profiler_enabled is True
        with tracing.span("test.nvtx"):
            pass
    assert autograd_profiler._is_profiler_enabled is False
    assert opened == ["test.nvtx"]


def test_every_span_is_documented():
    """Every span name in the package is one PERF.md documents (with the
    metric that reads it), the constraints' as ptyrad.constraint.<name>."""
    perf = (ROOT / "PERF.md").read_text()
    literals = span_literals()
    assert literals >= set(PARENT) | {"ptyrad.iter", "ptyrad.setup.optimizer",
                                      "ptyrad.setup.kernels"}
    for name in literals:
        assert f"`{name}`" in perf, name
    assert "`ptyrad.constraint.<name>`" in perf
    assert _SPANS == {name: f"ptyrad.constraint.{name}" for name in _ORDER}


def test_building_the_solver_records_the_optimizer_once(dataset):
    tracing.reset()
    solver = solver_of(dataset)
    solver.prepare()
    solver._build()
    count, seconds = tracing.totals()["ptyrad.setup.optimizer"]
    assert count == 1 and seconds > 0
    tracing.reset()


class FakeLibrary:
    """Stands for a loaded library: every entry point is an object that
    takes argtypes and restype."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


@pytest.mark.parametrize("loader", ["lib", "mixed_lib"])
def test_kernel_load_is_a_span_on_the_loading_call_only(loader, monkeypatch):
    """lib() and mixed_lib() open ptyrad.setup.kernels on the call that
    loads a library, and not on the calls that find it loaded (the build
    and the load are stubbed: this host has no nvcc)."""
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_MIXED", {})
    monkeypatch.setattr(_build, "build", lambda *a, **k: Path("libfake.so"))
    monkeypatch.setattr(_build, "_mixed_path", lambda n, bf16=False: Path(__file__))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLibrary)
    load = _build.lib if loader == "lib" else (lambda: _build.mixed_lib(120))
    tracing.reset()
    first = load()
    assert load() is first
    assert tracing.totals()["ptyrad.setup.kernels"][0] == 1
    tracing.reset()
