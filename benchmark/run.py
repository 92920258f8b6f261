"""Run one cell of the benchmark of ptyrad_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the cell's inputs from the seed on the card (benchmark/data.py),
builds the solver as PtyRADSolver.reconstruct builds one (the constructor,
prepare, _build), drives it through its first three steps, one batch an
iteration through recon_loop with the constraints at each iteration's end,
numbered from the latest start iteration that the configuration gives a
learning rate (so that every leaf the window trains is live in them), and
reads what the comparison needs from it; then one whole iteration warms up
every shape. The window calls recon_loop over the solver's whole feed, one
iteration a call with start_niter advancing, until ``--seconds`` have
passed; the last iteration that began before then runs to its end. With
``--trace 1`` the profiler records one whole iteration in place of the
window, and the per-layer metrics are read from its trace. After the window
the peak device memory is read, the solver freed, and the plain reference
(benchmark/reference/) follows the same three steps from the same inputs;
``correct`` holds when each of the comparison's numbers is within its limit
(benchmark/limits/<cell>.json).

The last line of standard output is one JSON object; the numbers compared,
with their limits, are the last lines of standard error and the last key of
that object. A run on a machine without the CUDA devices the cell asks for,
or that finds JAX or the JAX package loaded, exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here, before torch loads

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import data, work  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference.model import Reference, probe_change, probe_readings  # noqa: E402
from benchmark.spec import Spec  # noqa: E402
from benchmark.trace import CONSTRAINTS, WINDOW, Trace  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "ptyrad_tpu"})
CHECK_STEPS = 3
GIB = float(2 ** 30)
VARIANTS = ("program", "bf16", "half_batch", "no_step")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def norm(x: torch.Tensor) -> float:
    """The 2-norm summed in float64: a float32 sum over tens of millions of
    elements drifts by parts in a thousand."""
    return float(torch.linalg.vector_norm(x.to(torch.complex128 if x.is_complex()
                                                else torch.float64)))


def first_niter(params: dict) -> int:
    """The latest start iteration of a tensor with a learning rate: from
    there on every leaf that the window trains is live."""
    ups = (params.get("model_params") or {}).get("update_params") or {}
    return max([1] + [int(u["start_iter"]) for u in ups.values()
                      if u and u.get("lr") and u.get("start_iter") is not None])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def plant(solver, variant: str) -> None:
    """The control and the faults that the comparison must catch:
    ``bf16`` is set in the params (the program's bfloat16 policy);
    ``half_batch`` leaves out the second half of every batch, the mean
    taken over the rest; ``no_step`` steps without changing any state."""
    if variant == "half_batch":
        share, loss = solver.share, solver.share.loss

        def half(idx, mask, loss_params, plan=None):
            keep = torch.ones_like(mask)
            keep[mask.shape[0] // 2:] = 0
            return loss(idx, mask * keep, loss_params, plan)
        share.loss = half
    elif variant == "no_step":
        solver.optimizer.step = lambda *args, **kwargs: None


class Run:
    """One run of a cell: set-up, the window, the comparison."""

    def __init__(self, spec: Spec, cell: str, seed: int, device, variant: str = "program"):
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}; one of {VARIANTS}")
        self.spec, self.name, self.seed = spec, cell, int(seed)
        self.dev = torch.device(device)
        self.entry = spec.cell(cell)
        self.config = spec.config(self.entry["config"])
        self.traffic = spec.traffic(self.entry["traffic"])
        self.variant = variant
        self.spans = {}

    # -- set-up --------------------------------------------------------------

    def setup(self, warm: bool = True) -> None:
        """Inputs, solver, the first steps and (``warm``) the warm-up
        iteration."""
        from ptyrad_tpu_torch.engine.solver import PtyRADSolver, iter_batch_perm

        torch.backends.cuda.matmul.allow_tf32 = False  # the configuration is float32
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(1)  # one host thread: the loop's pace shares the host
        t = time.perf_counter()
        self.params, self.init = data.make_inputs(self.config, self.traffic, self.seed, self.dev)
        if self.variant == "bf16":
            self.params["model_params"]["compute_dtype"] = "bfloat16"
        _sync(self.dev)
        self.spans["inputs_s"] = time.perf_counter() - t
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        t = time.perf_counter()
        solver = PtyRADSolver(self.params, init_variables=self.init, device=self.dev,
                              verbose=False)
        solver.prepare()
        solver._build()
        _sync(self.dev)
        self.spans["solver_init_s"] = time.perf_counter() - t
        plant(solver, self.variant)
        self.solver = solver
        order = iter_batch_perm(1, solver.batch_idx.shape[0])[:CHECK_STEPS]
        self.batches = [(solver.batch_idx[b], solver.batch_mask[b]) for b in order]
        self.first = first_niter(self.params)
        t = time.perf_counter()
        self.prog = self.first_steps()
        self.spans["first_steps_s"] = time.perf_counter() - t
        self.next_niter = self.first + CHECK_STEPS
        if warm:
            t = time.perf_counter()
            self.iteration(self.next_niter)
            self.next_niter += 1
            self.spans["warmup_s"] = time.perf_counter() - t

    def iteration(self, niter: int, constraint_fn=None) -> None:
        from ptyrad_tpu_torch.engine.solver import recon_loop

        s = self.solver
        recon_loop(s.train_epoch, s.params, s.batch_idx, s.batch_mask, 1,
                   constraint_fn or s.constraint_fn, s.buffers, history=s.history,
                   verbose=False, optimizer=s.optimizer, start_niter=niter)

    def first_steps(self) -> dict:
        """The program's first CHECK_STEPS steps, each an iteration of one
        batch through recon_loop numbered from ``self.first``: each step's
        loss, Adam's first moment after step 1 as the gradient it got, each
        leaf's change after the last, and the probe's change by
        ``probe_readings``."""
        from ptyrad_tpu_torch.engine.solver import recon_loop

        s = self.solver
        groups = [(g["name"], g["params"][0], g) for g in s.optimizer.param_groups]
        before = {name: p.detach().to("cpu", copy=True) for name, p, _ in groups}
        probe0 = probe_readings(s.params.probe)
        losses, grad1 = [], {}
        for k, (idx, mask) in enumerate(self.batches, start=1):
            recon_loop(s.train_epoch, s.params, idx[None], mask[None], 1, s.constraint_fn,
                       s.buffers, history=s.history, verbose=False, optimizer=s.optimizer,
                       start_niter=self.first + k - 1)
            losses.append(float(s.history.loss_iters[-1][1]) if len(s.history.loss_iters) == k
                          else math.nan)
            if k == 1:
                for name, p, g in groups:
                    m = s.optimizer.state.get(p, {}).get("exp_avg")
                    grad1[name] = (0.0 if m is None else
                                   norm(m) / (1.0 - g["betas"][0]))
        change = {name: norm(p.detach().cpu() - before[name]) for name, p, _ in groups}
        return {"losses": losses, "grad1": grad1, "change": change,
                "probe": probe_change(probe0, probe_readings(s.params.probe))}

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        s, dev = self.solver, self.dev
        marks = []

        def mark(*_):
            if dev.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            else:
                marks.append(time.perf_counter())
        handle = s.optimizer.register_step_post_hook(mark)
        iters = 0
        _sync(dev)
        t0 = time.perf_counter()
        self.spans["setup_s"] = t0 - T_START
        mark()
        while True:
            self.iteration(self.next_niter)
            self.next_niter += 1
            iters += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)  # recon_loop synchronised already
        t1 = time.perf_counter()
        handle.remove()
        if dev.type == "cuda":
            steps_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        real = float(s.batch_mask.sum())
        bad = sum(not math.isfinite(v) for _, v in s.history.loss_iters[-iters:])
        self.spans["window_iter_s"] = s.history.iter_times[-iters:]
        if steps_ms:  # the steps' tail, recorded beside the metrics
            self.spans["step_ms_p95"] = float(np.percentile(steps_ms, 95))
        return {"iters": iters, "seconds": t1 - t0,
                "patterns": real * iters, "steps": iters * s.batch_idx.shape[0],
                "failed": bad * s.batch_idx.shape[0]}

    def traced(self) -> dict:
        """One whole iteration under torch.profiler, its trace reduced."""
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        s = self.solver

        def constrain(params, buffers, niter):
            with record_function(CONSTRAINTS):
                return s.constraint_fn(params, buffers, niter)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                self.iteration(self.next_niter, constrain)
                self.next_niter += 1
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = Trace(path)
        finally:
            os.remove(path)
        return {"trace": tr, "iters": 1, "steps": s.batch_idx.shape[0]}

    def shape(self) -> dict:
        """The cell's shapes for benchmark/work, from the benchmark's own
        inputs and the solver's batches."""
        s, init = self.solver, self.init
        n = int(init["probe"].shape[-1])
        obj = init["obj"]
        lr = (self.params["model_params"].get("update_params", {})
              .get("probe_pos_shifts", {}) or {}).get("lr", 0)
        b = int(s.batch_idx.shape[1])
        h, w = obj.shape[-2:]
        corners = np.clip(np.asarray(init["crop_pos"]), 0, [h - n, w - n])
        covered = []
        for idx in s.batch_idx:
            hit = np.zeros((h, w), bool)
            for y, x in corners[idx]:
                hit[y:y + n, x:x + n] = True
            covered.append(int(hit.sum()))
        return {"B": b, "pmode": int(init["probe"].shape[0]), "omode": int(obj.shape[0]),
                "nz": int(obj.shape[1]), "n": n, "probe_b": b if lr else 1, "h_b": 1,
                "shift_probes": bool(lr), "covered": float(np.mean(covered))}

    # -- the comparison --------------------------------------------------------

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.__dict__.pop("solver", None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> tuple[bool, dict, dict]:
        t = time.perf_counter()
        ref = Reference(self.init, self.params, self.dev, self.config["ref_block"])
        readings = ref.run_steps(self.batches, self.first)
        del ref
        self.spans["reference_s"] = time.perf_counter() - t
        gauge_free = (("probe",) if (self.params.get("constraint_params") or {})
                      .get("ortho_pmode", {}).get("freq") else ())
        numbers = compare.gaps(self.prog, readings, gauge_free)
        ok, checks = compare.verdict(numbers, self.spec.limits(self.name))
        finite = all(math.isfinite(v) for v in self.prog["losses"])
        return ok and finite, checks, {"numbers": numbers, "program": self.prog,
                                       "reference": readings,
                                       "leaf_change_gaps": compare.leaf_gaps(self.prog, readings)}


class Records:
    """What a per-layer metric reads: the trace of the traced iterations,
    their steps and iterations, the cell's shapes, the host spans of
    set-up, and each kernel layer's matching kernels."""

    def __init__(self, spec: Spec, traced: dict, shape: dict, spans: dict):
        self.spec, self.trace = spec, traced["trace"]
        self.steps, self.iters = traced["steps"], traced["iters"]
        self.shape, self.spans = shape, spans
        self.work = work

    def layer_kernels(self, layer: str) -> list:
        return self.trace.matching(self.spec.layer_patterns(layer))


def device_info(dev: torch.device, count: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": peak}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             variant: str = "program", spec: Spec | None = None) -> dict:
    """One run; returns the result object (its ``checks`` last)."""
    spec = spec or Spec()
    run = Run(spec, cell, seed, device, variant)
    run.setup()
    dev = run.dev
    metrics, extra = {}, {}
    if trace:
        traced = run.traced()
        rec = Records(spec, traced, run.shape(), run.spans)
        for m in spec.per_layer(cell):
            value = spec.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": traced["trace"].busy_s, "window_s": traced["trace"].window_s}
        attempted, failed = traced["steps"], 0
        breakdown = traced["trace"].breakdown()
    else:
        win = run.window(seconds)
        values = {
            "patterns_per_s": win["patterns"] / win["seconds"],
            "setup_s": run.spans["setup_s"],
        }
        attempted, failed = win["steps"], win["failed"]
        run.spans.update(window_iters=win["iters"], window_s=win["seconds"])
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    if not trace:
        values["peak_mem_gib"] = peak / GIB
        for m in spec.end_to_end(cell):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    run.free()
    correct, checks, readings = run.compare()
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {**device_info(dev, 1, peak), **extra}}
    if trace:
        result["breakdown"] = breakdown
    result["spans"] = run.spans
    result["readings"] = readings
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec()
    chips = int(spec.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      spec=spec)
    loaded = forbidden_modules()
    if loaded:
        print(f"error: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    print(json.dumps({k: v for k, v in result.items() if k != "checks"}, default=float),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {k: v for k, v in result.items() if k not in ("readings", "spans", "checks")}
    out["checks"] = result["checks"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
