"""Time the kernels and the tBL and PSO training steps of one or more trees
of this repository on one NVIDIA GPU, in turns.

    python3 chain_bench.py                                  # this tree
    python3 chain_bench.py --trees _ab/parent . . _ab/parent

Each turn is a process of its own. It imports ptyrad_tpu_torch from its tree
(which builds that tree's kernels at first use) and chip_smoke.py from this
one, so every tree is timed on the same rows, inputs and steps:
  - chip_smoke.kernel_rows: every row of chip_smoke's kernels line (B1-B6
    with their per-position-H, dH and far-field variants, each checked
    against its plain version first), CUDA-event medians of 20 runs;
  - chip_smoke.propagation_yardstick: B6a's row and column pass
    (torch.profiler);
  - the launch guard's host cost, where the tree has ops._build.launch: us
    per call of the chain set-up query (a launcher that does no device work
    once N is set up) directly, through launch, and inside
    torch.cuda.device as every launch was before launch skipped the guard
    on the current device; and B1 and B2 through launch against the same
    wrappers with a direct, unguarded call, in alternating rounds;
  - the tBL and PSO steps: chip_smoke.profile_steps over 32 tBL and 8 PSO
    training steps on chip_smoke's simulated data (host and device ms per
    step, busy share).
It prints one JSON line per turn, then per tree the median of each number
over its turns. Needs one card; every number goes with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _host_us(fn, reps: int = 20000) -> float:
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def guard_cost(cs, dev) -> dict | None:
    """The launch guard's host cost, where the tree has _build.launch (else
    None): host us per call of the set-up query directly, through launch and
    inside torch.cuda.device; and B1 and B2 at chip_smoke's tBL shapes
    (CUDA-event medians) through launch against the same wrappers with
    launch swapped for a direct call with no guard, in 5 alternating
    rounds."""
    import torch

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import patches as P

    if not hasattr(_build, "launch") or "ptyrad_chain_prepare" not in _build.SIGNATURES:
        return None
    t = torch.empty(0, device=dev)
    fn = _build.lib().ptyrad_chain_prepare

    def in_context():
        with torch.cuda.device(t.device):
            fn(8)

    out = {"direct_us": _host_us(lambda: fn(8)),
           "launch_us": _host_us(lambda: _build.launch("ptyrad_chain_prepare", t, 8,
                                                       stream=False)),
           "device_context_us": _host_us(in_context)}

    guarded = _build.launch

    def unguarded(name, t, *args, stream=True):
        _build.check(getattr(_build.lib(), name)(
            *args, torch.cuda.current_stream(t.device).cuda_stream), name)

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, side = cs.tbl_positions()
    canvas = torch.rand((1, cs.PMODE, side, side), generator=gen, device=dev)
    pos = torch.randint(0, side - cs.NPIX + 1, (cs.BATCH, 2), generator=gen, device=dev,
                        dtype=torch.int32)
    grads = torch.randn((cs.BATCH, 1, cs.PMODE, cs.NPIX, cs.NPIX), generator=gen, device=dev)
    shape = (cs.NPIX, cs.NPIX)
    rows = {"B1": lambda: P.gather_cuda(canvas, pos, shape),
            "B2": lambda: P.scatter_add_cuda(canvas.shape, grads, pos)}
    times = {f"{k}_{form}": [] for k in rows for form in ("launch_ms", "direct_ms")}
    try:
        for _ in range(5):
            for form, impl in (("launch_ms", guarded), ("direct_ms", unguarded)):
                _build.launch = impl
                for k, f in rows.items():
                    times[f"{k}_{form}"].append(cs.time_ms(f))
    finally:
        _build.launch = guarded
    out.update({k: statistics.median(v) for k, v in times.items()})
    return out


def step_profile(cs, dev, params: dict, init: dict, path: str, niter: int, n_batches: int):
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=False)
    solver.prepare()
    solver._build()
    rec = cs.profile_steps(solver, cs.gpu_line(), path, niter, n_batches=n_batches)
    return {k: rec[k] for k in ("ms_per_step", "device_ms_per_step", "device_busy_share")}


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ptyrad_tpu_torch.device import pin_fp32
    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import chain as C

    assert C.__file__.startswith(os.path.abspath(root)), (C.__file__, root)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    pin_fp32()
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ms = {r["name"]: r["ms"] for r in cs.kernel_rows(dev, gen)}
    yard = cs.propagation_yardstick(dev, gen)
    torch.cuda.empty_cache()
    guard = guard_cost(cs, dev)

    init = cs.tbl_init()
    init["measurements"] = cs.simulate(dev, init)
    init["obj"] = np.ones_like(init["obj"])
    tbl = step_profile(cs, dev, cs.TBL_PARAMS, init, "tBL", cs.NITER + 1, 32)
    del init
    torch.cuda.empty_cache()
    pso = step_profile(cs, dev, cs.PSO_PARAMS, cs.pso_dataset(dev), "PSO", cs.PSO_NITER + 1, 8)
    return {"tree": root, "card": cs.gpu_line(), "build_s": build_s, "ms": ms,
            "pass_ms": {"row": yard["row_pass_ms"], "column": yard["column_pass_ms"]},
            "guard": guard, "tbl_step": tbl, "pso_step": pso}


def _median(values):
    values = [v for v in values if isinstance(v, (int, float))]
    return statistics.median(values) if values else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="repository trees to time, in this order (default: this one)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        import torch

        if not torch.cuda.is_available():
            print("chain_bench.py: CUDA is not available", file=sys.stderr)
            return 2
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    turns = []
    for tree in args.trees:
        root = os.path.abspath(os.path.join(HERE, tree))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                             cwd=root, capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(out.stdout[-4000:])
            return out.returncode
        line = [ln for ln in out.stdout.splitlines() if ln.startswith('{"tree"')][-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    summary = {}
    for tree in dict.fromkeys(t["tree"] for t in turns):
        mine = [t for t in turns if t["tree"] == tree]
        summary[tree] = {"turns": len(mine)}
        for group in ("ms", "pass_ms", "guard", "tbl_step", "pso_step"):
            if mine[0][group] is not None:
                summary[tree][group] = {k: _median(t[group][k] for t in mine)
                                        for k in mine[0][group]}
    print(json.dumps({"card": turns[0]["card"], "median_by_tree": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
