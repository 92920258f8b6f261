"""Time the kernels and the tBL and PSO training steps of one or more trees
of this repository on one NVIDIA GPU, in turns.

    python3 chain_bench.py                                  # this tree
    python3 chain_bench.py --trees _ab/parent . . _ab/parent
    python3 chain_bench.py --trees _ab/old . . _ab/old --atomic-b2 _ab/old
    python3 chain_bench.py --trees _ab/parent . . _ab/parent --atomic-b3 _ab/parent \
        --checks check_loss_chain check_dp_chain check_fused_dh --steps tBL
    python3 chain_bench.py --trees _ab/parent . . _ab/parent --checks check_chain_npo2 \
        --steps --mixed-n 96 120 127 192 384
    python3 chain_bench.py --trees _ab/parent . . _ab/parent --checks check_chain_npo2 \
        --steps --chain-n 130 136 176 495
    python3 chain_bench.py --trees _ab/parent . . _ab/parent --checks check_fused_npo2 \
        --steps --fused-n 110 117 121 122 124 127

Each turn is a process of its own. It imports ptyrad_tpu_torch from its tree
(which builds that tree's kernels at first use) and chip_smoke.py from this
one, so every tree is timed on the same rows, inputs and steps:
  - chip_smoke.kernel_rows: every row of chip_smoke's kernels line (B1-B6
    with their per-position-H, dH and far-field variants, B1/B2 at the tBL
    and PSO shapes, each checked against its plain version first; with
    --checks, only the rows of the named chip_smoke checks, and then no
    propagation or launch-guard rows),
    CUDA-event medians of 20 runs, or for B1/B2 and any row under 0.1 ms
    the device time per launch of a run of 100 (chip_smoke.run_ms); B1/B2's
    host us per call and the pair launch (obja and objp at once); a tree
    named in --atomic-b2 is one from before the pair launch, whose B2 summed
    with atomics: its B2 is held at rtol 1e-5 and it has no pair rows; a
    tree named in --atomic-b3 is one from before B3b/B4b's fixed-order
    reduce, whose repeat check is reported but not required; with
    --chain-n N ..., check_chain_npo2's rows at those N in place of
    chip_smoke's, each at PSO's widths (B 32, 4 modes, 21 slices: B6 over
    2 x 8, B5 over the 5-slice tail; no _bf16 rows), their libraries built
    beside the main one, and each tree's plan at each N (its line type);
    with --fused-n N ..., check_fused_npo2's rows (B3a, B3b, B3b with dH,
    B4a, B4b) at those N in place of chip_smoke's, each at PSO's widths (B
    32, 4 modes, 21 slices; no _bf16 rows), likewise;
  - chip_smoke.propagation_yardstick: B6a's row and column pass
    (torch.profiler);
  - the launch guard's host cost, where the tree has ops._build.launch: us
    per call of the chain set-up query (a launcher that does no device work
    once N is set up) directly, through launch, and inside
    torch.cuda.device as every launch was before launch skipped the guard
    on the current device; and B1 and B2's host us per call through launch
    against the same wrappers with a direct, unguarded call, in
    alternating rounds;
  - the tBL and PSO steps (those named in --steps): chip_smoke.profile_steps
    over 32 tBL and 8 PSO training steps on chip_smoke's simulated data (host and device ms per
    step, busy share, and B1's, B2's and the memsets' device ms per step).
It prints one JSON line per turn, then per tree the median of each number
over its turns, with the smallest and largest of each step number. With
more than one tree (and no --checks, or with --mixed-n) it then compiles
every tree's csrc/*.cu as the build does, and with --mixed-n N ... the
generated sources of its mixed-radix libraries at those N (each tree's own
plans), and compares the kernels' machine code (cuobjdump -sass) with the
first tree's, kernel by kernel, with the SASS instruction classes (opcode
before its first dot) of each kernel that differs, in both trees. Needs one
card; every number goes with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
    (host us per call, chip_smoke.host_us) through launch against the same
    wrappers with launch swapped for a direct call with no guard, in 5
    alternating rounds."""
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
    times = {f"{k}_{form}": [] for k in rows for form in ("launch_us", "direct_us")}
    try:
        for _ in range(5):
            for form, impl in (("launch_us", guarded), ("direct_us", unguarded)):
                _build.launch = impl
                for k, f in rows.items():
                    times[f"{k}_{form}"].append(cs.host_us(f))
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
    out = {k: rec[k] for k in ("ms_per_step", "device_ms_per_step", "device_busy_share")}
    out.update({f"{k}_device_ms": v for k, v in rec["patches_device_ms_per_step"].items()})
    return out


def worker(root: str, atomic_b2: bool, atomic_b3: bool, checks, steps, chain_n=(),
           fused_n=()) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ptyrad_tpu_torch.device import pin_fp32
    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import chain_plan as CP
    from ptyrad_tpu_torch.ops import fused_plan as FP

    assert C.__file__.startswith(os.path.abspath(root)), (C.__file__, root)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    pin_fp32()
    t0 = time.perf_counter()
    _build.build(extra_n=tuple(chain_n) + tuple(fused_n))
    _build.lib()
    build_s = time.perf_counter() - t0
    plans = {}
    if chain_n:
        cs.CHAIN_NS = tuple(chain_n)
        pso = cs.chain_npo2_case(cs.PSO_N192)
        cs.chain_npo2_case = lambda n: {**pso, "note": f"PSO widths at {n}^2"}
        plans = {n: next(ln for ln in CP.plan_source(n).splitlines() if "MIXED_LINE" in ln)
                 for n in chain_n}
    if fused_n:
        cs.FUSED_ROWS = tuple((n, "PSO", f"N={n}") for n in fused_n)
        cs.FUSED_BF16_ROWS = ()
        plans.update({n: next(ln for ln in FP.plan_source(n).splitlines() if "MIXED_LINE" in ln)
                      for n in fused_n})
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    all_rows = checks is None
    rows = cs.kernel_rows(dev, gen, atomic_b2, atomic_b3, checks or cs.KERNEL_CHECKS)
    ms = {r["name"]: r["ms"] for r in rows}
    extra = {key: {r["name"]: r[key] for r in rows if key in r}
             for key in ("host_us", "pair_ms", "plain_ms")}
    pass_ms = guard = tbl = pso = None
    if all_rows:
        yard = cs.propagation_yardstick(dev, gen)
        pass_ms = {"row": yard["row_pass_ms"], "column": yard["column_pass_ms"]}
        torch.cuda.empty_cache()
        guard = guard_cost(cs, dev)
    if "tBL" in steps:
        init = cs.tbl_init()
        init["measurements"] = cs.simulate(dev, init)
        init["obj"] = np.ones_like(init["obj"])
        tbl = step_profile(cs, dev, cs.TBL_PARAMS, init, "tBL", cs.NITER + 1, 32)
        del init
        torch.cuda.empty_cache()
    if "PSO" in steps:
        pso = step_profile(cs, dev, cs.PSO_PARAMS, cs.pso_dataset(dev), "PSO", cs.PSO_NITER + 1,
                           8)
    return {"tree": root, "card": cs.gpu_line(), "build_s": build_s, "plans": plans, "ms": ms,
            **extra, "pass_ms": pass_ms, "guard": guard, "tbl_step": tbl, "pso_step": pso}


def _median(values):
    values = [v for v in values if isinstance(v, (int, float))]
    return statistics.median(values) if values else None


def sass_classes(sass: str) -> dict:
    """Count of each SASS instruction class (opcode before its first dot)."""
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass)
    return dict(collections.Counter(ops).most_common())


def mixed_sources(root: str, mixed_n) -> dict:
    """{file name: text} of the generated sources of a tree's mixed-radix
    libraries at each N of mixed_n (its own ops/_build._mixed_sources, read
    in a process of that tree)."""
    if not mixed_n:
        return {}
    code = ("import json, sys; from ptyrad_tpu_torch.ops import _build; "
            "print(json.dumps({k: v for n in map(int, sys.argv[1:]) "
            "for k, v in _build._mixed_sources(n).items()}))")
    out = subprocess.run([sys.executable, "-c", code, *map(str, mixed_n)], cwd=root,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": root})
    return json.loads(out.stdout)


def machine_code(root: str, mixed_n=()) -> dict:
    """{source: {kernel: SASS}} of a tree's csrc/*.cu and of its mixed-radix
    libraries' generated sources at mixed_n, each compiled by its own nvcc
    with the build's flags (in parallel) and read back with cuobjdump; the
    per-file hash in the anonymous namespace's names is cut out, so that
    two trees' kernels pair up by name."""
    from ptyrad_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    csrc = os.path.join(root, "ptyrad_tpu_torch", "csrc")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(csrc, name) for name in sorted(os.listdir(csrc))
                 if name.endswith(".cu")}
        for name, text in mixed_sources(root, mixed_n).items():
            paths[name] = os.path.join(tmp, name)
            with open(paths[name], "w", encoding="utf-8") as f:
                f.write(text)
        procs = {name: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-c", path,
                                         "-o", os.path.join(tmp, name + ".o")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for name, path in paths.items()}
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {root}: {name}\n{log}")
            sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                                   os.path.join(tmp, name + ".o")],
                                  capture_output=True, text=True, check=True).stdout
            kernels = {}
            for chunk in re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", sass).split("Function : ")[1:]:
                head, _, body = chunk.partition("\n")
                kernels[head.strip()] = body
            out[name] = kernels
    return out


def compare_machine_code(roots: list, mixed_n=()) -> dict:
    """Per later tree and source (csrc/*.cu, and the mixed-radix libraries'
    generated sources at mixed_n): how many of its kernels have the first
    tree's machine code, the names of those that do not, and the SASS
    classes of those and of the first tree's kernels that have no twin."""
    codes = [machine_code(root, mixed_n) for root in roots]
    report = {}
    for root, code in zip(roots[1:], codes[1:]):
        report[root] = {}
        for name, kernels in code.items():
            first = codes[0].get(name, {})
            differ = sorted(k for k in kernels if first.get(k) != kernels[k])
            report[root][name] = {
                "kernels": len(kernels), "identical": len(kernels) - len(differ),
                "differ": differ, "only_in_first": len(set(first) - set(kernels)),
                "classes": {"this": {k: sass_classes(kernels[k]) for k in differ},
                            "first": {k: sass_classes(v) for k, v in first.items()
                                      if k in differ or k not in kernels}}}
    return report


def _spread(values):
    values = [v for v in values if isinstance(v, (int, float))]
    return [min(values), max(values)] if values else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="repository trees to time, in this order (default: this one)")
    ap.add_argument("--atomic-b2", nargs="+", default=[], metavar="TREE",
                    help="trees from before the pair launch, whose B2 sums with atomics")
    ap.add_argument("--atomic-b3", nargs="+", default=[], metavar="TREE",
                    help="trees from before B3b/B4b's fixed-order reduce (atomics)")
    ap.add_argument("--checks", nargs="+", default=None, metavar="CHECK",
                    help="only these chip_smoke kernel checks (default: every row)")
    ap.add_argument("--steps", nargs="*", default=["tBL", "PSO"], choices=["tBL", "PSO"],
                    help="training steps to profile (default: both)")
    ap.add_argument("--mixed-n", nargs="+", type=int, default=[], metavar="N",
                    help="also compare the machine code of the mixed-radix libraries at these N "
                         "(then even with --checks)")
    ap.add_argument("--chain-n", nargs="+", type=int, default=[], metavar="N",
                    help="time check_chain_npo2's rows at these N (PSO widths) in place of "
                         "chip_smoke's")
    ap.add_argument("--fused-n", nargs="+", type=int, default=[], metavar="N",
                    help="time check_fused_npo2's rows at these N (PSO widths) in place of "
                         "chip_smoke's")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        import torch

        if not torch.cuda.is_available():
            print("chain_bench.py: CUDA is not available", file=sys.stderr)
            return 2
        print(json.dumps(worker(args.worker, bool(args.atomic_b2), bool(args.atomic_b3),
                                args.checks, args.steps, args.chain_n, args.fused_n)),
              flush=True)
        return 0
    turns = []
    for tree in args.trees:
        root = os.path.abspath(os.path.join(HERE, tree))
        flags = ["--steps", *args.steps]
        flags += ["--atomic-b2", tree] if tree in args.atomic_b2 else []
        flags += ["--atomic-b3", tree] if tree in args.atomic_b3 else []
        flags += ["--checks", *args.checks] if args.checks else []
        flags += ["--chain-n", *map(str, args.chain_n)] if args.chain_n else []
        flags += ["--fused-n", *map(str, args.fused_n)] if args.fused_n else []
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root, *flags],
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
        for group in ("ms", "plain_ms", "host_us", "pair_ms", "pass_ms", "guard", "tbl_step",
                      "pso_step"):
            if mine[0][group] is not None:
                summary[tree][group] = {k: _median(t[group][k] for t in mine)
                                        for k in mine[0][group]}
        summary[tree]["spread"] = {group: {k: _spread(t[group][k] for t in mine)
                                           for k in mine[0][group]}
                                   for group in ("tbl_step", "pso_step")
                                   if mine[0][group] is not None}
    print(json.dumps({"card": turns[0]["card"], "median_by_tree": summary}), flush=True)
    roots = list(dict.fromkeys(os.path.abspath(os.path.join(HERE, t)) for t in args.trees))
    if len(roots) > 1 and (not args.checks or args.mixed_n):
        print(json.dumps({"machine_code_vs": roots[0],
                          "trees": compare_machine_code(roots, args.mixed_n)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
