"""Readings of the comparison's numbers over many seeds, for setting a
cell's limits (benchmark/limits/<cell>.json): the program as the
configuration states it, the control (the program's bfloat16 policy) and
the planted faults, each through set-up's first steps and the reference,
with no window.

    python3 benchmark/calibrate.py --workload pso.b32 --seeds 11-22 \
        --variants program,bf16,half_batch

One JSON line a run on standard output, then each variant's smallest and
largest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as R  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.spec import Spec  # noqa: E402


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 11-22,40")
    ap.add_argument("--variants", default="program,bf16,half_batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = Spec()
    table = {}
    for variant in args.variants.split(","):
        for seed in seeds_of(args.seeds):
            t0 = time.perf_counter()
            run = R.Run(spec, args.workload, seed, args.device, variant)
            run.setup(warm=False)
            run.free()
            _, _, readings = run.compare()
            numbers = readings["numbers"]
            table.setdefault(variant, []).append(numbers)
            print(json.dumps({"variant": variant, "seed": seed, **numbers,
                              "seconds": time.perf_counter() - t0, "readings": readings}),
                  flush=True)
    for variant, rows in table.items():
        span = {k: [min(r[k] for r in rows), max(r[k] for r in rows)] for k in compare.NAMES}
        print(json.dumps({"variant": variant, "runs": len(rows), "min_max": span}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
