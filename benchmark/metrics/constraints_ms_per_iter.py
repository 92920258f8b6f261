"""Constraints: device ms per iteration of the kernels launched inside the
range the benchmark opens around the constraint_fn it hands recon_loop."""

from benchmark.trace import CONSTRAINTS


def read(rec):
    kernels = rec.trace.in_range(CONSTRAINTS)
    return sum(d for _, d in kernels) * 1e3 / rec.iters if kernels else None
