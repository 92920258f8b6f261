"""Model: device ms per step of the kernels launched inside the program's
ptyrad.step.loss span (the forward and the loss), from the thread that
opened it."""

from benchmark.spans import LOSS


def read(rec):
    kernels = rec.trace.in_range(LOSS)
    return sum(d for _, d in kernels) * 1e3 / rec.steps if kernels else None
