"""Model: device ms per step of the kernels launched, from any thread, while
the main thread was inside the program's ptyrad.step.backward span (the
autograd engine launches them from its own thread)."""

from benchmark import spans


def read(rec):
    kernels = spans.launched_in(rec.trace, spans.intervals(rec.trace, spans.BACKWARD))
    return sum(d for _, d in kernels) * 1e3 / rec.steps if kernels else None
