"""Optimizer: device ms per step of the kernels launched inside torch's own
Optimizer.step range of Adam."""


def read(rec):
    kernels = rec.trace.in_range("Optimizer.step#Adam.step")
    return sum(d for _, d in kernels) * 1e3 / rec.steps if kernels else None
