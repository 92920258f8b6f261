"""Solver loop: kernels the device ran in the traced iterations, per step."""


def read(rec):
    return len(rec.trace.kernels) / rec.steps if rec.trace.kernels else None
