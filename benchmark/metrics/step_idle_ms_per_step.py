"""Solver loop: device-idle ms per step inside the program's ptyrad.step
spans (the window's idle time while the host ran a step)."""

from benchmark import spans


def read(rec):
    steps = spans.intervals(rec.trace, spans.STEP)
    if not steps:
        return None
    return spans.seconds(spans.intersect(spans.idle(rec.trace), steps)) * 1e3 / rec.steps
