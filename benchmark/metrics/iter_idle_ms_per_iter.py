"""Solver loop: device-idle ms per iteration inside the program's
ptyrad.iter spans but outside every ptyrad.step: the batches' copy, the
loss table's copy, the constraints' host code, the synchronise and the
history."""

from benchmark import spans


def read(rec):
    iters = spans.intervals(rec.trace, spans.ITER)
    if not iters:
        return None
    in_iter = spans.intersect(spans.idle(rec.trace), iters)
    in_steps = spans.intersect(in_iter, spans.intervals(rec.trace, spans.STEP))
    return (spans.seconds(in_iter) - spans.seconds(in_steps)) * 1e3 / rec.iters
