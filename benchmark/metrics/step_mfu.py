"""Whole step: the model's FP32 operations of the traced steps
(benchmark/work model_ops_per_step) over the traced window's length times
the card's FP32 peak, in percent."""


def read(rec):
    ops = rec.work.model_ops_per_step(rec.shape) * rec.steps
    return 100.0 * ops / (rec.trace.window_s * rec.work.PEAKS["fp32_per_s"])
