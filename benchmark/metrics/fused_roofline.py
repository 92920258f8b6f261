"""Kernels, fused layer: the least time the card could take for the layer's
work of the traced steps (benchmark/work fused_step) over the device time of
the kernels that layers/fused/ names, in percent."""


def read(rec):
    kernels = rec.layer_kernels("fused")
    if not kernels:
        return None
    nbytes, ops = rec.work.fused_step(rec.shape)
    return 100.0 * rec.work.bound_s(nbytes, ops) * rec.steps / sum(d for _, d in kernels)
