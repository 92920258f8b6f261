"""Model: of the kernels that loss_fwd_ms_per_step and loss_bwd_ms_per_step
count, device ms per step of those that no kernel layer (layers/*/*.txt)
names: PyTorch's elementwise, copy and reduce kernels and cuFFT's around
the hand-written ones."""

import re

from benchmark import spans


def read(rec):
    kernels = (rec.trace.in_range(spans.LOSS)
               + spans.launched_in(rec.trace, spans.intervals(rec.trace, spans.BACKWARD)))
    if not kernels:
        return None
    layers = sorted(p.name for p in (rec.spec.dir / "layers").iterdir() if p.is_dir())
    named = [re.compile(p) for layer in layers for p in rec.spec.layer_patterns(layer)]
    glue = [d for name, d in kernels if not any(r.search(name) for r in named)]
    return sum(glue) * 1e3 / rec.steps
