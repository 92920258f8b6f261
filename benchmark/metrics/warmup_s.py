"""Set-up: host seconds of the warm-up iteration (first use of each shape,
cuFFT plans, allocator growth), synchronised."""


def read(rec):
    return rec.spans.get("warmup_s")
