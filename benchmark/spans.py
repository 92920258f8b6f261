"""The program's own spans (ptyrad_tpu_torch/utils/tracing.py) in a traced
iteration, for the per-layer metrics that read them: a span's intervals on
the main thread, the kernels launched inside them from any thread, the
window's idle intervals, and the host seconds of a span from the program's
own table. A program without the spans leaves every list empty and every
host reading None."""

from __future__ import annotations

import bisect

from benchmark.trace import _union

ITER, STEP = "ptyrad.iter", "ptyrad.step"
LOSS, BACKWARD = "ptyrad.step.loss", "ptyrad.step.backward"


def intervals(trace, name: str) -> list:
    """The merged (start, end) µs of every range ``name`` on the main thread."""
    return _union((e["ts"], e["ts"] + e["dur"]) for e in trace.host
                  if e["name"] == name and e["tid"] == trace.main_tid)


def launched_in(trace, ivs: list) -> list:
    """(name, seconds) of every kernel whose launch, on any thread, falls
    inside one of the merged intervals ``ivs``: the autograd engine launches
    the backward's kernels from its own thread while the main thread waits
    inside ``backward()``."""
    starts = [a for a, _ in ivs]
    out = []
    for e in trace.kernels:
        at = trace.launch_at.get((e.get("args") or {}).get("correlation"))
        if at is None:
            continue
        i = bisect.bisect_right(starts, at[1]) - 1
        if i >= 0 and at[1] <= ivs[i][1]:
            out.append((e["name"], e["dur"] * 1e-6))
    return out


def idle(trace) -> list:
    """The (start, end) µs of the window in which the card ran no kernel,
    copy or fill."""
    edges = [trace.t0] + [x for iv in trace.busy_intervals() for x in iv] + [trace.t1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def intersect(a: list, b: list) -> list:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def seconds(ivs: list) -> float:
    return sum(b - a for a, b in ivs) * 1e-6


def host_seconds(name: str):
    """Host seconds of the program's span ``name`` from its own table
    (utils.tracing.totals), or None where the program has no such span or
    none closed."""
    try:
        from ptyrad_tpu_torch.utils.tracing import totals
    except ImportError:
        return None
    count, total = totals().get(name, (0, 0.0))
    return total if count else None
