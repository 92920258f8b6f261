"""Named spans of the port's phases, on the profiler's own clock.

``with span("ptyrad.step"): ...`` adds its body's host seconds
(``time.perf_counter``) and one count to a table of the process
(``totals()``). While a profiler records (``torch.profiler.profile``,
``utils.dev_tools.trace``, ``torch.autograd.profiler.emit_nvtx`` under
Nsight Systems) it also opens ``record_function(name)``, so the trace holds
the profiler's own range, on the clock it shares with the card's events;
no time from the table is ever written into a trace. With no profiler
recording no ``record_function`` is constructed (one costs 5 to 8
microseconds even then) and a span costs under one.

The names are static; PERF.md §3 lists every span with the per-layer
metric that reads it. The solver opens spans on the thread that drives it;
the table takes no lock.
"""

from __future__ import annotations

import time

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

_TOTALS: dict = {}  # name -> (count, seconds)


class span:
    """A context manager over one named phase (see the module's docstring)."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        count, total = _TOTALS.get(self.name, (0, 0.0))
        _TOTALS[self.name] = (count + 1, total + seconds)
        return False


def totals() -> dict:
    """{name: (count, host seconds)} of every span closed since the last
    ``reset()`` (or since the process started)."""
    return dict(_TOTALS)


def reset() -> None:
    """Clear the table."""
    _TOTALS.clear()
