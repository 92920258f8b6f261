"""The comparison that decides ``correct``: the program's first steps
against the reference's on the same inputs and batches.

Three numbers, each with a limit of its own: the largest relative gap of a
step's loss; the worst leaf's gap between the norms of the first gradient
as the optimizer got it (the program's worked out from Adam's first
moment after one step); the worst leaf's gap between the norms of the
parameters' change over the steps. A leaf's gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median leaf's
(those that have not started, or that move by round-off alone) are left out
of the change, and so are leaves with a free gauge: under ortho_pmode the
probe's modes are the eigenvectors of their Gram matrix, defined only up to
a unitary mixing where their powers are equal (make_mixed_probe gives every
mode after the first the same power), so a rounding-level difference mixes
them anew and Adam's later elementwise steps in the mixed basis differ. The
probe is held by its first gradient. Its change, and the change of what no
mixing moves (model.probe_readings: its intensity map and its modes'
powers), are recorded, not compared: the later steps amplify rounding in
them to within a few times of what the control and the faults read.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad1_gap", "change_gap")


def _worst(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    if not leaves:
        return 0.0
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0
               else (0.0 if prog[k] == 0 else math.inf) for k in leaves)


def gaps(prog: dict, ref: dict, gauge_free=()) -> dict:
    """The three numbers from the program's and the reference's readings
    ({"losses": [...], "grad1": {leaf: norm}, "change": {leaf: norm}});
    ``gauge_free``: leaves left out of the change."""
    loss = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
               for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    g_med = statistics.median(ref["grad1"].values())
    moving = [k for k, g in ref["grad1"].items() if g >= 1e-3 * g_med and k not in gauge_free]
    return {"loss_gap": loss,
            "grad1_gap": _worst(prog["grad1"], ref["grad1"], ref["grad1"]),
            "change_gap": _worst(prog["change"], ref["change"], moving)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit; a missing limit fails."""
    checks = {k: {"value": numbers[k], "limit": limits.get(k.replace("_gap", ""))}
              for k in NAMES}
    ok = all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Every leaf's change gap, and each probe reading's, against its own
    reference norm, for the record (the gauge-free ones included)."""
    own = {**ref["change"], **ref["probe"]}
    return {k: abs({**prog["change"], **prog["probe"]}[k] - r) / r
            for k, r in own.items() if r > 0}
