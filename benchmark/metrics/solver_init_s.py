"""Set-up: host seconds of PtyRADSolver's constructor, prepare and _build, synchronised."""


def read(rec):
    return rec.spans.get("solver_init_s")
