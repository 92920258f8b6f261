"""Verbosity-gated printing (counterpart of ptyrad_tpu/utils/logging.py:vprint).

The port runs one process per card, so there is no rank gate.
"""

from __future__ import annotations


def vprint(*args, verbose: bool = True, **kwargs) -> None:
    if verbose:
        print(*args, **kwargs)
