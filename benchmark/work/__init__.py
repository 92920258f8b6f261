"""The operations and bytes the model's work needs, counted from a cell's
shapes (frozen: later changes to the program do not move them).

A 2-D FFT of N^2 points counts 10 N^2 log2 N operations and a complex
product 6 N^2. A layer's bytes count each input byte read once and each
output byte written once, whatever the kernels read again or keep in
scratch. ``shape`` is the dict that the harness builds for a cell:
B (rows a step), pmode, omode, nz, n, probe_b (B when the probe is shifted
for each position, else 1), h_b (1: one propagator), covered (canvas
pixels under a step's windows, the mean over the traced steps) and
shift_probes.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def fft2_ops(n: int) -> float:
    return 10.0 * n * n * math.log2(n)


def cmul_ops(n: int) -> float:
    return 6.0 * n * n


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / PEAKS["bytes_per_s"], ops / PEAKS["fp32_per_s"])


def _waves(s: dict) -> int:
    return s["B"] * s["pmode"] * s["omode"]


def model_ops_per_step(s: dict) -> float:
    """The model's FP32 operations of one step, forward and backward, of
    every probe and object mode, slice and row, whatever runs them: per
    wavefield the probe's shift (two FFTs and the ramp) where positions are
    refined, nz - 1 propagations (two FFTs and the H product), nz
    transmissions and the detector's FFT; the backward the same FFTs, the
    H products, and two products a transmission (the wave's and the
    slice's cotangents)."""
    n, nz = s["n"], s["nz"]
    shift = 1 if s["shift_probes"] else 0
    ffts = 2 * shift + 2 * (nz - 1) + 1
    fwd = ffts * fft2_ops(n) + (shift + nz + (nz - 1)) * cmul_ops(n)
    bwd = ffts * fft2_ops(n) + (shift + 2 * nz + (nz - 1)) * cmul_ops(n)
    return _waves(s) * (fwd + bwd)


def _obj_patch_bytes(s: dict) -> float:
    return 2 * 4.0 * s["B"] * s["omode"] * s["nz"] * s["n"] ** 2


def _probe_bytes(s: dict) -> float:
    return 8.0 * s["probe_b"] * s["pmode"] * s["n"] ** 2


def fused_step(s: dict) -> tuple[float, float]:
    """(bytes, operations) of a step of the loss-folded chain (B3a, B3b):
    the forward 2 nz FFTs and 2 nz - 1 products a wavefield, the backward
    twice that; reads the windows, the probe, H, the measurements and the
    mask, writes two sums forward and the windows' and probe's gradients
    backward."""
    n, nz = s["n"], s["nz"]
    fwd_ops = _waves(s) * (2 * nz * fft2_ops(n) + (2 * nz - 1) * cmul_ops(n))
    inputs = (_obj_patch_bytes(s) + _probe_bytes(s) + 8.0 * s["h_b"] * n * n
              + 4.0 * s["B"] * n * n + 4.0 * s["B"])
    outputs = 8.0 + _obj_patch_bytes(s) + _probe_bytes(s)
    return 2 * inputs + outputs, 3 * fwd_ops


def chain_step(s: dict) -> tuple[float, float]:
    """(bytes, operations) of a step of the segmented chain (B5a/b,
    B6a/b), the detector's FFT outside it: forward nz - 1 propagations and
    nz transmissions a wavefield; backward the propagations twice (the
    recompute and the adjoint), the transmissions and 12 N^2 an adjoint
    slice; reads the windows, the probe and H and writes the exit waves
    forward, reads them with the exit's cotangent and writes the windows'
    and probe's gradients backward."""
    n, nz = s["n"], s["nz"]
    prop = 2 * fft2_ops(n) + cmul_ops(n)
    fwd_ops = _waves(s) * ((nz - 1) * prop + nz * cmul_ops(n))
    bwd_ops = _waves(s) * (2 * (nz - 1) * prop + nz * cmul_ops(n) + nz * 12.0 * n * n)
    inputs = _obj_patch_bytes(s) + _probe_bytes(s) + 8.0 * s["h_b"] * n * n
    exit_wave = 8.0 * _waves(s) * n * n
    fwd = inputs + exit_wave
    bwd = inputs + exit_wave + _obj_patch_bytes(s) + _probe_bytes(s)
    return fwd + bwd, fwd_ops + bwd_ops


def patches_step(s: dict) -> tuple[float, float]:
    """(bytes, operations) of a step's window gather (B1) and scatter-add
    (B2) over the amplitude and phase canvases: B1 reads the covered canvas
    and writes the windows, B2 reads the windows' gradients and writes the
    covered canvas, one add an element; both read the corners."""
    planes = 2 * s["omode"] * s["nz"]
    windows = 4.0 * planes * s["B"] * s["n"] ** 2
    covered = 4.0 * planes * s["covered"]
    corners = 8.0 * s["B"]
    return 2 * (windows + covered + corners), planes * s["B"] * s["n"] ** 2
