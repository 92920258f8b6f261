"""The work counts against hand counts at a small shape."""

import math

import pytest

from benchmark import work

SHAPE = {"B": 2, "pmode": 3, "omode": 1, "nz": 2, "n": 4, "probe_b": 1, "h_b": 1,
         "shift_probes": False, "covered": 40.0}


def test_fft_and_product_counts():
    assert work.fft2_ops(4) == 10 * 16 * 2
    assert work.cmul_ops(4) == 6 * 16
    assert work.fft2_ops(1024) == 10 * 1024 ** 2 * 10


def test_model_ops_by_hand():
    # per wavefield: 3 FFTs forward and 3 backward (two for the one
    # propagation, one to the detector); products 1 + 2 forward, 1 + 4 back
    per_wave = 3 * 320 + 3 * 96 + 3 * 320 + 5 * 96
    assert work.model_ops_per_step(SHAPE) == 6 * per_wave
    shifted = {**SHAPE, "shift_probes": True}
    assert work.model_ops_per_step(shifted) == 6 * (per_wave + 2 * (2 * 320 + 96))


def test_fused_step_by_hand():
    nbytes, ops = work.fused_step(SHAPE)
    windows = 2 * 4 * 2 * 2 * 16          # amplitude and phase, B 2, nz 2
    probe = 8 * 3 * 16
    inputs = windows + probe + 8 * 16 + 4 * 2 * 16 + 4 * 2
    assert nbytes == 2 * inputs + 8 + windows + probe
    assert ops == 3 * 6 * (4 * 320 + 3 * 96)


def test_chain_step_by_hand():
    nbytes, ops = work.chain_step(SHAPE)
    prop = 2 * 320 + 96
    fwd = 6 * (1 * prop + 2 * 96)
    bwd = 6 * (2 * prop + 2 * 96 + 2 * 12 * 16)
    assert ops == fwd + bwd
    windows, probe, h, exit_wave = 2 * 4 * 2 * 2 * 16, 8 * 3 * 16, 8 * 16, 8 * 6 * 16
    assert nbytes == (windows + probe + h + exit_wave) * 2 + windows + probe


def test_patches_step_by_hand():
    nbytes, ops = work.patches_step(SHAPE)
    planes = 4  # amplitude and phase of 2 slices
    assert ops == planes * 2 * 16
    assert nbytes == 2 * (4 * planes * 2 * 16 + 4 * planes * 40 + 8 * 2)


@pytest.mark.parametrize("nbytes,ops,expect", [
    (3.35e12, 0, 1.0), (0, 67e12, 1.0), (3.35e9, 67e12, 1.0), (6.7e12, 67e12, 2.0)])
def test_bound_takes_the_larger(nbytes, ops, expect):
    assert math.isclose(work.bound_s(nbytes, ops), expect)
