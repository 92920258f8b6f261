"""Shared inputs for the tests that hold ptyrad_tpu_torch against ptyrad_tpu.

Every input is made with numpy from a seed and handed to both packages, so
the two compute the same thing; results come back as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")


def toy_init(rng, n_scans=12, npix=16, omode=1, nz=3, pmode=2, canvas=32):
    """A small init_variables dict (random probe, weak phase object)."""
    from ptyrad_tpu_torch.physics.propagator import near_field_evolution

    probe = (rng.standard_normal((pmode, npix, npix))
             + 1j * rng.standard_normal((pmode, npix, npix))).astype(np.complex64)
    probe /= np.sqrt((np.abs(probe) ** 2).sum())
    obj = (1.0 + 0.05 * rng.standard_normal((omode, nz, canvas, canvas))) * np.exp(
        1j * 0.1 * rng.standard_normal((omode, nz, canvas, canvas)))
    crop_pos = rng.integers(0, canvas - npix, size=(n_scans, 2)).astype(np.int32)
    lambd, dx, dz = 0.0417, 0.15, 2.0
    meas = np.abs(rng.standard_normal((n_scans, npix, npix))).astype(np.float32) * 1e-2
    occu = np.ones(omode, np.float32) / omode
    return {
        "obj": obj.astype(np.complex64),
        "probe": probe,
        "probe_pos_shifts": np.zeros((n_scans, 2), np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32),
        "slice_thickness": dz,
        "H": near_field_evolution((npix, npix), dx, dz, lambd),
        "measurements": meas,
        "crop_pos": crop_pos,
        "omode_occu": occu,
        "dx": dx,
        "lambd": lambd,
        "N_scan_slow": n_scans,
        "N_scan_fast": 1,
    }


def jax_params_numpy(p) -> dict:
    """The JAX package's PtychoParams as numpy arrays (probe complex64)."""
    return {
        "obja": np.asarray(p.obja),
        "objp": np.asarray(p.objp),
        "probe": (np.asarray(p.probe.re) + 1j * np.asarray(p.probe.im)).astype(np.complex64),
        "probe_pos_shifts": np.asarray(p.probe_pos_shifts),
        "obj_tilts": np.asarray(p.obj_tilts),
        "slice_thickness": np.asarray(p.slice_thickness),
    }


def np_(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def cplx_np(c) -> np.ndarray:
    """A JAX Cplx pair as a complex numpy array."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def assert_grad_close(actual, expected, name, atol_scale=2e-5, rtol=1e-3):
    """Gradient agreement as tests/test_forward.py:356-372 states it: atol
    2e-5 of the largest reference entry (float32 transforms through two
    FFT implementations) and rtol 1e-3."""
    expected = np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(actual), expected, atol=atol_scale * scale, rtol=rtol,
                               err_msg=f"gradient mismatch: {name}")
