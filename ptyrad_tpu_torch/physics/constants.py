"""Electron wavelength (host-side NumPy; bit-exact copy of
ptyrad_tpu/physics/constants.py:electron_wavelength)."""

from __future__ import annotations

import numpy as np

# CODATA constants (SI)
_PLANCK = 6.62607015e-34       # J s
_ELECTRON_MASS = 9.1093837015e-31  # kg
_ELECTRON_CHARGE = 1.602176634e-19  # C
_LIGHT_SPEED = 299792458.0     # m/s

# Electron rest energy in keV: m0 c^2 / e * 1e-3
_REST_ENERGY_KEV = _ELECTRON_MASS * _LIGHT_SPEED**2 / _ELECTRON_CHARGE * 1e-3
# h*c in keV*Angstrom
_HC_KEV_ANG = _PLANCK * _LIGHT_SPEED / _ELECTRON_CHARGE * 1e-3 * 1e10


def electron_wavelength(kv: float) -> float:
    """Relativistic electron wavelength in Angstrom for acceleration voltage in kV.

    lambda = h*c / sqrt((2 m0c^2 + eV) * eV) with energies in keV.
    """
    return _HC_KEV_ANG / np.sqrt((2.0 * _REST_ENERGY_KEV + kv) * kv)
