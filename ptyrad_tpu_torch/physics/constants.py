"""Electron-optics constants and the pixel-size calibration (host-side NumPy).

The port's own copy of ptyrad_tpu/physics/constants.py: electron_wavelength,
get_em_constants, xray_wavelength, infer_dx and complex_object_interp3d.
"""

from __future__ import annotations

from typing import Optional

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


def get_em_constants(kv: float, output_type: str):
    """Return 'gamma' (Lorentz factor), 'wavelength' (Ang), or 'sigma'
    (interaction parameter, 1/(kV*Ang)) for an electron beam at `kv` kilovolts.
    """
    gamma = 1.0 + kv / _REST_ENERGY_KEV
    wavelength = electron_wavelength(kv)
    if output_type == "gamma":
        return gamma
    if output_type == "wavelength":
        return wavelength
    if output_type == "sigma":
        # 2*pi*gamma*m0*e*lambda / h^2, converted to 1/(kV*Ang)
        sigma = (
            2.0 * np.pi * gamma * _ELECTRON_MASS * _ELECTRON_CHARGE * wavelength
            / _PLANCK**2 * 1e-20 * 1e3
        )
        return sigma
    raise KeyError(
        f"output_type '{output_type}' not supported; use 'gamma', 'wavelength', or 'sigma'"
    )


def xray_wavelength(kev: float) -> float:
    """X-ray wavelength in meters for photon energy in keV."""
    return 1.23984193e-9 / kev


def infer_dx(
    dx: Optional[float] = None,
    dk: Optional[float] = None,
    kMax: Optional[float] = None,
    da: Optional[float] = None,
    angleMax: Optional[float] = None,
    RBF: Optional[float] = None,
    n_alpha: Optional[float] = None,
    conv_angle: Optional[float] = None,
    wavelength: Optional[float] = None,
    Npix: Optional[int] = None,
) -> float:
    """Infer the real-space pixel size dx from one of the calibration modes:
      - dx directly
      - dk [1/Ang] + Npix:  dx = 1/(Npix*dk)
      - kMax [1/Ang]:       dx = 1/(2*kMax)
      - da [mrad] + wavelength + Npix
      - angleMax [mrad] + wavelength
      - RBF [px] + conv_angle [mrad] + wavelength + Npix
      - n_alpha + conv_angle + wavelength
    """
    if dx is not None:
        return float(dx)
    if dk is not None and Npix is not None:
        return 1.0 / (Npix * dk)
    if kMax is not None:
        return 1.0 / (2.0 * kMax)
    if da is not None and wavelength is not None and Npix is not None:
        dk_ = da / wavelength / 1e3
        return 1.0 / (Npix * dk_)
    if angleMax is not None and wavelength is not None:
        kmax_ = angleMax / wavelength / 1e3
        return 1.0 / (2.0 * kmax_)
    if all(v is not None for v in (RBF, conv_angle, wavelength, Npix)):
        da_ = conv_angle / RBF / 1e3
        dk_ = da_ / wavelength
        return 1.0 / (Npix * dk_)
    if n_alpha is not None and conv_angle is not None and wavelength is not None:
        angle_max = n_alpha * conv_angle
        kmax_ = angle_max / wavelength / 1e3
        return 1.0 / (2.0 * kmax_)
    raise ValueError(
        "Insufficient parameters to infer dx. Provide one of: dx; dk+Npix; kMax; "
        "da+wavelength+Npix; angleMax+wavelength; RBF+conv_angle+wavelength+Npix; "
        "n_alpha+conv_angle+wavelength."
    )


def complex_object_interp3d(complex_object, zoom_factors, z_axis: int = 0):
    """Interpolate a 3D complex object preserving multislice conservation laws

    Phase is additive across z-slices and amplitude multiplicative, so the
    interpolation runs on (log-amplitude, phase) and divides both by the
    z-zoom factor: the z-sum of phase and z-product of amplitude are
    preserved under slice-count changes.
    """
    from scipy import ndimage

    zoom_factors = tuple(zoom_factors)
    if zoom_factors == (1, 1, 1):
        return complex_object
    dtype = complex_object.dtype
    amp = np.abs(complex_object)
    phase = np.angle(complex_object)
    amp_i = np.exp(ndimage.zoom(np.log(np.maximum(amp, 1e-12)), zoom_factors) / zoom_factors[z_axis])
    phase_i = ndimage.zoom(phase, zoom_factors) / zoom_factors[z_axis]
    return (amp_i * np.exp(1j * phase_i)).astype(dtype)
