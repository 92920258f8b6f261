"""Angular-spectrum propagators (host-side NumPy; bit-exact copy of
ptyrad_tpu/physics/propagator.py).

The k-grid uses a half-bin shift so the exact zero frequency is avoided, which
keeps sqrt(k^2 - Kx^2 - Ky^2) finite and differentiable in the slice
thickness.
"""

from __future__ import annotations

import numpy as np


def propagator_kgrid(npix_shape, dx: float):
    """Half-bin-shifted angular k-grids (corner-centered), returns (Ky, Kx)."""
    ny, nx = npix_shape
    ygrid = (np.arange(-((ny + 1) // 2), ny - (ny + 1) // 2) + 0.5) / ny
    xgrid = (np.arange(-((nx + 1) // 2), nx - (nx + 1) // 2) + 0.5) / nx
    ky = np.fft.ifftshift(2.0 * np.pi * ygrid / dx)
    kx = np.fft.ifftshift(2.0 * np.pi * xgrid / dx)
    Ky, Kx = np.meshgrid(ky, kx, indexing="ij")
    return Ky, Kx


def near_field_evolution(npix_shape, dx: float, dz: float, lambd: float) -> np.ndarray:
    """H = exp(i * dz * sqrt(k^2 - Kx^2 - Ky^2)), corner-centered; multiply in
    k-space between slices: psi <- ifft2(H * fft2(psi))."""
    Ky, Kx = propagator_kgrid(npix_shape, dx)
    k = 2.0 * np.pi / lambd
    kz = np.sqrt(k**2 - Kx**2 - Ky**2)
    return np.exp(1j * dz * kz).astype(np.complex64)
