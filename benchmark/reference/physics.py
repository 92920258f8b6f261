"""Electron optics for the benchmark's inputs and for the reference, in
plain NumPy: the wavelength, the STEM probe and its mixed-state modes
(PtychoShelves' hermite-like basis), the angular-spectrum propagator on a
half-bin-shifted k-grid, and the fitted background of an on-the-fly pad."""

from __future__ import annotations

import numpy as np

_PLANCK = 6.62607015e-34
_ELECTRON_MASS = 9.1093837015e-31
_ELECTRON_CHARGE = 1.602176634e-19
_LIGHT_SPEED = 299792458.0
_REST_KEV = _ELECTRON_MASS * _LIGHT_SPEED**2 / _ELECTRON_CHARGE * 1e-3
_HC_KEV_ANG = _PLANCK * _LIGHT_SPEED / _ELECTRON_CHARGE * 1e-3 * 1e10


def wavelength(kv: float) -> float:
    """Relativistic electron wavelength [Ang] at kv kilovolts."""
    return _HC_KEV_ANG / np.sqrt((2.0 * _REST_KEV + kv) * kv)


def stem_probe(kv: float, conv_angle: float, npix: int, dx: float, df: float) -> np.ndarray:
    """(npix, npix) complex64 probe of an aperture of conv_angle mrad with
    defocus df [Ang] (Kirkland's chi = -pi lambda k^2 df), unit intensity."""
    lam = wavelength(kv)
    dk = 1.0 / (dx * npix)
    k = np.fft.fftshift(np.fft.fftfreq(npix, 1.0 / npix)) * dk
    kx, ky = np.meshgrid(k, k, indexing="xy")
    kr = np.hypot(kx, ky)
    chi = -np.pi * lam * kr**2 * df
    aperture = (kr <= conv_angle / 1e3 / lam) * np.exp(-1j * chi)
    probe = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(aperture)))
    return (probe / np.sqrt(np.sum(np.abs(probe) ** 2))).astype(np.complex64)


def mixed_probe(probe: np.ndarray, pmodes: int, pows) -> np.ndarray:
    """pmodes orthonormal hermite-like modes of ``probe`` weighted by the
    square roots of their powers: pows for modes 1.. (the last repeats),
    mode 0 the rest of 1."""
    ny, nx = probe.shape
    m_max = int(np.ceil(np.sqrt(pmodes)) - 1)
    n_max = int(np.ceil(pmodes / (m_max + 1)) - 1)
    x, y = np.arange(nx) - nx / 2.0, np.arange(ny) - ny / 2.0
    X, Y = np.meshgrid(x, y)
    w = np.abs(probe) ** 2
    cx, cy = (X * w).sum() / w.sum(), (Y * w).sum() / w.sum()
    varx, vary = ((X - cx) ** 2 * w).sum() / w.sum(), ((Y - cy) ** 2 * w).sum() / w.sum()
    modes = []
    for n_ord in range(n_max + 1):
        for m_ord in range(m_max + 1):
            mode = (X - cx) ** m_ord * (Y - cy) ** n_ord * probe
            if modes:
                mode = mode * np.exp(-(X - cx) ** 2 / (2 * varx) - (Y - cy) ** 2 / (2 * vary))
            mode = mode / np.sqrt(np.sum(np.abs(mode) ** 2))
            for prev in modes:
                mode = mode - np.conj(np.vdot(mode, prev)) * prev
            modes.append((mode / np.sqrt(np.sum(np.abs(mode) ** 2))).astype(probe.dtype))
    pows = np.atleast_1d(np.asarray(pows, dtype=np.float64))
    p = np.array([0.0] + [pows[min(i, len(pows) - 1)] for i in range(pmodes - 1)])
    p[0] = 1.0 - p[1:].sum()
    return (np.stack(modes[:pmodes]) * np.sqrt(p)[:, None, None]).astype(np.complex64)


def kgrid(n: int, dx: float):
    """(Ky, Kx) angular wavenumbers [1/Ang], corner layout, half-bin shifted
    so that no frequency is exactly zero."""
    g = (np.arange(-((n + 1) // 2), n - (n + 1) // 2) + 0.5) / n
    k = np.fft.ifftshift(2.0 * np.pi * g / dx)
    return np.meshgrid(k, k, indexing="ij")


def propagator(n: int, dx: float, dz: float, lam: float) -> np.ndarray:
    """exp(i dz sqrt(k^2 - Kx^2 - Ky^2)), complex64, corner layout."""
    ky, kx = kgrid(n, dx)
    kz = np.sqrt((2.0 * np.pi / lam) ** 2 - kx**2 - ky**2)
    return np.exp(1j * dz * kz).astype(np.complex64)


def pad_background(crops: np.ndarray, target: int, threshold: float):
    """The background of patterns padded on the fly from (h, w) to target^2:
    a power law a r^-b in the radius from the crop's centre, fitted in log
    space to the mean amplitude's dimmest ``threshold`` percent; squared,
    with the measured window zeroed. Returns (background (target, target)
    float32, [h1, h2, w1, w2])."""
    amp = np.sqrt(np.asarray(crops, np.float64).mean(axis=0))
    h, w = amp.shape
    h1, w1 = (target - h) // 2, (target - w) // 2
    yy, xx = np.mgrid[:h, :w]
    r_in = np.hypot(yy - h // 2, xx - w // 2) + 1e-10
    dim = (amp <= np.percentile(amp, threshold)) & (amp > 0) & (r_in > 1)
    slope, icpt = np.polyfit(np.log(r_in[dim]), np.log(amp[dim]), 1)
    y, x = np.mgrid[:target, :target]
    r = np.maximum(np.hypot(y - (h // 2 + h1), x - (w // 2 + w1)), 1.0)
    bg = (np.exp(icpt) * r**slope) ** 2
    bg = bg.astype(np.float32)
    bg[h1:h1 + h, w1:w1 + w] = 0
    return bg, [h1, h1 + h, w1, w1 + w]
