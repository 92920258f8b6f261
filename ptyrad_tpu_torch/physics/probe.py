"""Probe simulation: STEM probes, X-ray zone-plate probes and mixed-state
bases (host-side NumPy; bit-exact copy of ptyrad_tpu/physics/probe.py:
make_stem_probe, make_fzp_probe, hermite_like_basis, make_mixed_probe)."""

from __future__ import annotations

import numpy as np

from ptyrad_tpu_torch.physics.constants import electron_wavelength, xray_wavelength


def make_stem_probe(probe_params: dict, verbose: bool = False) -> np.ndarray:
    """Complex STEM probe at the sample plane from lens aberrations.

    probe_params keys (units): kv [kV], conv_angle [mrad], Npix, dx [Ang],
    df [Ang], c3, c5, c7 [Ang], f_a2, f_a3, f_c3 [Ang] with azimuths
    theta_a2, theta_a3, theta_c3 [rad], shifts [Ang, (x, y)].

    Returns (Npix, Npix) complex64 normalized so sum(|probe|^2) = 1.
    """
    kv = float(probe_params["kv"])
    conv_angle = float(probe_params["conv_angle"])
    npix = int(probe_params["Npix"])
    dx = float(probe_params["dx"])
    df = float(probe_params.get("df", 0))
    c3 = float(probe_params.get("c3", 0))
    c5 = float(probe_params.get("c5", 0))
    c7 = float(probe_params.get("c7", 0))
    f_a2 = float(probe_params.get("f_a2", 0))
    f_a3 = float(probe_params.get("f_a3", 0))
    f_c3 = float(probe_params.get("f_c3", 0))
    theta_a2 = float(probe_params.get("theta_a2", 0))
    theta_a3 = float(probe_params.get("theta_a3", 0))
    theta_c3 = float(probe_params.get("theta_c3", 0))
    shifts = probe_params.get("shifts", [0.0, 0.0])

    lam = electron_wavelength(kv)
    k_cutoff = conv_angle / 1e3 / lam
    dk = 1.0 / (dx * npix)

    kline = np.fft.fftshift(np.fft.fftfreq(npix, 1.0 / npix)) * dk
    kX, kY = np.meshgrid(kline, kline, indexing="xy")
    kR = np.hypot(kX, kY)
    theta = np.arctan2(kY, kX)
    aperture = kR <= k_cutoff

    # Kirkland aberration phase chi(k), radians
    chi = -np.pi * lam * kR**2 * df
    if c3 != 0:
        chi = chi + (np.pi / 2.0) * c3 * lam**3 * kR**4
    if c5 != 0:
        chi = chi + (np.pi / 3.0) * c5 * lam**5 * kR**6
    if c7 != 0:
        chi = chi + (np.pi / 4.0) * c7 * lam**7 * kR**8
    if f_a2 != 0:
        chi = chi + np.pi * f_a2 * lam * kR**2 * np.sin(2.0 * (theta - theta_a2))
    if f_a3 != 0:
        chi = chi + (2.0 * np.pi / 3.0) * f_a3 * lam**2 * kR**3 * np.sin(3.0 * (theta - theta_a3))
    if f_c3 != 0:
        chi = chi + (2.0 * np.pi / 3.0) * f_c3 * lam**2 * kR**3 * np.sin(theta - theta_c3)

    psi_aperture = np.exp(-1j * chi)
    psi_aperture = psi_aperture * np.exp(-2j * np.pi * shifts[0] * kX)
    psi_aperture = psi_aperture * np.exp(-2j * np.pi * shifts[1] * kY)
    psi_aperture = aperture * psi_aperture

    probe = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(psi_aperture)))
    probe = probe / np.sqrt(np.sum(np.abs(probe) ** 2))
    return probe.astype(np.complex64)


def make_fzp_probe(probe_params: dict, verbose: bool = False) -> np.ndarray:
    """Simulate an X-ray Fresnel-zone-plate probe at the sample plane.

    A FZP of outer radius Rn / outer zone width dRn (focal length
    f = 2*Rn*dRn/lambda), apertured by a pinhole D_FZP with central beamstop
    D_H, is Fresnel-propagated a distance f + Ls to the sample plane.

    probe_params keys: Npix, beam_kev [keV], dx [m], Ls [m], Rn [m], dRn [m],
    D_FZP [m], D_H [m]. Returns (Npix, Npix) complex128.

    A fractional photon energy is used as given (upstream PtyRAD truncates
    it to an integer keV), as in the JAX package.
    """
    n = int(probe_params["Npix"])
    energy_kev = float(probe_params["beam_kev"])
    dx = float(probe_params["dx"])
    ls = float(probe_params["Ls"])
    rn = float(probe_params["Rn"])
    drn = float(probe_params["dRn"])
    d_fzp = float(probe_params["D_FZP"])
    d_h = float(probe_params["D_H"])

    lam = xray_wavelength(energy_kev)
    fl = 2.0 * rn * drn / lam  # focal length at the central wavelength
    k = 2.0 * np.pi / lam

    # FZP-plane pixel size from the Fourier scaling of the focusing geometry
    dx_fzp = lam * fl / n / dx
    line = np.linspace(-dx_fzp * n / 2.0, dx_fzp * n / 2.0, n)
    x, y = np.meshgrid(line, line)
    r2 = x**2 + y**2

    zone_phase = np.exp(-1j * k * r2 / (2.0 * fl))  # ideal FZP transmission
    pinhole = (np.sqrt(r2) <= d_fzp / 2.0).astype(np.float64)
    beamstop = (np.sqrt(r2) >= d_h / 2.0).astype(np.float64)
    field_in = pinhole * zone_phase * beamstop

    # Single-step Fresnel propagation over z = fl + Ls
    fc = 1.0 / dx_fzp
    fu = lam * (fl + ls) * fc
    lu = np.fft.ifftshift(np.linspace(-fu / 2.0, fu / 2.0, n))
    u, v = np.meshgrid(lu, lu)

    z = fl + ls
    if z > 0:
        quad_out = np.exp(1j * k * z) * np.exp(1j * k * (u**2 + v**2) / (2.0 * z))
        kern = field_in * np.exp(1j * k * r2 / (2.0 * z))
        probe = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(kern)) * quad_out)
    else:
        z = abs(z)
        quad = np.exp(1j * k * z) * np.exp(1j * k * r2 / (2.0 * z))
        cgh = np.fft.ifft2(
            np.fft.ifftshift(field_in) / np.exp(1j * k * (u**2 + v**2) / (2.0 * z))
        )
        probe = np.fft.fftshift(cgh) / quad
    return probe


def hermite_like_basis(fundamental: np.ndarray, m_max: int, n_max: int) -> np.ndarray:
    """(m_max+1)*(n_max+1) orthonormal modes from a fundamental probe
    (PtychoShelves' hermite_like construction), each with unit intensity."""
    m_max, n_max = int(m_max), int(n_max)
    ny, nx = fundamental.shape[-2:]
    x = np.arange(nx) - nx / 2.0
    y = np.arange(ny) - ny / 2.0
    X, Y = np.meshgrid(x, y)

    w = np.abs(fundamental) ** 2
    wsum = w.sum()
    cx = (X * w).sum() / wsum
    cy = (Y * w).sum() / wsum
    varx = ((X - cx) ** 2 * w).sum() / wsum
    vary = ((Y - cy) ** 2 * w).sum() / wsum

    n_modes = (m_max + 1) * (n_max + 1)
    basis = np.zeros((n_modes, ny, nx), dtype=fundamental.dtype)
    idx = 0
    for n_ord in range(n_max + 1):
        for m_ord in range(m_max + 1):
            mode = (X - cx) ** m_ord * (Y - cy) ** n_ord * fundamental
            if idx > 0:
                mode = mode * np.exp(
                    -((X - cx) ** 2 / (2.0 * varx)) - ((Y - cy) ** 2 / (2.0 * vary))
                )
            mode = mode / np.sqrt(np.sum(np.abs(mode) ** 2))
            # Gram-Schmidt against earlier modes (conjugate inner product)
            for j in range(idx):
                proj = np.vdot(mode, basis[j])
                mode = mode - np.conj(proj) * basis[j]
            mode = mode / np.sqrt(np.sum(np.abs(mode) ** 2))
            basis[idx] = mode
            idx += 1
    return basis


def make_mixed_probe(
    probe: np.ndarray, pmodes: int, pmode_init_pows, verbose: bool = False
) -> np.ndarray:
    """Expand a single probe into `pmodes` incoherent modes with given powers.

    pmode_init_pows: fractional powers for modes 1..; the last value repeats
    for any remaining higher modes; mode 0 takes the remainder so the total
    intensity stays 1.
    """
    pmodes = int(pmodes)
    m = int(np.ceil(np.sqrt(pmodes)) - 1)
    n = int(np.ceil(pmodes / (m + 1)) - 1)
    mixed = hermite_like_basis(probe, m, n)[:pmodes]

    pows = np.zeros(pmodes)
    init = np.atleast_1d(np.asarray(pmode_init_pows, dtype=np.float64))
    for i in range(1, pmodes):
        pows[i] = init[i - 1] if i - 1 < init.size else init[-1]
    if pows.sum() > 1:
        raise ValueError("Sum of pmode_init_pows exceeds 1")
    pows[0] = 1.0 - pows[1:].sum()

    return (mixed * np.sqrt(pows)[:, None, None]).astype(probe.dtype)
