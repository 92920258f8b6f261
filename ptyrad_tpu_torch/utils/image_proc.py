"""Host-side image analysis for initialization and diagnostics (NumPy, scipy).

The port's own copy of ptyrad_tpu/utils/image_proc.py: centre of mass,
radial blob-size metrics (d50/d90/FWHM/rms), the bright-field-disk radius
estimate and the CBED fit of the calibration, the radial background fits of
the measurement pad, blob detection and local object tilts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ptyrad_tpu_torch.utils.logging import vprint


def exponential_decay(r, a, b):
    return a * np.exp(-b * r)


def power_law(r, a, b):
    return a * r**-b


def center_of_mass(image: np.ndarray, corner_centered: bool = False):
    """CoM of a 2D/3D stack over the last two axes; returns (cy, cx)."""
    ny, nx = image.shape[-2:]
    if corner_centered:
        gy, gx = np.meshgrid(np.fft.fftfreq(ny, 1 / ny), np.fft.fftfreq(nx, 1 / nx), indexing="ij")
    else:
        gy, gx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    total = image.sum(axis=(-2, -1)).mean()
    cy = (gy * image).sum(axis=(-2, -1)) / total
    cx = (gx * image).sum(axis=(-2, -1)) / total
    return cy, cx


def radial_profile(data: np.ndarray, center: Tuple[float, float]):
    """Radially averaged profile and un-normalized radial sum, 1-px bins."""
    y, x = np.indices(data.shape)
    r = np.sqrt((x - center[1]) ** 2 + (y - center[0]) ** 2).astype(int)
    tbin = np.bincount(r.ravel(), data.ravel())
    nr = np.bincount(r.ravel())
    return tbin / np.maximum(nr, 1), tbin


def get_blob_size(dx: float, blob: np.ndarray, output: str = "d90", verbose: bool = False):
    """Blob-diameter metrics from the radial profile: d50/d90/d99/FWHM/rms.

    d-N is the diameter enclosing N% of the total intensity, in the units of
    dx.
    """
    prof, rsum = radial_profile(blob, (len(blob) // 2, len(blob) // 2))
    x = np.arange(len(prof))
    radius_rms = np.sqrt(np.sum(x**2 * prof * x) / np.sum(prof * x))
    hwhm = np.max(np.where(prof / prof.max() >= 0.5))
    csum = np.cumsum(rsum)

    def d_of(frac):
        return 2 * np.min(np.where(csum >= frac * csum[-1])[0]) + 1

    metrics = {
        "d50": d_of(0.50) * dx, "d90": d_of(0.90) * dx, "d99": d_of(0.99) * dx,
        "d995": d_of(0.995) * dx, "d999": d_of(0.999) * dx,
        "FWHM": (2 * hwhm + 1) * dx, "radius_rms": radius_rms * dx,
        "radial_profile": prof, "radial_sum": rsum,
    }
    if output not in metrics:
        raise ValueError(f"output '{output}' not supported; choose from {list(metrics)}")
    out = metrics[output]
    if verbose and output not in ("radial_profile", "radial_sum"):
        vprint(f"{output} = {out / dx:.3f} px or {out:.3f}")
    return out


def guess_radius_of_bright_field_disk(image: np.ndarray, thresh: float = 0.5) -> float:
    """RBF estimate: radius of the above-threshold area assuming a circular
    bright-field disk."""
    binary = image > image.max() * thresh
    return float(np.sqrt(binary.sum() / np.pi))


def fit_cbed_pattern(image: np.ndarray, initial_guess: Optional[dict] = None, verbose: bool = False) -> dict:
    """Fit (center, radius, edge-blur std) of a CBED disk by L-BFGS-B on the
    MSE against a Gaussian-blurred circular mask; from a grid of shifted
    starts when the first fit fails or leaves an MSE above 0.01."""
    from scipy.optimize import minimize

    from ptyrad_tpu_torch.ops.masks import make_gaussian_mask

    npix = image.shape[0]
    assert image.shape[0] == image.shape[1], "Only square CBED patterns supported"
    image = image / image.max()

    def loss(p):
        y0, x0, r, std = p
        model = make_gaussian_mask(npix, radius=r, std=std, center=(y0, x0))
        return float(np.mean((image - model) ** 2))

    if initial_guess is None:
        cy, cx = center_of_mass(image)
        p0 = [float(cy), float(cx), guess_radius_of_bright_field_disk(image), 0.5]
    else:
        c = initial_guess.get("center", (npix / 2, npix / 2))
        p0 = [c[0], c[1], initial_guess.get("radius", npix / 4), initial_guess.get("std", 0.5)]

    bounds = [(0, npix - 1), (0, npix - 1), (1, npix / 2), (0, 5)]
    result = minimize(loss, p0, bounds=bounds, method="L-BFGS-B", options={"maxiter": 1000})

    if not result.success or result.fun > 0.01:
        best = result
        for sy in np.linspace(-npix / 10, npix / 10, 5):
            for sx in np.linspace(-npix / 10, npix / 10, 5):
                r2 = minimize(
                    loss, [p0[0] + sy, p0[1] + sx, p0[2], p0[3]],
                    bounds=bounds, method="L-BFGS-B", options={"maxiter": 1000},
                )
                if r2.fun < best.fun:
                    best = r2
        result = best

    y0, x0, r, std = result.x
    if verbose:
        vprint(f"CBED fit: center=({y0:.2f}, {x0:.2f}), radius={r:.2f}, blur std={std:.2f}")
    return {"center": (y0, x0), "radius": r, "std": std, "success": result.success, "fun": result.fun}


def create_one_hot_mask(image: np.ndarray, percentile: float) -> np.ndarray:
    """Mask of the dimmest ``percentile`` % pixels: the background region
    used for the fit."""
    threshold = np.percentile(image, percentile)
    return (image <= threshold).astype(int)


def fit_background(image: np.ndarray, mask: np.ndarray, fit_type: str = "exp"):
    """Fit a radial exp or power-law decay (about the image centre) to the
    masked pixels; returns the fit parameters (a, b)."""
    from scipy.optimize import curve_fit

    y, x = np.indices(image.shape)
    center = np.array(image.shape) // 2
    r = np.sqrt((x - center[1]) ** 2 + (y - center[0]) ** 2) + 1e-10
    masked_r = r[mask == 1]
    masked_v = image[mask == 1]
    models = {"exp": (exponential_decay, 0.1), "power": (power_law, 1)}
    if fit_type not in models:
        raise ValueError("fit_type must be 'exp' or 'power'")
    model, b0 = models[fit_type]
    popt, _ = curve_fit(model, masked_r, masked_v, p0=[np.max(masked_v), b0],
                        bounds=([0, 0], [np.inf, np.inf]), maxfev=10000)
    return popt


def detect_blobs(image: np.ndarray, min_sigma: float = 1.0, max_sigma: float = 5.0,
                 num_sigma: int = 5, threshold: float = 0.1) -> np.ndarray:
    """Laplacian-of-Gaussian blob detection (scipy; in place of
    skimage.feature.blob_log).

    Returns (n, 3) array of (y, x, sigma) for local maxima of the
    scale-normalized -LoG response above `threshold`.
    """
    from scipy.ndimage import gaussian_laplace, maximum_filter

    sigmas = np.linspace(min_sigma, max_sigma, num_sigma)
    cube = np.stack([-(s**2) * gaussian_laplace(image.astype(float), s) for s in sigmas])
    peaks = (cube == maximum_filter(cube, size=3)) & (cube > threshold)
    zyx = np.argwhere(peaks)
    if len(zyx) == 0:
        return np.zeros((0, 3))
    return np.stack([zyx[:, 1], zyx[:, 2], sigmas[zyx[:, 0]]], axis=1)


def get_local_obj_tilts(
    objp: np.ndarray, dx: float, slice_thickness: float, slice_indices,
    blob_params: dict | None = None, window_size: int = 9,
):
    """Estimate per-column local object tilts from atomic-column shifts
    between two slices (an analysis helper).

    objp: (Nz, Ny, Nx) phase volume. Returns (coords_top (n,2),
    tilt_yx_mrad (n,2), tilt_maps (2, Ny, Nx) cubic-interpolated).
    """
    from scipy.interpolate import griddata
    from scipy.ndimage import center_of_mass as ndi_com

    slice_t, slice_b = slice_indices
    height = (slice_b - slice_t) * slice_thickness
    top, bot = objp[slice_t], objp[slice_b]
    blobs = detect_blobs(top, **(blob_params or {}))
    if len(blobs) == 0:
        raise ValueError("No atomic columns detected; adjust blob_params")

    half = window_size // 2
    coord_t, coord_b = [], []
    for y, x, _s in blobs:
        r0, r1 = int(y) - half, int(y) + half + 1
        c0, c1 = int(x) - half, int(x) + half + 1
        if r0 < 0 or c0 < 0 or r1 > top.shape[0] or c1 > top.shape[1]:
            continue
        ct = np.asarray(ndi_com(np.clip(top[r0:r1, c0:c1], 0, None))) + [r0, c0]
        cb = np.asarray(ndi_com(np.clip(bot[r0:r1, c0:c1], 0, None))) + [r0, c0]
        coord_t.append(ct)
        coord_b.append(cb)
    if not coord_t:
        raise ValueError(
            f"All {len(blobs)} detected columns fall within window_size//2 = "
            f"{half} px of the image edge; shrink window_size or adjust "
            "blob_params"
        )
    coord_t = np.asarray(coord_t)
    coord_b = np.asarray(coord_b)
    shift = coord_b - coord_t  # px, (dy, dx) per column

    tilts = np.arctan(shift * dx / height) * 1e3  # mrad, (tilt_y, tilt_x)

    ynew, xnew = np.mgrid[0:top.shape[0], 0:top.shape[1]]
    maps = np.stack([
        griddata(coord_t, tilts[:, i], (ynew, xnew), method="cubic")
        for i in range(2)
    ])
    return coord_t, tilts, maps
