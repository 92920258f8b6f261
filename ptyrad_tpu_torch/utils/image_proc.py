"""Background fitting for the measurement pad (host-side NumPy).

The port's own copy of the part of ptyrad_tpu/utils/image_proc.py that the
on-the-fly pad needs (:17-24, :127-157): radial exponential and power-law
decays fitted to the dimmest pixels of the mean diffraction amplitude.
"""

from __future__ import annotations

import numpy as np


def exponential_decay(r, a, b):
    return a * np.exp(-b * r)


def power_law(r, a, b):
    return a * r**-b


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
