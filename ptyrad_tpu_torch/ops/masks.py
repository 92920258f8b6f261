"""Circular masks with soft edges.

Counterpart of ptyrad_tpu/ops/masks.py. The sigmoid mask (torch) is used by
the probe k-space constraint (probe_mask_k) and the kr object filter; the
Gaussian-blurred mask (host-side NumPy and scipy) is the model of the CBED
fit (utils/image_proc.fit_cbed_pattern).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def make_sigmoid_mask(npix: int, relative_radius: float = 2.0 / 3.0,
                      relative_width: float = 0.2,
                      center: Optional[Tuple[float, float]] = None,
                      device=None) -> torch.Tensor:
    """(npix, npix) float32 circular mask falling from 1 to 0 through a
    sigmoid: 0.5 at radius npix * relative_radius / 2, the transition about
    relative_width * npix pixels wide. ``device=None`` is the CPU."""
    if center is None:
        center = (npix // 2, npix // 2)
    k = torch.arange(npix, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(k, k, indexing="ij")
    kr = torch.sqrt((gy - center[0]) ** 2 + (gx - center[1]) ** 2)
    offset = npix * relative_radius / 2.0
    scale = relative_width * npix
    return 1.0 / (1.0 + torch.exp((kr - offset) / scale * 10.0))


def make_gaussian_mask(npix: int, radius: float, std: float,
                       center: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """(npix, npix) float64 binary disk of ``radius`` about ``center``
    (default the middle), blurred by a Gaussian of ``std`` pixels."""
    from scipy.ndimage import gaussian_filter

    if center is None:
        center = (npix / 2, npix / 2)
    y = np.arange(npix, dtype=np.float64)
    x = np.arange(npix, dtype=np.float64)
    gy, gx = np.meshgrid(y, x, indexing="ij")
    r = np.sqrt((gy - center[0]) ** 2 + (gx - center[1]) ** 2)
    circ = (r <= radius).astype(np.float64)
    return gaussian_filter(circ, sigma=std)
