"""The circular mask with a soft sigmoid edge.

Counterpart of ptyrad_tpu/ops/masks.py. The sigmoid mask is used by the
probe k-space constraint (probe_mask_k) and the kr object filter.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
