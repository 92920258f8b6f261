"""Sub-pixel Fourier shifting of image batches.

Keeps the signed-frequency convention of ptyrad_tpu/ops/shift.py:16-52: the
ramp is w = exp(-2i*pi*(sy*fy + sx*fx)) with fy, fx = fftfreq in [-1/2, 1/2),
so integer shifts are exact rolls and real images stay real.
"""

from __future__ import annotations

import numpy as np
import torch

from ptyrad_tpu_torch.ops.fourier import fft2, ifft2


def shift_grid(ny: int, nx: int, device=None) -> torch.Tensor:
    """Signed-frequency grid (cycles/pixel), shape (2, Ny, Nx), corner layout."""
    fy = torch.from_numpy(np.fft.fftfreq(ny).astype(np.float32))
    fx = torch.from_numpy(np.fft.fftfreq(nx).astype(np.float32))
    gy, gx = torch.meshgrid(fy, fx, indexing="ij")
    return torch.stack([gy, gx], dim=0).to(device)


def fourier_shift_kspace(img: torch.Tensor, shifts: torch.Tensor, scale=None) -> torch.Tensor:
    """The shifted SPECTRUM: fft2(img) times the phase ramp, (B, ..., Ny, Nx).

    img: complex or real (..., Ny, Nx), broadcast over the batch of shifts.
    shifts: (B, 2) pixel shifts (shift_y, shift_x); positive moves down/right.
    scale: optional real scalar folded into the ramp (sqrt(omode_occu) for
    the loss-folded chain, models/forward.py:fused_loss_terms).
    """
    ny, nx = img.shape[-2], img.shape[-1]
    grid = shift_grid(ny, nx, device=img.device)
    ndim = img.dim()
    s = shifts.reshape(shifts.shape[0], 2, *([1] * ndim))
    sy, sx = s[:, 0], s[:, 1]
    gy = grid[0].reshape(*([1] * (ndim - 1)), ny, nx)
    gx = grid[1].reshape(*([1] * (ndim - 1)), ny, nx)
    phase = -2.0 * np.pi * (sx * gx + sy * gy)
    w = torch.complex(torch.cos(phase), torch.sin(phase))
    if scale is not None:
        w = w * scale
    return fft2(img) * w


def fourier_shift(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Shift `img` by a batch of sub-pixel displacements; complex (B, ..., Ny, Nx)."""
    return ifft2(fourier_shift_kspace(img, shifts))
