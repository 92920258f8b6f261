"""2D Fourier transforms with the JAX package's conventions, on torch.fft.

ptyrad_tpu/ops/fourier.py computes these as DFT matrix products because the
TPU has no FFT; here they are plain ``torch.fft`` calls. ``norm=None`` is the
unnormalized forward / 1/N inverse pair (torch's "backward"), ``"ortho"`` the
unitary pair.
"""

from __future__ import annotations

import torch


def _norm(norm):
    if norm is None:
        return "backward"
    if norm == "ortho":
        return "ortho"
    raise ValueError(f"unsupported norm {norm!r}; use None or 'ortho'")


def fft2(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """2D DFT over the last two axes (real input is promoted to complex)."""
    return torch.fft.fft2(x, norm=_norm(norm))


def ifft2(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """2D inverse DFT over the last two axes."""
    return torch.fft.ifft2(x, norm=_norm(norm))


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """fftshift over the last two axes."""
    return torch.roll(x, (x.shape[-2] // 2, x.shape[-1] // 2), dims=(-2, -1))


def ifftshift2(x: torch.Tensor) -> torch.Tensor:
    """ifftshift over the last two axes (differs from fftshift for odd N)."""
    return torch.roll(x, (-(x.shape[-2] // 2), -(x.shape[-1] // 2)), dims=(-2, -1))


def fftn3(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """3D DFT over the last three axes (the kz-filter constraint);
    unnormalized forward, 1/(Nz Ny Nx) inverse."""
    fn = torch.fft.ifftn if inverse else torch.fft.fftn
    return fn(x, dim=(-3, -2, -1), norm="backward")
