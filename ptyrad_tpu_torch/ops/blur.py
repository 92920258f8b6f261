"""Separable Gaussian blurs with the sampled kernel of ptyrad_tpu/ops/blur.py:
replicate ('edge') padding in 1D, reflect padding in 2D."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@functools.lru_cache(maxsize=64)
def _kernel_np(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_last_axis(x: torch.Tensor, kernel: np.ndarray, pad_mode: str) -> torch.Tensor:
    size = kernel.shape[0]
    lo = (size - 1) // 2
    flat = x.reshape(-1, 1, x.shape[-1])
    flat = F.pad(flat, (lo, size - 1 - lo), mode=_PAD_MODES[pad_mode])
    k = torch.from_numpy(kernel).to(device=x.device, dtype=x.dtype).reshape(1, 1, size)
    return F.conv1d(flat, k).reshape(x.shape)


def gaussian_blur_1d(x: torch.Tensor, kernel_size: int = 5, sigma: float = 0.5,
                     pad_mode: str = "edge") -> torch.Tensor:
    """Gaussian blur along the last axis."""
    if sigma is None or sigma == 0:
        return x
    return _conv_last_axis(x, _kernel_np(int(kernel_size), float(sigma)), pad_mode)


def gaussian_blur_2d(x: torch.Tensor, kernel_size: int = 5, sigma: float = 0.5,
                     pad_mode: str = "reflect") -> torch.Tensor:
    """Separable Gaussian blur over the last two axes (any leading shape)."""
    if sigma is None or sigma == 0:
        return x
    k = _kernel_np(int(kernel_size), float(sigma))
    out = _conv_last_axis(x, k, pad_mode)
    out = _conv_last_axis(out.transpose(-1, -2), k, pad_mode)
    return out.transpose(-1, -2)
