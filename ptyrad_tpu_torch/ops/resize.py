"""Resampling of the last two axes: bilinear (optionally intensity-conserving)
and area downsampling.

Counterpart of ptyrad_tpu/ops/resize.py, which builds weight matrices to
reproduce ``torch.nn.functional.interpolate``; here that function is called
directly. Its conventions are the contract: the output size is
floor(n * scale), and coordinates map with the passed scale factor
(src = (dst + 0.5) / s - 0.5, ``recompute_scale_factor=False``), not with
the ratio of the sizes. Used for the on-the-fly measurement resample
(models.forward.get_measurements) and the loss_simlar area downsample.
Plain PyTorch on either device: the JAX module sits outside every kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def out_size(n: int, s: float) -> int:
    """floor(n * s): the size F.interpolate(scale_factor=s) gives, which
    the initializer's meas_Npix must agree with."""
    return int(math.floor(n * s))


def _as_images(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1, x.shape[-2], x.shape[-1])


def bilinear_resize(x: torch.Tensor, scale_factor) -> torch.Tensor:
    """Bilinear resize of the last two axes by (sy, sx), align_corners=False,
    no antialiasing."""
    sy, sx = (float(s) for s in scale_factor)
    if sy == 1.0 and sx == 1.0:
        return x
    ny, nx = out_size(x.shape[-2], sy), out_size(x.shape[-1], sx)
    out = F.interpolate(_as_images(x), scale_factor=(sy, sx), mode="bilinear",
                        align_corners=False, recompute_scale_factor=False)
    return out.reshape(*x.shape[:-2], ny, nx)


def bilinear_resize_conserve(x: torch.Tensor, scale_factor) -> torch.Tensor:
    """Bilinear resize, then divide by sy * sx so the integrated intensity
    is conserved."""
    sy, sx = scale_factor
    return bilinear_resize(x, scale_factor) / (float(sy) * float(sx))


def area_downsample(x: torch.Tensor, scale_factor) -> torch.Tensor:
    """torch mode='area': adaptive average pooling of the last two axes to
    floor(n * s), exact for non-divisible sizes."""
    ny, nx = out_size(x.shape[-2], scale_factor[0]), out_size(x.shape[-1], scale_factor[1])
    return F.adaptive_avg_pool2d(_as_images(x), (ny, nx)).reshape(*x.shape[:-2], ny, nx)
