"""Loss terms comparing forward diffraction patterns with measurements.

Counterpart of ptyrad_tpu/losses.py. Every term takes an optional
per-sample ``mask`` (B,) so that padded batches give exactly the unpadded
means (0 = padding sample).

  loss_single : NRMSE of DP^p (Gaussian statistics, p=0.5 typical)
  loss_poissn : normalized Poisson NLL of DP^p
  loss_pacbed : NRMSE of batch-averaged DP^p
  loss_sparse : Ln-norm sparsity of object-phase patches, omode-weighted
  loss_simlar : std across object modes of (blurred/downsampled) patches

Every term also takes an optional ``group`` (parallel.DataGroup): its
inputs are then the rank's slice of the batch, and the batch sums (the mask
count included) are summed over the ranks before any sqrt, power or
division, so each rank gets the whole batch's term (what XLA's psum does
under the JAX package's mesh). With ``group`` None the terms compute what
they computed before ranks existed, bit for bit.

and ``objp_contrast``, hypertune's ``contrast`` error metric, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ptyrad_tpu_torch.ops.blur import gaussian_blur_2d
from ptyrad_tpu_torch.ops.resize import area_downsample
from ptyrad_tpu_torch.parallel.mesh import all_reduce_sum

DEFAULT_LOSS_PARAMS = {
    "loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
    "loss_poissn": {"state": False, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
    "loss_pacbed": {"state": False, "weight": 0.5, "dp_pow": 0.2},
    "loss_sparse": {"state": False, "weight": 0.1, "ln_order": 1},
    "loss_simlar": {
        "state": False,
        "weight": 0.1,
        "obj_type": "both",
        "blur_std": 1.0,
        "scale_factor": [1.0, 1.0],
    },
}


def merge_loss_params(loss_params):
    """Per-term merge over DEFAULT_LOSS_PARAMS; unknown term names raise (a
    typo would otherwise drop the term silently)."""
    user = loss_params or {}
    unknown = set(user) - set(DEFAULT_LOSS_PARAMS)
    if unknown:
        raise ValueError(
            f"Unknown loss term(s) {sorted(unknown)}; "
            f"expected {sorted(DEFAULT_LOSS_PARAMS)}"
        )
    return {
        k: {**DEFAULT_LOSS_PARAMS[k], **(user.get(k) or {})}
        for k in DEFAULT_LOSS_PARAMS
    }


def _ones_mask(x, mask):
    return mask if mask is not None else torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


def _bmean(x, mask, group=None):
    """Mean over all axes, weighting the batch (first) axis by mask. With a
    group (parallel.DataGroup) x is the rank's slice of the batch, and the
    weighted sum and the sample count are summed over the ranks first."""
    if group is not None:
        mask = _ones_mask(x, mask)
        w = mask.reshape(mask.shape[0], *([1] * (x.dim() - 1)))
        per_sample = x[0].numel()
        num, den = all_reduce_sum(torch.stack([(x * w).sum(), mask.sum() * per_sample]), group)
        return num / den
    if mask is None:
        return x.mean()
    w = mask.reshape(mask.shape[0], *([1] * (x.dim() - 1)))
    return (x * w).mean() * (x.shape[0] / mask.sum())


def _bavg_dp(dp, mask, group=None):
    """Batch-averaged pattern with mask weighting (PACBED); over every
    rank's slice with a group."""
    if group is not None:
        mask = _ones_mask(dp, mask)
        total = all_reduce_sum(torch.cat([(dp * mask.reshape(-1, 1, 1)).sum(0).reshape(-1),
                                          mask.sum().reshape(1)]), group)
        return total[:-1].reshape(dp.shape[1:]) / total[-1]
    if mask is None:
        return dp.mean(0)
    return (dp * mask.reshape(-1, 1, 1)).sum(0) / mask.sum()


def loss_single(model_dp, measured_dp, params, mask=None, group=None):
    p = params.get("dp_pow", 0.5)
    data_mean = _bmean(measured_dp**p, mask, group)
    mse = _bmean((model_dp**p - measured_dp**p) ** 2, mask, group)
    return params["weight"] * torch.sqrt(mse) / data_mean


def loss_poissn(model_dp, measured_dp, params, mask=None, group=None):
    p = params.get("dp_pow", 1.0)
    eps = params.get("eps", 1e-6)
    data_mean = _bmean(measured_dp**p, mask, group)
    nll = -_bmean(measured_dp**p * torch.log(model_dp**p + eps) - model_dp**p, mask, group)
    return params["weight"] * nll / data_mean


def loss_pacbed(model_dp, measured_dp, params, mask=None, group=None):
    p = params.get("dp_pow", 0.2)
    data_mean = _bmean(measured_dp**p, mask, group)
    mse = ((_bavg_dp(model_dp, mask, group) ** p
            - _bavg_dp(measured_dp, mask, group) ** p) ** 2).mean()
    return params["weight"] * torch.sqrt(mse) / data_mean


def loss_sparse(objp_patches, omode_occu, params, mask=None, group=None):
    """Per-mode voxel-wise mean of |phi|^n over (batch, z, y, x), then ^(1/n),
    then the omode_occu-weighted sum; with a group the per-mode sums and the
    sample count are summed over the ranks before the power."""
    n = params["ln_order"]
    # |phi| with d|phi|/dphi = 1 at phi = 0, as jnp.abs differentiates (torch's
    # abs gives 0 there): a flat initial object has phi = 0 everywhere, so the
    # first Adam step depends on it
    absn = torch.where(objp_patches >= 0, objp_patches, -objp_patches) ** n
    if group is not None:
        mask = _ones_mask(absn, mask)
        sums = all_reduce_sum(torch.cat([
            (absn * mask.reshape(-1, 1, 1, 1, 1)).sum(dim=(0, 2, 3, 4)),
            mask.sum().reshape(1)]), group)
        voxels = absn.shape[2] * absn.shape[3] * absn.shape[4]
        per_mode = (sums[:-1] / (sums[-1] * voxels)) ** (1.0 / n)
    elif mask is None:
        per_mode = absn.mean(dim=(0, 2, 3, 4)) ** (1.0 / n)
    else:
        w = mask.reshape(-1, 1, 1, 1, 1)
        per_mode = ((absn * w).sum(dim=(0, 2, 3, 4))
                    / (mask.sum() * absn.shape[2] * absn.shape[3] * absn.shape[4])) ** (1.0 / n)
    return params["weight"] * (per_mode * omode_occu).sum()


def loss_simlar(obja_patches, objp_patches, omode_occu, params, mask=None, group=None):
    """Cross-omode similarity: unbiased std over the omode axis after optional
    blur and area downsample; 0 for a single object mode."""
    obj_type = params.get("obj_type", "both")
    blur_std = params.get("blur_std")
    scale = params.get("scale_factor")

    def term(patches):
        if patches.shape[1] == 1:
            return torch.zeros((), dtype=patches.dtype, device=patches.device)
        if blur_std is not None and blur_std != 0:
            patches = gaussian_blur_2d(patches, kernel_size=5, sigma=blur_std)
        if scale is not None and any(s != 1 for s in scale):
            patches = area_downsample(patches, tuple(scale))
        weighted = patches * omode_occu[:, None, None, None]
        return _bmean(weighted.std(dim=1, correction=1), mask, group)

    total = torch.zeros((), dtype=obja_patches.dtype, device=obja_patches.device)
    if obj_type in ("amplitude", "both"):
        total = total + term(obja_patches)
    if obj_type in ("phase", "both"):
        total = total + term(objp_patches)
    return params["weight"] * total


def combined_loss(model_dp, measured_dp, obja_patches, objp_patches, omode_occu,
                  loss_params, mask=None, group=None):
    """Weighted sum of the five terms. Returns (total, per-term dict);
    disabled terms contribute exact zeros. With a group (parallel.DataGroup)
    the inputs are the rank's slice of the batch and every term is the
    whole batch's, on every rank."""
    zero = torch.zeros((), dtype=torch.float32, device=model_dp.device)
    cfg = merge_loss_params(loss_params)
    terms = {
        "loss_single": (loss_single(model_dp, measured_dp, cfg["loss_single"], mask, group)
                        if cfg["loss_single"]["state"] else zero),
        "loss_poissn": (loss_poissn(model_dp, measured_dp, cfg["loss_poissn"], mask, group)
                        if cfg["loss_poissn"]["state"] else zero),
        "loss_pacbed": (loss_pacbed(model_dp, measured_dp, cfg["loss_pacbed"], mask, group)
                        if cfg["loss_pacbed"]["state"] else zero),
        "loss_sparse": (loss_sparse(objp_patches, omode_occu, cfg["loss_sparse"], mask, group)
                        if cfg["loss_sparse"]["state"] else zero),
        "loss_simlar": (loss_simlar(obja_patches, objp_patches, omode_occu,
                                    cfg["loss_simlar"], mask, group)
                        if cfg["loss_simlar"]["state"] else zero),
    }
    return sum(terms.values()), terms


def objp_contrast(objp, crop_pos, probe_shape, indices=None) -> float:
    """Contrast (std/mean) of the z-summed phase inside the scanned region,
    on host arrays (ptyrad_tpu/losses.py:187-210; reference losses.py:158-175).

    The object modes are averaged first: the reference's .squeeze() leaves a
    3D array for omode > 1 and its 2D crop then slices the (omode, Noy)
    axes; the metric is only meaningful on a 2D phase map.
    """
    objp_sum = np.asarray(objp).sum(axis=1).mean(axis=0)  # (Noy, Nox)
    pos = np.asarray(crop_pos)
    if indices is not None:
        pos = pos[np.asarray(indices)]
    center = pos + np.array(probe_shape) // 2
    y0, y1 = center[:, 0].min(), center[:, 0].max()
    x0, x1 = center[:, 1].min(), center[:, 1].max()
    crop = objp_sum[max(y0 - 1, 0):y1, max(x0 - 1, 0):x1]
    lo, hi = crop.min(), crop.max()
    norm = (crop - lo) / (hi - lo) if hi > lo else crop * 0
    return float(np.std(norm) / (np.mean(norm) + 1e-8))
