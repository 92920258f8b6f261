"""Differentiable mixed-state multislice forward model (functions on tensors).

Counterpart of ptyrad_tpu/models/forward.py. A batch of probe modes
interacts with cropped object patches slice by slice; between slices the wave
propagates by the angular-spectrum propagator H; the exit wave goes to the
detector with an orthonormal 2D FFT; incoherent probe/object modes sum in
intensity.

The training path is ``fused_loss_terms`` where its shapes allow: the
loss_single data term folded into the multislice chain (kernel B3 on CUDA,
N <= 128). Otherwise the solver takes ``forward`` + ``combined_loss``.
``forward`` dispatches as the JAX package does, on both devices: the plain
fused chain (``multislice_dp_fused``, kernel B4 on CUDA) for the fused
kernels' shapes, looped over object modes; else the segmented chain
(``multislice_dp_chain``, B5/B6) for patches up to 512^2. On the CPU each of
them runs its plain torch.fft version, so the CPU tests cover the dispatch
the card runs. Outside both rules a CUDA tensor raises and the CPU runs
``multislice_dp``, the eager torch.fft chain that is also the oracle.
"""

from __future__ import annotations

import torch

from ptyrad_tpu_torch.losses import loss_simlar, loss_sparse, merge_loss_params
from ptyrad_tpu_torch.models.state import Buffers, Geometry, PtychoParams
from ptyrad_tpu_torch.ops.blur import gaussian_blur_2d
from ptyrad_tpu_torch.ops.chain import chain_applicable_shapes, multislice_dp_chain
from ptyrad_tpu_torch.ops.fourier import fft2, fftshift2, ifft2, ifftshift2
from ptyrad_tpu_torch.ops.fused_multislice import (fused_applicable_shapes,
                                                    multislice_dp_fused,
                                                    multislice_loss_sums_fused)
from ptyrad_tpu_torch.ops.patches import extract_patches
from ptyrad_tpu_torch.ops.shift import fourier_shift, fourier_shift_kspace


def _expi(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(x), torch.sin(x))


def get_obj_patches(params: PtychoParams, buffers: Buffers, geom: Geometry,
                    indices: torch.Tensor):
    """Per-position (obja, objp) patches, each (B, omode, Nz, Ny, Nx) float32,
    with the optional lateral pre-blur."""
    pos = buffers.crop_pos[indices]
    obja = extract_patches(params.obja, pos, geom.probe_shape)
    objp = extract_patches(params.objp, pos, geom.probe_shape)
    std = geom.obj_preblur_std
    if std is not None and std != 0:
        obja = gaussian_blur_2d(obja, kernel_size=5, sigma=std)
        objp = gaussian_blur_2d(objp, kernel_size=5, sigma=std)
    return obja, objp


def get_probes(params: PtychoParams, geom: Geometry, indices: torch.Tensor) -> torch.Tensor:
    """Per-position probes (B, pmode, Ny, Nx), sub-pixel shifted when
    positions are optimized; else the shared (1, pmode, Ny, Nx) probe."""
    if geom.shift_probes:
        return fourier_shift(params.probe, params.probe_pos_shifts[indices])
    return params.probe[None]


def compute_propagators(params: PtychoParams, buffers: Buffers, geom: Geometry,
                        indices: torch.Tensor) -> torch.Tensor:
    """Inter-slice propagators, complex (1 or B, Ny, Nx):
    base = exp(i dz Kz) if dz is optimizable else the precomputed H, times
    exp(i dz (Ky tan ty + Kx tan tx)) when tilts are active (global or
    per position)."""
    dz = params.slice_thickness
    base = _expi(dz * buffers.Kz) if geom.change_thickness else buffers.H
    if not geom.tilt_obj:
        return base[None]
    tilts = params.obj_tilts if geom.global_tilt else params.obj_tilts[indices]
    ty = torch.tan(tilts[:, 0, None, None] / 1e3)
    tx = torch.tan(tilts[:, 1, None, None] / 1e3)
    return base[None] * _expi(dz * (buffers.Ky[None] * ty + buffers.Kx[None] * tx))


def multislice_dp(obja_patches: torch.Tensor, objp_patches: torch.Tensor,
                  probes: torch.Tensor, H: torch.Tensor, omode_occu: torch.Tensor,
                  eps: float = 1e-10) -> torch.Tensor:
    """Far-field intensity (B, Ny, Nx): incoherent sum over (pmode, omode) of
    |fftshift(fft2(psi, ortho))|^2 weighted by omode_occu, plus eps.

    obja/objp_patches (B, omode, Nz, Ny, Nx); probes (B or 1, pmode, Ny, Nx);
    H (B or 1, Ny, Nx) corner-centred.
    """
    n_slices = obja_patches.shape[2]
    psi = probes[:, :, None]       # (B|1, pmode, 1, Ny, Nx): broadcasts over omode
    hb = H[:, None, None]
    for z in range(n_slices):
        a, phi = obja_patches[:, :, z], objp_patches[:, :, z]
        psi = psi * torch.complex(a * torch.cos(phi), a * torch.sin(phi))[:, None]
        if z < n_slices - 1:
            psi = ifft2(hb * fft2(psi))
    psi_k = fftshift2(fft2(psi, norm="ortho"))
    intensity = psi_k.real ** 2 + psi_k.imag ** 2   # (B, pmode, omode, Ny, Nx)
    return (intensity * omode_occu[:, None, None]).sum(dim=(1, 2)) + eps


def _batch_shapes(params: PtychoParams, geom: Geometry, indices: torch.Tensor):
    """(b, omode, nz, ny, nx, probe_b, pmode, h_b) of a batch, the
    arguments of the applicability rules, from the static geometry, so a
    route is chosen before any patch is gathered."""
    b = indices.shape[0]
    (omode, nz), (ny, nx) = geom.obj_shape[:2], geom.probe_shape
    h_b = b if geom.tilt_obj and not geom.global_tilt else 1
    return (b, omode, nz, ny, nx, b if geom.shift_probes else 1, params.probe.shape[0], h_b)


def forward_route(params: PtychoParams, geom: Geometry, indices: torch.Tensor) -> str:
    """Which chain forward() runs for a batch: "fused" (multislice_dp_fused,
    B4 on CUDA), "chain" (multislice_dp_chain, B5/B6) or "plain"
    (multislice_dp, the CPU only), decided from the static geometry. Raises
    on CUDA for shapes that neither kernel rule takes."""
    b, omode, nz, ny, nx, probe_b, pmode, h_b = _batch_shapes(params, geom, indices)
    if fused_applicable_shapes(b, omode, nz, ny, nx, probe_b, pmode, h_b):
        return "fused"
    if chain_applicable_shapes(b, omode, nz, ny, nx, pmode, h_b):
        return "chain"
    if params.obja.device.type != "cpu":
        raise NotImplementedError(
            f"forward() on CUDA: {ny}x{nx} patches fit neither the fused kernels nor the "
            "chain kernels (square, N a power of two <= 512)")
    return "plain"


def forward(params: PtychoParams, buffers: Buffers, geom: Geometry, indices: torch.Tensor):
    """(dp, (obja_patches, objp_patches)) for a batch of scan indices.

    The dispatch of ptyrad_tpu/models/forward.py:155-225 under the card's
    own rules (forward_route). The fused route hands the kernel the shifted
    probe spectrum when positions are optimized (the inverse transform runs
    inside it), loops over object modes weighted by omode_occu, then applies
    fftshift and eps to the sum.
    """
    route = forward_route(params, geom, indices)
    obja_p, objp_p = get_obj_patches(params, buffers, geom, indices)
    H = compute_propagators(params, buffers, geom, indices)
    need_dh = geom.change_thickness or geom.tilt_obj
    if route == "fused":
        if geom.shift_probes:
            probe = fourier_shift_kspace(params.probe, params.probe_pos_shifts[indices])
        else:
            probe = params.probe[None]
        raw = None
        for om in range(obja_p.shape[1]):
            dp_om = multislice_dp_fused(obja_p[:, om:om + 1], objp_p[:, om:om + 1], probe, H,
                                        need_dh=need_dh, probe_kspace=geom.shift_probes)
            contrib = buffers.omode_occu[om] * dp_om
            raw = contrib if raw is None else raw + contrib
        dp = fftshift2(raw) + geom.eps
    elif route == "chain":
        dp = multislice_dp_chain(obja_p, objp_p, get_probes(params, geom, indices), H,
                                 buffers.omode_occu, geom.eps, need_dh=need_dh)
    else:
        dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, indices), H,
                           buffers.omode_occu, eps=geom.eps)
    std = geom.detector_blur_std
    if std is not None and std != 0:
        dp = gaussian_blur_2d(dp, kernel_size=5, sigma=std)
    return dp, (obja_p, objp_p)


def get_measurements(buffers: Buffers, geom: Geometry, indices: torch.Tensor) -> torch.Tensor:
    """Measured patterns (B, Ky, Kx) for a batch of scan indices, embedded
    in the fitted background canvas when they are padded on the fly
    (ptyrad_tpu/models/forward.py:344-349), so the padded dataset never
    sits on the device."""
    meas = buffers.measurements[indices]
    if geom.meas_pad_idx is not None:
        h1, h2, w1, w2 = geom.meas_pad_idx
        canvas = buffers.meas_padded.expand(meas.shape[0], *geom.meas_padded_shape).clone()
        canvas[:, h1:h2, w1:w2] = meas
        meas = canvas
    return meas


def fused_loss_terms(params: PtychoParams, buffers: Buffers, geom: Geometry,
                     indices: torch.Tensor, mask, loss_params):
    """(total, terms) with the loss_single data term folded into the
    multislice chain (B3), or None when the configuration is out of regime:
    loss_single must be the only dp-dependent term, with no detector blur,
    one object mode and shapes that fused_applicable_shapes takes (as
    ptyrad_tpu/models/forward.py:271-276). The caller then uses forward() +
    combined_loss, which give the same numbers.

    The chain returns the corner-centred partial sums, so the measurements are
    ifftshifted to match (pixel sums are permutation-invariant). The single
    object mode's weight omode_occu[0] is folded into the probe as its square
    root: dp is quadratic in psi.
    """
    cfg = merge_loss_params(loss_params)
    if (not cfg["loss_single"]["state"] or cfg["loss_poissn"]["state"]
            or cfg["loss_pacbed"]["state"]):
        return None
    std = geom.detector_blur_std
    if std is not None and std != 0:
        return None

    shapes = _batch_shapes(params, geom, indices)
    b, omode = shapes[:2]
    if omode != 1 or not fused_applicable_shapes(*shapes):
        return None
    obja_p, objp_p = get_obj_patches(params, buffers, geom, indices)
    H = compute_propagators(params, buffers, geom, indices)
    h_differentiable = geom.change_thickness or geom.tilt_obj

    occu_root = torch.sqrt(buffers.omode_occu[0])
    if geom.shift_probes:
        probe = fourier_shift_kspace(params.probe, params.probe_pos_shifts[indices],
                                     scale=occu_root)
        kspace = True
    else:
        probe = params.probe[None] * occu_root
        kspace = False

    meas_cc = ifftshift2(get_measurements(buffers, geom, indices))
    mask_b = mask if mask is not None else torch.ones(b, dtype=torch.float32,
                                                      device=obja_p.device)
    sp = cfg["loss_single"]
    s1, s2 = multislice_loss_sums_fused(
        obja_p, objp_p, probe, H, meas_cc, mask_b, float(sp.get("dp_pow", 0.5)),
        float(geom.eps), need_dh=h_differentiable, probe_kspace=kspace,
    )
    denom = obja_p.shape[3] * obja_p.shape[4] * mask_b.sum()
    single = sp["weight"] * torch.sqrt(s1 / denom) / (s2 / denom)

    zero = torch.zeros((), dtype=torch.float32, device=obja_p.device)
    terms = {
        "loss_single": single,
        "loss_poissn": zero,
        "loss_pacbed": zero,
        "loss_sparse": (loss_sparse(objp_p, buffers.omode_occu, cfg["loss_sparse"], mask)
                        if cfg["loss_sparse"]["state"] else zero),
        "loss_simlar": (loss_simlar(obja_p, objp_p, buffers.omode_occu, cfg["loss_simlar"], mask)
                        if cfg["loss_simlar"]["state"] else zero),
    }
    return sum(terms.values()), terms
