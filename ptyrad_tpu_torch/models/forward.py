"""Differentiable mixed-state multislice forward model (functions on tensors).

Counterpart of ptyrad_tpu/models/forward.py. A batch of probe modes
interacts with cropped object patches slice by slice; between slices the wave
propagates by the angular-spectrum propagator H; the exit wave goes to the
detector with an orthonormal 2D FFT; incoherent probe/object modes sum in
intensity.

The training path is ``fused_loss_terms`` where its shapes allow: the
loss_single data term folded into the multislice chain (kernel B3 on CUDA,
N <= 128). Otherwise the solver takes ``forward`` + ``combined_loss``.
``forward`` dispatches as the JAX package does, on both devices
(``forward_route``, from the static shapes before any work): the plain
fused chain (``multislice_dp_fused``, kernel B4 on CUDA) for the fused
kernels' shapes (every square N up to 128), looped over object modes; else
the segmented chain (``multislice_dp_chain``, B5/B6) for square patches of
N up to 512 (256 and 512 through chain.cu's power-of-two plans, any other N
in (128, 512] through its mixed-radix build); else ``multislice_dp``, the
eager torch.fft chain, the counterpart of the JAX package's XLA path (and
the kernels' oracle), on the CPU and the card alike: non-square patches or
N > 512. ``model_params.fwd_fused: false`` takes that route for every
shape and turns ``fused_loss_terms`` off, as in the JAX package. On the CPU
each route runs its plain torch.fft version, so the CPU tests cover the
dispatch the card runs.

Optimizable slice thickness or tilts (need_dh) make the propagator H
depend on parameters, and a per-position tilt makes it (B, N, N): every
kernel takes both, and its backward returns dH whenever H requires a
gradient, for autograd to carry on to dz and the tilts. One route differs
from the JAX package: at tBL shapes with per-position probes the JAX
package declines B3 under need_dh (its VMEM model gives 13.77 MB against a
13 MiB budget) and runs B4, while the card's rule keeps B3 (dH goes
through device scratch); the numbers are the same either way.

The bfloat16 compute policy (``geom.compute_dtype`` / ``geom.bf16_operands``,
models/state.py:resolve_compute_policy) reaches every route, which it does
not change: with ``bf16_operands`` each DFT pass rounds its operand to
bfloat16, in the kernels (B3-B6) and in the float32 transforms outside them
(the probe shift, the chain's far field, the plain chain); with
``compute_dtype`` 'bfloat16' the plain route also keeps its wavefield in
bfloat16 between ops, as ptyrad_tpu/models/forward.py:110-136 does.
Parameters, gradients, dp and the loss stay float32.

Each phase of a batch runs under a span of utils/tracing.py:
``ptyrad.model.patches`` (B1), ``.probe`` (the probe or its shift),
``.propagators``, ``.measurements`` (the store's rows, padded and resampled
on the fly), ``.multislice`` (the route's chain) and ``.loss`` (the terms;
combined_loss's under the solver's loss_fn).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ptyrad_tpu_torch.losses import loss_simlar, loss_sparse, merge_loss_params
from ptyrad_tpu_torch.models.state import Buffers, Geometry, PtychoParams
from ptyrad_tpu_torch.ops.blur import gaussian_blur_2d
from ptyrad_tpu_torch.ops.chain import chain_applicable_shapes, multislice_dp_chain
from ptyrad_tpu_torch.ops.fourier import fft2, fftshift2, ifft2, ifftshift2, round_bf16
from ptyrad_tpu_torch.ops.fused_multislice import (fused_applicable_shapes,
                                                    multislice_dp_fused,
                                                    multislice_loss_sums_fused)
from ptyrad_tpu_torch.ops.patches import extract_patch_pair
from ptyrad_tpu_torch.ops.resize import bilinear_resize_conserve
from ptyrad_tpu_torch.ops.shift import fourier_shift, fourier_shift_kspace
from ptyrad_tpu_torch.parallel.mesh import all_reduce_sum
from ptyrad_tpu_torch.utils.tracing import span


def _expi(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(x), torch.sin(x))


def get_obj_patches(params: PtychoParams, buffers: Buffers, geom: Geometry,
                    indices: torch.Tensor):
    """Per-position (obja, objp) patches, each (B, omode, Nz, Ny, Nx) float32,
    with the optional lateral pre-blur."""
    with span("ptyrad.model.patches"):
        pos = buffers.crop_pos[indices]
        obja, objp = extract_patch_pair(params.obja, params.objp, pos, geom.probe_shape)
        std = geom.obj_preblur_std
        if std is not None and std != 0:
            obja = gaussian_blur_2d(obja, kernel_size=5, sigma=std)
            objp = gaussian_blur_2d(objp, kernel_size=5, sigma=std)
    return obja, objp


def get_probes(params: PtychoParams, geom: Geometry, indices: torch.Tensor) -> torch.Tensor:
    """Per-position probes (B, pmode, Ny, Nx), sub-pixel shifted when
    positions are optimized; else the shared (1, pmode, Ny, Nx) probe."""
    with span("ptyrad.model.probe"):
        if geom.shift_probes:
            return fourier_shift(params.probe, params.probe_pos_shifts[indices],
                                 bf16_operands=geom.bf16_operands)
        return params.probe[None]


def tilt_ramp(Ky: torch.Tensor, Kx: torch.Tensor, tilts: torch.Tensor, dz) -> torch.Tensor:
    """exp(i dz (Ky tan ty + Kx tan tx)), complex (B, Ny, Nx), for tilts
    (B, 2) in mrad (ty, tx): the factor a crystal tilt puts on H."""
    ty = torch.tan(tilts[:, 0, None, None] / 1e3)
    tx = torch.tan(tilts[:, 1, None, None] / 1e3)
    return _expi(dz * (Ky[None] * ty + Kx[None] * tx))


def compute_propagators(params: PtychoParams, buffers: Buffers, geom: Geometry,
                        indices: torch.Tensor) -> torch.Tensor:
    """Inter-slice propagators, complex (1 or B, Ny, Nx):
    base = exp(i dz Kz) if dz is optimizable else the precomputed H, times
    exp(i dz (Ky tan ty + Kx tan tx)) when tilts are active (global or
    per position; tilt_ramp)."""
    with span("ptyrad.model.propagators"):
        dz = params.slice_thickness
        base = _expi(dz * buffers.Kz) if geom.change_thickness else buffers.H
        if not geom.tilt_obj:
            return base[None]
        tilts = params.obj_tilts if geom.global_tilt else params.obj_tilts[indices]
        return base[None] * tilt_ramp(buffers.Ky, buffers.Kx, tilts, dz)


def multislice_dp(obja_patches: torch.Tensor, objp_patches: torch.Tensor,
                  probes: torch.Tensor, H: torch.Tensor, omode_occu: torch.Tensor,
                  eps: float = 1e-10, compute_dtype: str = "float32",
                  bf16_operands: bool = False, remat: bool = False) -> torch.Tensor:
    """Far-field intensity (B, Ny, Nx): incoherent sum over (pmode, omode) of
    |fftshift(fft2(psi, ortho))|^2 weighted by omode_occu, plus eps.

    obja/objp_patches (B, omode, Nz, Ny, Nx); probes (B or 1, pmode, Ny, Nx);
    H (B or 1, Ny, Nx) corner-centred.

    compute_dtype 'bfloat16' (ptyrad_tpu/models/forward.py:110-136): the
    patches, probes and H are rounded to bfloat16 on entry, and so is each
    product, each polar factor and each transform's output, so the wavefield
    is bfloat16 between ops; the inter-slice transforms round their operands.
    The detector-plane transform then runs in float32 on float32 operands
    (the JAX package's exact=True), and the intensity and dp stay float32.
    The rounding's backward rounds the cotangent, as autodiff through
    bfloat16 ops does. bf16_operands alone rounds the operand of every
    transform pass, the detector plane's included.

    remat (ptyrad_tpu/models/forward.py:118-125): each of the Nz - 1 slice
    steps runs under a non-reentrant checkpoint, so the backward keeps only
    each step's input wavefield and recomputes the step's intermediates
    (the transmission, its cos and sin, the spectrum) from it. The same
    operations run in the same order, so dp and every gradient are the
    same with or without it; the last slice's multiply and the
    detector-plane transform stay outside the checkpoint.
    """
    low = compute_dtype == "bfloat16"
    ops = bf16_operands or low
    rnd = round_bf16 if low else (lambda t: t)
    if low:
        obja_patches, objp_patches = round_bf16(obja_patches), round_bf16(objp_patches)
        probes, H = round_bf16(probes), round_bf16(H)

    def transmit(psi, a, phi):
        t = torch.complex(rnd(a * rnd(torch.cos(phi))), rnd(a * rnd(torch.sin(phi))))
        return rnd(psi * t[:, None])

    def step(psi, a, phi, hb):
        k = rnd(fft2(transmit(psi, a, phi), bf16_operands=ops))
        return rnd(ifft2(rnd(hb * k), bf16_operands=ops))

    n_slices = obja_patches.shape[2]
    psi = probes[:, :, None]       # (B|1, pmode, 1, Ny, Nx): broadcasts over omode
    hb = H[:, None, None]
    for z in range(n_slices - 1):
        a, phi = obja_patches[:, :, z], objp_patches[:, :, z]
        if remat:
            psi = checkpoint(step, psi, a, phi, hb, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            psi = step(psi, a, phi, hb)
    psi = transmit(psi, obja_patches[:, :, -1], objp_patches[:, :, -1])
    psi_k = fftshift2(fft2(psi, norm="ortho", bf16_operands=bf16_operands and not low))
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
    """Which chain forward() runs for a batch, decided from the static
    geometry on either device: "fused" (multislice_dp_fused, B4 on CUDA:
    every square N <= 128), "chain" (multislice_dp_chain, B5/B6: every
    square N in (128, 512], a power of two or not) or "plain"
    (multislice_dp, the eager torch.fft chain of the JAX package's XLA
    path) when fwd_fused is off or the shapes fit neither kernel rule
    (ptyrad_tpu/models/forward.py:155-221): non-square patches, N > 512, or
    an H batch neither 1 nor B."""
    if not geom.fwd_fused:
        return "plain"
    b, omode, nz, ny, nx, probe_b, pmode, h_b = _batch_shapes(params, geom, indices)
    if fused_applicable_shapes(b, omode, nz, ny, nx, probe_b, pmode, h_b):
        return "fused"
    if chain_applicable_shapes(b, omode, nz, ny, nx, pmode, h_b):
        return "chain"
    return "plain"


def forward(params: PtychoParams, buffers: Buffers, geom: Geometry, indices: torch.Tensor):
    """(dp, (obja_patches, objp_patches)) for a batch of scan indices.

    The dispatch of ptyrad_tpu/models/forward.py:155-225 under the card's
    own rules (forward_route). The fused route hands the kernel the shifted
    probe spectrum when positions are optimized (the inverse transform runs
    inside it), loops over object modes weighted by omode_occu, then applies
    fftshift and eps to the sum. With optimizable dz or tilts (need_dh) the
    kernels' backwards return dH, shared or per position.
    ``forward.launches_plain`` counts the calls that took the plain route.
    """
    route = forward_route(params, geom, indices)
    obja_p, objp_p = get_obj_patches(params, buffers, geom, indices)
    H = compute_propagators(params, buffers, geom, indices)
    if route == "fused":
        with span("ptyrad.model.probe"):
            if geom.shift_probes:
                probe = fourier_shift_kspace(params.probe, params.probe_pos_shifts[indices],
                                             bf16_operands=geom.bf16_operands)
            else:
                probe = params.probe[None]
        with span("ptyrad.model.multislice"):
            raw = None
            for om in range(obja_p.shape[1]):
                dp_om = multislice_dp_fused(obja_p[:, om:om + 1], objp_p[:, om:om + 1], probe,
                                            H, probe_kspace=geom.shift_probes,
                                            bf16_operands=geom.bf16_operands)
                contrib = buffers.omode_occu[om] * dp_om
                raw = contrib if raw is None else raw + contrib
            dp = fftshift2(raw) + geom.eps
    elif route == "chain":
        probes = get_probes(params, geom, indices)
        with span("ptyrad.model.multislice"):
            dp = multislice_dp_chain(obja_p, objp_p, probes, H, buffers.omode_occu, geom.eps,
                                     bf16_operands=geom.bf16_operands)
    else:
        probes = get_probes(params, geom, indices)
        with span("ptyrad.model.multislice"):
            dp = multislice_dp(obja_p, objp_p, probes, H, buffers.omode_occu, eps=geom.eps,
                               compute_dtype=geom.compute_dtype,
                               bf16_operands=geom.bf16_operands, remat=geom.fwd_remat)
        forward.launches_plain += 1
    std = geom.detector_blur_std
    if std is not None and std != 0:
        dp = gaussian_blur_2d(dp, kernel_size=5, sigma=std)
    return dp, (obja_p, objp_p)


forward.launches_plain = 0


def get_measurements(buffers: Buffers, geom: Geometry, indices: torch.Tensor,
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Measured patterns (B, Ky, Kx) float32 for a batch of scan indices
    (ptyrad_tpu/models/forward.py:339-352): the batch alone is upcast from
    the store's type, embedded in the fitted background canvas when the data
    are padded on the fly, then resampled bilinearly with its intensity
    conserved, so neither the float32, the padded nor the resampled dataset
    ever sits on the device. A store kept on the host (the canvas path's
    whole store) is read there, the batch alone moved. ``rows``: the batch's
    rows of the store, already fetched (a store split over ranks gives them
    through parallel.exchange_rows), which a split store requires."""
    with span("ptyrad.model.measurements"):
        if rows is None:
            if buffers.store_split is not None:
                raise ValueError("the measurement store is split over ranks "
                                 "(shard_measurements): pass the batch's rows, fetched with "
                                 "parallel.exchange_rows")
            store = buffers.measurements
            rows = store[indices.to(store.device)]
        meas = rows.to(device=indices.device, dtype=torch.float32)
        if geom.meas_pad_idx is not None:
            h1, h2, w1, w2 = geom.meas_pad_idx
            canvas = buffers.meas_padded.expand(meas.shape[0], *geom.meas_padded_shape).clone()
            canvas[:, h1:h2, w1:w2] = meas
            meas = canvas
        scale = geom.meas_scale_factors
        if scale is not None and any(s != 1 for s in scale):
            meas = bilinear_resize_conserve(meas, scale)
    if tuple(meas.shape[-2:]) != tuple(geom.probe_shape):
        raise ValueError(
            f"measured patterns are {tuple(meas.shape[-2:])} after the on-the-fly pad/resample "
            f"but the probe is {tuple(geom.probe_shape)}: the forward pattern would not "
            "match them")
    return meas


def propagated_probe(params: PtychoParams, buffers: Buffers, geom: Geometry,
                     index: torch.Tensor) -> torch.Tensor:
    """The probe at each slice's entry, complex (Nz, pmode, Ny, Nx), for the
    saved ``probe_prop`` image (ptyrad_tpu/models/forward.py:355): the probe
    of scan position ``index[0]`` propagated slice by slice in free space
    (no object). torch.fft on either device; no kernel; bfloat16 operands
    under geom.bf16_operands."""
    probe = get_probes(params, geom, index)[0]
    H = compute_propagators(params, buffers, geom, index)[0]
    slices = []
    psi = probe
    ops = geom.bf16_operands
    for _ in range(geom.obj_shape[1]):
        slices.append(psi)
        psi = ifft2(H[None] * fft2(psi, bf16_operands=ops), bf16_operands=ops)
    return torch.stack(slices, dim=0)


def fused_loss_terms(params: PtychoParams, buffers: Buffers, geom: Geometry,
                     indices: torch.Tensor, mask, loss_params, group=None, rows=None):
    """(total, terms) with the loss_single data term folded into the
    multislice chain (B3), or None when the configuration is out of regime:
    fwd_fused on, loss_single the only dp-dependent term, no detector blur,
    one object mode and shapes that fused_applicable_shapes takes (as
    ptyrad_tpu/models/forward.py:254-276). The caller then uses forward() +
    combined_loss, which give the same numbers.

    The chain returns the corner-centred partial sums, so the measurements are
    ifftshifted to match (pixel sums are permutation-invariant). The single
    object mode's weight omode_occu[0] is folded into the probe as its square
    root: dp is quadratic in psi. With optimizable dz or tilts B3b returns
    dH too, for a shared or per-position H.

    With a group (parallel.DataGroup) ``indices`` and ``mask`` are the
    rank's slice of the batch: s1, s2 and the mask count are summed over
    the ranks before loss_single is formed (the psum of
    ptyrad_tpu/ops/pallas_multislice.py:678-680), and loss_sparse and
    loss_simlar take the group too. ``rows``: the batch's store rows, as
    get_measurements takes them.
    """
    cfg = merge_loss_params(loss_params)
    if (not cfg["loss_single"]["state"] or cfg["loss_poissn"]["state"]
            or cfg["loss_pacbed"]["state"]):
        return None
    if not geom.fwd_fused:
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

    with span("ptyrad.model.probe"):
        occu_root = torch.sqrt(buffers.omode_occu[0])
        if geom.shift_probes:
            probe = fourier_shift_kspace(params.probe, params.probe_pos_shifts[indices],
                                         scale=occu_root, bf16_operands=geom.bf16_operands)
            kspace = True
        else:
            probe = params.probe[None] * occu_root
            kspace = False

    meas = get_measurements(buffers, geom, indices, rows)
    mask_b = mask if mask is not None else torch.ones(b, dtype=torch.float32,
                                                      device=obja_p.device)
    sp = cfg["loss_single"]
    with span("ptyrad.model.multislice"):
        s1, s2 = multislice_loss_sums_fused(
            obja_p, objp_p, probe, H, ifftshift2(meas), mask_b, float(sp.get("dp_pow", 0.5)),
            float(geom.eps), probe_kspace=kspace, bf16_operands=geom.bf16_operands,
        )
    with span("ptyrad.model.loss"):
        if group is None:
            denom = obja_p.shape[3] * obja_p.shape[4] * mask_b.sum()
        else:
            s1, s2, count = all_reduce_sum(torch.stack([s1, s2, mask_b.sum()]), group)
            denom = obja_p.shape[3] * obja_p.shape[4] * count
        single = sp["weight"] * torch.sqrt(s1 / denom) / (s2 / denom)

        zero = torch.zeros((), dtype=torch.float32, device=obja_p.device)
        terms = {
            "loss_single": single,
            "loss_poissn": zero,
            "loss_pacbed": zero,
            "loss_sparse": (loss_sparse(objp_p, buffers.omode_occu, cfg["loss_sparse"], mask,
                                        group)
                            if cfg["loss_sparse"]["state"] else zero),
            "loss_simlar": (loss_simlar(obja_p, objp_p, buffers.omode_occu, cfg["loss_simlar"],
                                        mask, group)
                            if cfg["loss_simlar"]["state"] else zero),
        }
        return sum(terms.values()), terms
