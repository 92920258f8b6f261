"""Drive the PyTorch/CUDA port (ptyrad_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line each:
  1. device  - the card, torch and CUDA versions; TF32 off.
  2. build   - nvcc builds the kernels of ptyrad_tpu_torch/csrc into
               ptyrad_tpu_torch/_build (seconds).
  3. kernels - each kernel against its plain PyTorch version at its main
               path's shapes (B1-B4 at tBL_WSe2's, B5/B6 at PSO's), with its
               error, tolerance and CUDA-event times (median of 20 runs after
               warm-up) beside the plain version's, one PyTorch call's where
               one computes the same function, and the bound from bytes and
               operations.
  4. main    - the tBL_WSe2 reconstruction through PtyRADSolver.run(): 16,384
               128^2 patterns simulated through forward() (B4a; every 8th
               batch held against the plain multislice_dp), 6 probe modes, 6
               slices, batch 32, Adam, loss_single + loss_sparse, the six tBL
               constraints, 3 iterations from a flat object. Asserts a
               finite, falling loss and that every kernel of the path ran
               during the run.
  5. profile - torch.profiler over 32 more tBL training steps: device time by
               kernel, the device's busy share, host time per step.
     forward - one forward() of a batch with 2 object modes, shifted probes
               and detector blur (B4a, and B4b under autograd) against the
               plain multislice_dp, values and gradients.
     low-dose - the same reconstruction with the low-dose loss mix
               (loss_poissn + loss_pacbed of demo/scripts/run_parity_midscale.py
               plus loss_sparse) on the patterns normalised as the yml asks
               (max at one): fused_loss_terms declines, so every step runs
               forward() (B4a), combined_loss and B4b. Asserts a finite loss,
               B1, B2, B4a and B4b launched and B3 not; then each data term
               alone for 2 iterations, where loss_poissn must fall; then its
               torch.profiler breakdown over 32 more steps.
  6. pso     - the PSO reconstruction (demo/params/PSO_reconstruct.yml)
               through PtyRADSolver.run(): 4,096 patterns simulated at 256^2,
               cropped to the central 120^2 and padded back to 256^2 on the
               fly, 4 probe modes, 21 slices, batch 32, the yml's Adam rates,
               loss_single, its five constraints, 2 iterations from a flat
               object. Asserts a finite, falling loss, that B1, B2, B5a/b and
               B6a/b ran and B3 did not; then one no-grad forward() of a batch
               (the yml's "forward" figure) against the plain multislice_dp.
  7. profile - torch.profiler over 8 more PSO training steps.
Then a {"kernels": [...]} line (launches summed over the three paths), the
nvidia-smi name/power-limit line, and as the last line {"ok": true,
"device": {...}}. Any failed check raises, so the exit code is not 0 and the
last line is never printed. Exits non-zero at once without CUDA.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and FP32
# (non-tensor-core) operations/s; used for each kernel's bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

N_SIDE, STEP_PX, NPIX, PMODE, NZ, BATCH = 128, 3, 128, 6, 6, 32
N_SCANS = N_SIDE * N_SIDE
NITER = 3
SEED = 0

# PSO (demo/params/PSO_reconstruct.yml): 64 x 64 scan at 0.41 Ang steps,
# 256^2 patterns cropped to [68, 188)^2 and padded on the fly to 256^2,
# 300 kV, 21.4 mrad, defocus -200 Ang, 4 probe modes, 21 slices of 10 Ang.
# dx = 0.15 Ang puts the bright-field disk (radius 1.087 1/Ang, 42 px)
# inside the 120^2 crop.
PSO_SIDE, PSO_NPIX, PSO_PMODE, PSO_NZ, PSO_DZ, PSO_DX = 64, 256, 4, 21, 10.0, 0.15
PSO_KV, PSO_STEP_ANG, PSO_CROP = 300.0, 0.41, (68, 188)
PSO_SCANS = PSO_SIDE * PSO_SIDE
PSO_NITER = 2
PSO_SG = 8  # ops.chain.best_sg(21): 21 = 2 x 8 + 5
SIM_BATCH = 512  # patterns per forward() call when simulating the tBL data

# tBL_WSe2 sections of demo/params/tBL_WSe2_reconstruct.yml (the card's
# machine has no yaml reader)
TBL_PARAMS = {
    "model_params": {
        "optimizer_params": {"name": "Adam"},
        "update_params": {
            "obja": {"start_iter": 1, "lr": 5.0e-4},
            "objp": {"start_iter": 1, "lr": 5.0e-4},
            "probe": {"start_iter": 1, "lr": 1.0e-4},
            "probe_pos_shifts": {"start_iter": 10, "lr": 1.0e-4},
            "obj_tilts": {"start_iter": None, "lr": 0},
            "slice_thickness": {"start_iter": None, "lr": 0},
        },
    },
    "loss_params": {
        "loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1},
    },
    "constraint_params": {
        "ortho_pmode": {"freq": 1},
        "fix_probe_int": {"freq": 1},
        "obj_rblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5},
        "obj_zblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 1.0},
        "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
        "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
    },
    "recon_params": {
        "NITER": NITER,
        "BATCH_SIZE": {"size": BATCH},
        "GROUP_MODE": "random",
        "GROUP_MODE_SEED": SEED,
    },
}


# The low-dose loss surface: POISSN_LOSS of demo/scripts/run_parity_midscale.py
# (:252-259) plus the tBL yml's loss_sparse, on the tBL sections otherwise
LOW_DOSE_PARAMS = {
    **TBL_PARAMS,
    "loss_params": {
        "loss_single": {"state": False, "weight": 0.0, "dp_pow": 0.5},
        "loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
        "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2},
        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1},
    },
}


PSO_PARAMS = {
    "model_params": {
        "optimizer_params": {"name": "Adam"},
        "update_params": {
            "obja": {"start_iter": 1, "lr": 5.0e-4},
            "objp": {"start_iter": 1, "lr": 5.0e-4},
            "probe": {"start_iter": 1, "lr": 1.0e-4},
            "probe_pos_shifts": {"start_iter": 10, "lr": 1.0e-4},
            "obj_tilts": {"start_iter": None, "lr": 0},
            "slice_thickness": {"start_iter": None, "lr": 0},
        },
    },
    "loss_params": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}},
    "constraint_params": {
        "ortho_pmode": {"freq": 1},
        "fix_probe_int": {"freq": 1},
        "kz_filter": {"freq": 1, "obj_type": "both", "beta": 1.0, "alpha": 1.0},
        "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
        "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
    },
    "recon_params": {
        "NITER": PSO_NITER,
        "BATCH_SIZE": {"size": BATCH},
        "GROUP_MODE": "random",
        "GROUP_MODE_SEED": SEED,
    },
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tbl_probe() -> np.ndarray:
    from ptyrad_tpu_torch.physics import make_mixed_probe, make_stem_probe

    probe = make_stem_probe({"kv": 80.0, "conv_angle": 24.9, "Npix": NPIX, "dx": 0.1494})
    return make_mixed_probe(probe, PMODE, [0.02])


def tbl_positions() -> tuple[np.ndarray, int]:
    canvas = N_SIDE * STEP_PX + NPIX + 8
    ys, xs = np.meshgrid(np.arange(N_SIDE) * STEP_PX, np.arange(N_SIDE) * STEP_PX,
                         indexing="ij")
    return np.stack([ys.ravel() + 4, xs.ravel() + 4], -1).astype(np.int32), canvas


# -- phase 3: kernels against their plain versions ---------------------------

def check_patches(dev, gen) -> list:
    from ptyrad_tpu_torch.ops import patches as P

    _, canvas_side = tbl_positions()
    L, H, W = PMODE, canvas_side, canvas_side
    canvas = torch.rand((1, L, H, W), generator=gen, device=dev)
    pos = torch.randint(0, H - NPIX + 1, (BATCH, 2), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = torch.tensor([H - NPIX + 9, W - NPIX + 3])  # past the last corner: clamped
    pos[1] = torch.tensor([-4, 7])                        # negative: clamped
    pos[3] = pos[2]                                       # duplicate window
    pos[4] = pos[2]
    shape = (NPIX, NPIX)

    out_k = P.gather_cuda(canvas, pos, shape)
    out_p = P.gather_plain(canvas, pos, shape)
    err_g = float((out_k - out_p).abs().max())
    iy, ix = P._clamped_index(pos, (H, W), shape)
    pos_np = pos.clamp(min=0).cpu().numpy()
    covered = np.zeros((H, W), bool)
    for y, x in np.minimum(pos_np, [H - NPIX, W - NPIX]):
        covered[y:y + NPIX, x:x + NPIX] = True
    g_bytes = 4 * (L * covered.sum() + out_k.numel()) + pos.numel() * 4
    g_bound, g_by = bound(g_bytes, 0)
    gather = {
        "name": "B1 gather_patches", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/patches.cu",
        "replaces": "ptyrad_tpu/ops/patches.py:136",
        "max_abs_err": err_g, "tolerance": 0.0,
        "ms": time_ms(lambda: P.gather_cuda(canvas, pos, shape)),
        "plain_ms": time_ms(lambda: P.gather_plain(canvas, pos, shape)),
        "library_ms": time_ms(lambda: canvas[..., iy, ix]),
        "bound_ms": g_bound, "bound_by": g_by,
    }
    emit({"phase": "kernel", **gather, "note": "bit-exact against advanced indexing"})
    require(err_g == 0.0, f"B1 gather differs from its plain version: {err_g}")

    grads = torch.randn((BATCH, 1, L, NPIX, NPIX), generator=gen, device=dev)
    cshape = (1, L, H, W)
    sc_k = P.scatter_add_cuda(cshape, grads, pos)
    sc_p = P.scatter_add_plain(cshape, grads, pos)
    err_s = float((sc_k - sc_p).abs().max())
    # atomics add the overlapping windows in a run-dependent order: compare at
    # float32 rounding of the largest sum, rtol 1e-5
    tol_s = 1e-5 * float(sc_p.abs().max())
    flat = ((torch.arange(L, device=dev)[:, None, None, None] * H + iy) * W + ix)
    flat = flat.expand(L, BATCH, NPIX, NPIX).reshape(-1)
    vals = grads[:, 0].transpose(0, 1).reshape(-1)
    s_bytes = 4 * (grads.numel() + L * H * W) + pos.numel() * 4
    s_bound, s_by = bound(s_bytes, grads.numel())
    scatter = {
        "name": "B2 scatter_add_patches", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/patches.cu",
        "replaces": "ptyrad_tpu/ops/patches.py:98",
        "max_abs_err": err_s, "tolerance": tol_s,
        "ms": time_ms(lambda: P.scatter_add_cuda(cshape, grads, pos)),
        "plain_ms": time_ms(lambda: P.scatter_add_plain(cshape, grads, pos)),
        "library_ms": time_ms(lambda: torch.zeros(L * H * W, device=dev).index_put_(
            (flat,), vals, accumulate=True)),
        "bound_ms": s_bound, "bound_by": s_by,
    }
    emit({"phase": "kernel", **scatter,
          "note": "atomics: order varies run to run; rtol 1e-5 of the largest sum"})
    require(err_s <= tol_s, f"B2 scatter differs from its plain version: {err_s} > {tol_s}")
    return [gather, scatter]


def _chain_flops(n: int, n_fft: int, nz: int) -> float:
    """FP32 operations of one wavefield's chain: n_fft 2D FFTs at
    10 N^2 log2 N each, plus the T and H complex products (6 each)."""
    nn = n * n
    return n_fft * 10 * nn * np.log2(n) + (2 * nz - 1) * 6 * nn


def check_loss_chain(dev, gen) -> list:
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n = NPIX
    lam = electron_wavelength(80.0)
    probe = torch.as_tensor(tbl_probe(), device=dev)
    h = torch.as_tensor(near_field_evolution((n, n), 0.1494, 2.0, lam), device=dev)[None]
    obja = 1.0 + 0.05 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    shifts = 0.3 * torch.randn((BATCH, 2), generator=gen, device=dev)
    meas = torch.rand((BATCH, n, n), generator=gen, device=dev) * 2e-4
    mask = torch.ones(BATCH, device=dev)
    mask[BATCH - 1] = 0.0  # a padded tail sample
    p, eps, c = 0.5, 1e-10, 0.7
    results = {}
    for kspace in (True, False):
        pr = fourier_shift_kspace(probe, shifts) if kspace else probe[None]
        args = (meas, mask, p, eps)
        s1k, s2k, dp = M.loss_sums_fwd_cuda(obja, objp, pr, h, *args, kspace)
        with torch.no_grad():
            s1p, s2p = M.loss_sums_plain(obja, objp, pr, h, *args, kspace)
        err_fwd = max(abs(float(s1k - s1p)), abs(float(s2k - s2p)))
        # float32 chains of 12 transforms by two FFT algorithms: rtol 1e-4
        tol_fwd = 1e-4 * max(abs(float(s1p)), abs(float(s2p)))

        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr)]
        s1_plain, _ = M.loss_sums_plain(*leaves, h, *args, kspace)
        cvec = torch.tensor(c, device=dev)
        g_plain = torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec, retain_graph=True)
        g_kern = M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p, eps, kspace)
        errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
        scales = [float(b.abs().max()) for b in g_plain]
        # 24 transforms and atomic mode sums: 1e-4 of each cotangent's largest entry
        tols = [1e-4 * s for s in scales]
        err_bwd = max(errs)
        emit({"phase": "kernel_check", "name": "B3 loss chain", "kspace": kspace,
              "s1": [float(s1k), float(s1p)], "s2": [float(s2k), float(s2p)],
              "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd,
              "bwd_max_abs_err": errs, "bwd_tolerance": tols,
              "bwd_names": ["d obja", "d objp", "d probe"]})
        require(err_fwd <= tol_fwd, f"B3a (kspace={kspace}) differs: {err_fwd} > {tol_fwd}")
        for name, e, t in zip(("obja", "objp", "probe"), errs, tols):
            require(e <= t, f"B3b d{name} (kspace={kspace}) differs: {e} > {t}")
        results[kspace] = (pr, dp, err_fwd, err_bwd, s1_plain, leaves, cvec)

    # times at the main path's case (per-position probe spectra)
    pr, dp, err_fwd, err_bwd, s1_plain, leaves, cvec = results[True]
    n_wave = BATCH * PMODE
    in_bytes = 4 * (obja.numel() + objp.numel() + meas.numel() + mask.numel()) \
        + 8 * (pr.numel() + h.numel())
    f_bound, f_by = bound(in_bytes + 8, n_wave * _chain_flops(n, 2 * NZ, NZ))
    b_bytes = in_bytes + 4 * dp.numel() + 4 * (obja.numel() + objp.numel()) + 8 * pr.numel()
    b_bound, b_by = bound(b_bytes, n_wave * 2 * _chain_flops(n, 2 * NZ, NZ))
    fwd = {
        "name": "B3a loss_sums_fwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:548",
        "max_abs_err": err_fwd,
        "ms": time_ms(lambda: M.loss_sums_fwd_cuda(obja, objp, pr, h, meas, mask, p, eps, True)),
        "plain_ms": time_ms(lambda: M.loss_sums_plain(obja, objp, pr, h, meas, mask, p, eps,
                                                      True)),
        "library_ms": None, "bound_ms": f_bound, "bound_by": f_by,
    }
    bwd = {
        "name": "B3b loss_sums_bwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:588",
        "max_abs_err": err_bwd,
        "ms": time_ms(lambda: M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p,
                                                   eps, True)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec,
                                                        retain_graph=True)),
        "library_ms": None, "bound_ms": b_bound, "bound_by": b_by,
    }
    for k in (fwd, bwd):
        emit({"phase": "kernel", **k, "note": "kspace probe, the main path's case"})
    return [fwd, bwd]


def check_dp_chain(dev, gen) -> list:
    """B4a/B4b against multislice_dp_plain and its autograd VJP at tBL
    shapes, for per-position probe spectra (the low-dose path's case, which
    is timed) and a shared real-space probe."""
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n = NPIX
    lam = electron_wavelength(80.0)
    probe = torch.as_tensor(tbl_probe(), device=dev)
    h = torch.as_tensor(near_field_evolution((n, n), 0.1494, 2.0, lam), device=dev)[None]
    obja = 1.0 + 0.05 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    shifts = 0.3 * torch.randn((BATCH, 2), generator=gen, device=dev)
    g = torch.randn((BATCH, n, n), generator=gen, device=dev)
    results = {}
    for kspace in (True, False):
        pr = fourier_shift_kspace(probe, shifts) if kspace else probe[None]
        dp_k = M.dp_fwd_cuda(obja, objp, pr, h, kspace)
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr)]
        dp_p = M.multislice_dp_plain(*leaves, h, kspace)
        err_fwd = float((dp_k - dp_p.detach()).abs().max())
        # float32 chains of 12 transforms by two FFT algorithms: 1e-4 of the
        # largest intensity, as for B3
        tol_fwd = 1e-4 * float(dp_p.detach().abs().max())
        g_plain = torch.autograd.grad(dp_p, leaves, grad_outputs=g, retain_graph=True)
        g_kern = M.dp_bwd_cuda(obja, objp, pr, h, g, kspace)
        errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
        # 24 transforms and atomic sums over modes (and over samples for a
        # shared probe), in a run-dependent order: 1e-4 of each cotangent's
        # largest entry
        tols = [1e-4 * float(b.abs().max()) for b in g_plain]
        emit({"phase": "kernel_check", "name": "B4 dp chain", "kspace": kspace,
              "shared_probe": not kspace, "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd,
              "bwd_max_abs_err": errs, "bwd_tolerance": tols,
              "bwd_names": ["d obja", "d objp", "d probe"]})
        require(err_fwd <= tol_fwd, f"B4a (kspace={kspace}) differs: {err_fwd} > {tol_fwd}")
        for name, e, t in zip(("obja", "objp", "probe"), errs, tols):
            require(e <= t, f"B4b d{name} (kspace={kspace}) differs: {e} > {t}")
        results[kspace] = (pr, err_fwd, max(errs), dp_p, leaves)

    pr, err_fwd, err_bwd, dp_p, leaves = results[True]
    n_wave = BATCH * PMODE
    in_bytes = 4 * (obja.numel() + objp.numel()) + 8 * (pr.numel() + h.numel())
    dp_bytes = 4 * g.numel()  # B4a's output, B4b's cotangent input
    f_bound, f_by = bound(in_bytes + dp_bytes, n_wave * _chain_flops(n, 2 * NZ, NZ))
    b_bytes = in_bytes + dp_bytes + 4 * (obja.numel() + objp.numel()) + 8 * pr.numel()
    b_bound, b_by = bound(b_bytes, n_wave * 2 * _chain_flops(n, 2 * NZ, NZ))
    fwd = {
        "name": "B4a dp_fwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:128",
        "max_abs_err": err_fwd,
        "ms": time_ms(lambda: M.dp_fwd_cuda(obja, objp, pr, h, True)),
        "plain_ms": time_ms(lambda: M.multislice_dp_plain(obja, objp, pr, h, True)),
        "library_ms": None, "bound_ms": f_bound, "bound_by": f_by,
    }
    bwd = {
        "name": "B4b dp_bwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:145",
        "max_abs_err": err_bwd,
        "ms": time_ms(lambda: M.dp_bwd_cuda(obja, objp, pr, h, g, True)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(dp_p, leaves, grad_outputs=g,
                                                        retain_graph=True)),
        "library_ms": None, "bound_ms": b_bound, "bound_by": b_by,
    }
    for k in (fwd, bwd):
        emit({"phase": "kernel", **k, "note": "kspace probe, the low-dose path's case"})
    return [fwd, bwd]


def pso_probe() -> np.ndarray:
    from ptyrad_tpu_torch.physics import make_mixed_probe, make_stem_probe

    probe = make_stem_probe({"kv": PSO_KV, "conv_angle": 21.4, "Npix": PSO_NPIX,
                             "dx": PSO_DX, "df": -200.0})
    return make_mixed_probe(probe, PSO_PMODE, [0.02])


def _chain_ops(n: int, n_wave: int, n_prop: int, n_t: int, n_adj_t: int = 0) -> float:
    """FP32 operations of a chain call: each propagation a 2D FFT and a 2D
    IFFT (10 N^2 log2 N each) and the H product (6 N^2); each T product
    6 N^2; each adjoint slice 12 N^2 (d chi conj(T) and d chi conj(psi))."""
    nn = n * n
    return n_wave * (n_prop * (20 * nn * np.log2(n) + 6 * nn) + n_t * 6 * nn
                     + n_adj_t * 12 * nn)


def check_chain(dev, gen) -> list:
    """B5a/B5b and B6a/B6b at the PSO shapes the main path gives them: B6
    over S = 2 segments of sg = 8 slices with a ragged tail after it
    (last_mega False), B5 over the 5-slice tail (last True; last False is
    checked too). The a/phi operands are views into (B, 1, 21, N, N)
    patches, as multislice_dp_chain passes them."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.shift import fourier_shift
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, b, pm = PSO_NPIX, BATCH, PSO_PMODE
    lam = electron_wavelength(PSO_KV)
    h = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
    probe = torch.as_tensor(pso_probe(), device=dev)
    psi = fourier_shift(probe, 0.3 * torch.randn((b, 2), generator=gen, device=dev))
    obja = 1.0 + 0.05 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    nz_main = 2 * PSO_SG
    a_main, p_main = obja[:, 0, :nz_main], objp[:, 0, :nz_main]
    a_tail, p_tail = obja[:, 0, nz_main:], objp[:, 0, nz_main:]
    g = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                      torch.randn(psi.shape, generator=gen, device=dev)) * float(psi.abs().max())

    def plain_vjp(fn, inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, grad_outputs=g, retain_graph=True)
        return out, leaves, grads

    def errs(actual, ref):
        # 1e-4 of the largest entry of each output or cotangent, as for B3
        e = [float((x - y).abs().max()) for x, y in zip(actual, ref)]
        t = [1e-4 * float(y.abs().max()) for y in ref]
        return e, t

    rows = []
    field = 8 * psi.numel()
    h_bytes = 8 * h.numel()

    def slice_bytes(k):
        return 2 * 4 * b * k * n * n  # a and phi

    # B6 over the uniform segments
    stack_fn = lambda x, y, z: C.chain_stack_plain(x, y, z, h, PSO_SG, False)  # noqa: E731
    out_k, stack = C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False)
    out_p, leaves, g_plain = plain_vjp(stack_fn, (psi, a_main, p_main))
    (e_f,), (t_f,) = errs([out_k], [out_p.detach()])
    g_kern = C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False)
    e_b, t_b = errs(g_kern, g_plain)
    emit({"phase": "kernel_check", "name": "B6 chain_stack", "S": 2, "sg": PSO_SG,
          "last_mega": False, "fwd_max_abs_err": e_f, "fwd_tolerance": t_f,
          "bwd_max_abs_err": e_b, "bwd_tolerance": t_b,
          "bwd_names": ["d psi0", "d a", "d phi"]})
    require(e_f <= t_f, f"B6a differs from its plain version: {e_f} > {t_f}")
    for name, e, t in zip(("psi0", "a", "phi"), e_b, t_b):
        require(e <= t, f"B6b d {name} differs from its plain version: {e} > {t}")
    b6a_bytes = field + slice_bytes(nz_main) + h_bytes + field + 2 * field
    b6b_bytes = field + 2 * field + slice_bytes(nz_main) + h_bytes + field + slice_bytes(nz_main)
    n_wave = b * pm
    rows.append({
        "name": "B6a chain_stack_fwd", "route": "cuda", "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:466", "max_abs_err": e_f,
        "ms": time_ms(lambda: C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False)),
        "plain_ms": time_ms(lambda: stack_fn(psi, a_main, p_main)),
        "library_ms": None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(b6a_bytes, _chain_ops(n, n_wave, nz_main, nz_main)))),
    })
    rows.append({
        "name": "B6b chain_stack_bwd", "route": "cuda", "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:529", "max_abs_err": max(e_b),
        "ms": time_ms(lambda: C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves, grad_outputs=g,
                                                        retain_graph=True)),
        "library_ms": None,
        # rebuild: S (sg - 1) propagations; walk: nz_main adjoint slices and
        # nz_main adjoint propagations (the last one undoes the exit's)
        **dict(zip(("bound_ms", "bound_by"),
                   bound(b6b_bytes, _chain_ops(n, n_wave, 2 * (PSO_SG - 1) + nz_main,
                                               2 * (PSO_SG - 1), nz_main)))),
    })
    del out_p, leaves, g_plain, stack

    # B5 over the ragged tail
    sg = PSO_NZ - nz_main
    for last in (False, True):
        seg_fn = lambda x, y, z, last=last: C.chain_segment_plain(x, y, z, h, last)  # noqa: E731
        out_k = C.segment_fwd_cuda(psi, a_tail, p_tail, h, last)
        out_p, leaves, g_plain = plain_vjp(seg_fn, (psi, a_tail, p_tail))
        (e_f,), (t_f,) = errs([out_k], [out_p.detach()])
        g_kern = C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, last)
        e_b, t_b = errs(g_kern, g_plain)
        emit({"phase": "kernel_check", "name": "B5 chain_segment", "sg": sg, "last": last,
              "fwd_max_abs_err": e_f, "fwd_tolerance": t_f, "bwd_max_abs_err": e_b,
              "bwd_tolerance": t_b, "bwd_names": ["d psi", "d a", "d phi"]})
        require(e_f <= t_f, f"B5a (last={last}) differs from its plain version: {e_f} > {t_f}")
        for name, e, t in zip(("psi", "a", "phi"), e_b, t_b):
            require(e <= t, f"B5b d {name} (last={last}) differs: {e} > {t}")
    # times at the main path's case: the chain's tail, last = True
    n_prop = sg - 1
    b5a_bytes = field + slice_bytes(sg) + h_bytes + field
    b5b_bytes = 2 * field + slice_bytes(sg) + h_bytes + field + slice_bytes(sg)
    rows.append({
        "name": "B5a chain_segment_fwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:238", "max_abs_err": e_f,
        "ms": time_ms(lambda: C.segment_fwd_cuda(psi, a_tail, p_tail, h, True)),
        "plain_ms": time_ms(lambda: seg_fn(psi, a_tail, p_tail)),
        "library_ms": None,
        **dict(zip(("bound_ms", "bound_by"), bound(b5a_bytes, _chain_ops(n, n_wave, n_prop, sg)))),
    })
    rows.append({
        "name": "B5b chain_segment_bwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": max(e_b),
        "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, True)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves, grad_outputs=g,
                                                        retain_graph=True)),
        "library_ms": None,
        # rebuild sg - 1 propagations; walk sg adjoint slices, sg - 1 propagations
        **dict(zip(("bound_ms", "bound_by"),
                   bound(b5b_bytes, _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg)))),
    })
    for k in rows:
        emit({"phase": "kernel", **k, "note": "PSO shapes; library_ms null: no single PyTorch "
              "call computes a segment, and the plain version is the cuFFT chain"})
    return rows


# -- phase 4: the main path -----------------------------------------------------

def ground_truth_phase(canvas: int) -> np.ndarray:
    """Sum of 300 Gaussian blobs (0.15 rad, variance 2 px^2) per slice at
    seeded random centres, as bench.build_workload draws them; each blob is
    evaluated in a 25^2 window, beyond which it is below 1e-15."""
    rng = np.random.default_rng(SEED)
    phase = np.zeros((NZ, canvas, canvas), np.float32)
    d = np.arange(-12, 13, dtype=np.float32)
    blob = 0.15 * np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / 4.0)
    for z in range(NZ):
        for _ in range(300):
            cy, cx = rng.integers(12, canvas - 12, 2)
            phase[z, cy - 12:cy + 13, cx - 12:cx + 13] += blob
    return phase


def simulate(dev, init: dict) -> torch.Tensor:
    """Measurements from the known object through the port's forward() under
    no_grad, as bench.py and demo/scripts/run_synthetic_demo.py simulate
    (set-up, not the path being driven): B4a in batches of SIM_BATCH. Every
    8th batch is held against the plain multislice_dp on the same patches
    within 1e-4 of its largest value."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, get_probes, make_model,
                                         multislice_dp)
    from ptyrad_tpu_torch.ops import fused_multislice as M

    params, buffers, geom = make_model(init, None, dev)
    meas = torch.empty((N_SCANS, NPIX, NPIX), dtype=torch.float32, device=dev)
    launches, checks = M.dp_fwd_cuda.launches, []
    t0 = time.perf_counter()
    with torch.no_grad():
        for k, start in enumerate(range(0, N_SCANS, SIM_BATCH)):
            idx = torch.arange(start, min(start + SIM_BATCH, N_SCANS), device=dev)
            dp, (obja_p, objp_p) = forward(params, buffers, geom, idx)
            meas[idx] = dp
            if k % 8 == 0:
                ref = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                                    compute_propagators(params, buffers, geom, idx),
                                    buffers.omode_occu, eps=geom.eps)
                checks.append((float((dp - ref).abs().max()), 1e-4 * float(ref.abs().max())))
    torch.cuda.synchronize()
    launches = M.dp_fwd_cuda.launches - launches
    emit({"phase": "simulate", "n_patterns": N_SCANS, "batch": SIM_BATCH,
          "seconds": time.perf_counter() - t0, "b4a_launches": launches,
          "checked_batches": len(checks), "max_abs_err": [e for e, _ in checks],
          "tolerance": [t for _, t in checks]})
    require(launches == -(-N_SCANS // SIM_BATCH), f"simulate ran B4a {launches} times")
    require(bool(torch.isfinite(meas).all()), "simulated measurements are not finite")
    for e, t in checks:
        require(e <= t, f"forward() differs from the plain multislice_dp: {e} > {t}")
    return meas


def kernel_counters():
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops import patches as P

    return {"B1 gather_patches": P.gather_cuda, "B2 scatter_add_patches": P.scatter_add_cuda,
            "B3a loss_sums_fwd": M.loss_sums_fwd_cuda, "B3b loss_sums_bwd": M.loss_sums_bwd_cuda,
            "B4a dp_fwd": M.dp_fwd_cuda, "B4b dp_bwd": M.dp_bwd_cuda,
            "B5a chain_segment_fwd": C.segment_fwd_cuda,
            "B5b chain_segment_bwd": C.segment_bwd_cuda,
            "B6a chain_stack_fwd": C.stack_fwd_cuda, "B6b chain_stack_bwd": C.stack_bwd_cuda}


TBL_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B3a loss_sums_fwd",
               "B3b loss_sums_bwd")
LOW_DOSE_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B4a dp_fwd", "B4b dp_bwd")
PSO_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B5a chain_segment_fwd",
               "B5b chain_segment_bwd", "B6a chain_stack_fwd", "B6b chain_stack_bwd")


def drive(solver) -> dict:
    """solver.run() with every launch count set to 0 just before it; the
    counts just after."""
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    solver.run()
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters.items()}


def main_path(dev, card: str):
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    t0 = time.perf_counter()
    crop_pos, canvas = tbl_positions()
    lam = electron_wavelength(80.0)
    true_obj = np.exp(1j * ground_truth_phase(canvas))[None].astype(np.complex64)
    init = {
        "obj": true_obj,
        "probe": tbl_probe(),
        "probe_pos_shifts": np.zeros((N_SCANS, 2), np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32),
        "slice_thickness": 2.0,
        "H": near_field_evolution((NPIX, NPIX), 0.1494, 2.0, lam),
        "measurements": np.zeros((1, NPIX, NPIX), np.float32),
        "crop_pos": crop_pos,
        "omode_occu": np.ones(1, np.float32),
        "dx": 0.1494,
        "lambd": lam,
        "N_scan_slow": N_SIDE,
        "N_scan_fast": N_SIDE,
    }
    init["measurements"] = simulate(dev, init)
    init["obj"] = np.ones_like(true_obj)
    setup_s = time.perf_counter() - t0

    solver = PtyRADSolver(TBL_PARAMS, init_variables=init, device=dev, verbose=True)
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1

    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    out = {
        "phase": "main", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [N_SCANS / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    }
    emit(out)
    require(len(losses) == NITER and all(np.isfinite(losses)), f"loss not finite: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the tBL path")
    return solver, launches, init


# -- the forward() figure and the low-dose path ---------------------------------

def forward_modes_check(dev, init: dict) -> None:
    """One forward() of a batch with 2 object modes (a random weak object),
    per-position shifted probes and detector blur: B4a per
    object mode, and B4b per mode under autograd, against the plain
    multislice_dp plus the same blur on the same CUDA tensors. dp within 1e-4
    of its largest value, each gradient within 1e-4 of its largest entry."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, forward_route,
                                         get_obj_patches, get_probes, make_model, multislice_dp)
    from ptyrad_tpu_torch.ops.blur import gaussian_blur_2d

    rng = np.random.default_rng(SEED + 2)
    shape = (2, *init["obj"].shape[1:])
    obj = (1.0 + 0.02 * rng.standard_normal(shape)) * np.exp(0.1j * rng.standard_normal(shape))
    two = dict(init, obj=obj.astype(np.complex64), omode_occu=np.array([0.7, 0.3], np.float32),
               probe_pos_shifts=(0.3 * rng.standard_normal((N_SCANS, 2))).astype(np.float32))
    mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}, "detector_blur_std": 0.5}
    idx = torch.arange(0, N_SCANS, N_SCANS // BATCH, device=dev)  # spread over the scan
    runs = []
    for route in ("kernels", "plain"):
        params, buffers, geom = make_model(two, mp, dev)
        for _, t in params.named():
            t.requires_grad_(True)
        if route == "kernels":
            require(forward_route(params, geom, idx) == "fused", "forward() left the B4 route")
            dp, _ = forward(params, buffers, geom, idx)
        else:
            obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                               compute_propagators(params, buffers, geom, idx),
                               buffers.omode_occu, eps=geom.eps)
            dp = gaussian_blur_2d(dp, kernel_size=5, sigma=geom.detector_blur_std)
        w = torch.rand(dp.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
        (w * dp).sum().backward()
        runs.append((dp.detach(), {n: t.grad for n, t in params.named() if t.grad is not None}))
    (dp_k, g_k), (dp_p, g_p) = runs
    err = float((dp_k - dp_p).abs().max())
    tol = 1e-4 * float(dp_p.abs().max())
    names = sorted(g_p)
    errs = [float((g_k[n] - g_p[n]).abs().max()) for n in names]
    tols = [1e-4 * float(g_p[n].abs().max()) for n in names]
    emit({"phase": "forward_modes", "omode": 2, "detector_blur_std": 0.5, "batch": BATCH,
          "finite": bool(torch.isfinite(dp_k).all()), "max_abs_err": err, "tolerance": tol,
          "grad_names": names, "grad_max_abs_err": errs, "grad_tolerance": tols})
    require(set(g_k) == set(g_p) == {"obja", "objp", "probe", "probe_pos_shifts"},
            f"gradients reached {sorted(g_k)} and {names}")
    require(bool(torch.isfinite(dp_k).all()) and err <= tol,
            f"forward() with 2 object modes differs from the plain version: {err} > {tol}")
    for name, e, t in zip(names, errs, tols):
        require(e <= t, f"forward() gradient of {name} differs: {e} > {t}")


def low_dose_dataset(init: dict) -> dict:
    """The tBL patterns as the Initializer hands them over under the yml's
    meas_normalization (max_at_one), with the probe scaled so its intensity
    equals the mean pattern sum (its _probe_normalize). loss_poissn's eps
    (1e-6) is an absolute floor: on the raw patterns (sum 1, about 6e-5 a
    pixel) it swamps the dark field and the term barely descends, in the JAX
    package and upstream PtyRAD alike (PARITY_MIDSCALE.json, leg A)."""
    meas = init["measurements"] / init["measurements"].max()
    probe = init["probe"]
    scale = np.sqrt(float(meas.mean(0).sum()) / float(np.sum(np.abs(probe) ** 2)))
    return dict(init, measurements=meas, probe=(probe * scale).astype(np.complex64))


def low_dose_path(dev, card: str, init: dict):
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    data = low_dose_dataset(init)
    solver = PtyRADSolver(LOW_DOSE_PARAMS, init_variables=data, device=dev, verbose=True)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    emit({
        "phase": "low_dose", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "iterations": len(losses), "losses": losses, "terms": solver.history.term_iters,
        "iter_s": times, "patterns_per_s": [N_SCANS / t for t in times], "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    # The mix's total does not fall in 3 iterations from the flat start
    # (loss_pacbed rises, see low_dose_terms_alone), upstream PtyRAD's and
    # the JAX package's neither (PARITY_MIDSCALE.json, leg A); so the run is
    # held to finite values here, and descent to the Poisson term alone.
    require(len(losses) == NITER and all(np.isfinite(losses)), f"loss not finite: {losses}")
    for name in LOW_DOSE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the low-dose path")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the low-dose path")
    low_dose_terms_alone(dev, data)
    return solver, launches


def low_dose_terms_alone(dev, data: dict) -> None:
    """Each data term of the low-dose mix alone (with loss_sparse), 2
    iterations from the flat start on the same data: the Poisson term must
    fall through B4; the PACBED term's trajectory is reported."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    out = {}
    for term, other in (("loss_poissn", "loss_pacbed"), ("loss_pacbed", "loss_poissn")):
        params = copy.deepcopy(LOW_DOSE_PARAMS)
        params["loss_params"][other]["state"] = False
        params["recon_params"]["NITER"] = 2
        solver = PtyRADSolver(params, init_variables=data, device=dev, verbose=False)
        solver.run()
        out[term] = [t[term] for t in solver.history.term_iters]
        del solver
    emit({"phase": "low_dose_terms_alone", "iterations": 2, **out})
    poissn = out["loss_poissn"]
    require(len(poissn) == 2 and all(np.isfinite(poissn)) and poissn[1] < poissn[0],
            f"loss_poissn alone did not fall through B4: {poissn}")


# -- phase 6: the PSO path ----------------------------------------------------

def pso_positions() -> tuple[np.ndarray, int]:
    """Integer patch corners of the 64 x 64 raster at 0.41 Ang steps (2.73 px
    at dx = 0.15 Ang; the yml's 0.15 Ang random jitter is left out)."""
    steps = np.round(np.arange(PSO_SIDE) * PSO_STEP_ANG / PSO_DX).astype(np.int32)
    ys, xs = np.meshgrid(steps, steps, indexing="ij")
    canvas = int(steps[-1]) + PSO_NPIX + 8
    return np.stack([ys.ravel() + 4, xs.ravel() + 4], -1).astype(np.int32), canvas


def columnar_phase(canvas: int) -> np.ndarray:
    """A columnar phase object: 1,500 atom columns at seeded random centres,
    each a Gaussian of 0.04 rad per slice (variance 2 px^2), the same in all
    21 slices; each blob is evaluated in a 25^2 window."""
    rng = np.random.default_rng(SEED + 1)
    phase = np.zeros((canvas, canvas), np.float32)
    d = np.arange(-12, 13, dtype=np.float32)
    blob = 0.04 * np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / 4.0)
    for cy, cx in rng.integers(12, canvas - 12, (1500, 2)):
        phase[cy - 12:cy + 13, cx - 12:cx + 13] += blob
    return np.broadcast_to(phase, (PSO_NZ, canvas, canvas))


def pso_dataset(dev) -> dict:
    """init_variables for PSO: 256^2 patterns simulated through the port's
    plain multislice_dp (set-up, not the path being driven), cropped to
    [68, 188)^2, normalised to max at one, and padded on the fly; the probe
    scaled to the mean measured intensity with its pad, as the Initializer's
    _probe_normalize does; a flat initial object."""
    from ptyrad_tpu_torch.initialization import meas_pad_on_the_fly
    from ptyrad_tpu_torch.models import (compute_propagators, get_obj_patches, get_probes,
                                         make_model, multislice_dp)
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    crop_pos, canvas = pso_positions()
    lam = electron_wavelength(PSO_KV)
    true_obj = np.exp(1j * columnar_phase(canvas))[None].astype(np.complex64)
    init = {
        "obj": true_obj,
        "probe": pso_probe(),
        "probe_pos_shifts": np.zeros((PSO_SCANS, 2), np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32),
        "slice_thickness": PSO_DZ,
        "H": near_field_evolution((PSO_NPIX, PSO_NPIX), PSO_DX, PSO_DZ, lam),
        "measurements": np.zeros((1, PSO_NPIX, PSO_NPIX), np.float32),
        "crop_pos": crop_pos,
        "omode_occu": np.ones(1, np.float32),
        "dx": PSO_DX,
        "lambd": lam,
        "N_scan_slow": PSO_SIDE,
        "N_scan_fast": PSO_SIDE,
    }
    params, buffers, geom = make_model(init, None, dev)
    lo, hi = PSO_CROP
    crops = torch.empty((PSO_SCANS, hi - lo, hi - lo), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for start in range(0, PSO_SCANS, 256):
            idx = torch.arange(start, min(start + 256, PSO_SCANS), device=dev)
            obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                               compute_propagators(params, buffers, geom, idx),
                               buffers.omode_occu, eps=geom.eps)
            crops[idx] = dp[:, lo:hi, lo:hi]
    del params, buffers, geom
    crops /= crops.max()
    crops_np = crops.cpu().numpy()
    padded, pad_idx = meas_pad_on_the_fly(crops_np, "power", PSO_NPIX, threshold=70)
    meas_avg_sum = float(crops_np.mean(0).sum() + padded.sum())
    probe = init["probe"]
    probe = (probe * np.sqrt(meas_avg_sum / np.sum(np.abs(probe) ** 2))).astype(np.complex64)
    init.update(obj=np.ones_like(true_obj), probe=probe, measurements=crops,
                on_the_fly_meas_padded=padded, on_the_fly_meas_padded_idx=pad_idx)
    return init


def pso_path(dev, card: str):
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    t0 = time.perf_counter()
    init = pso_dataset(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    solver = PtyRADSolver(PSO_PARAMS, init_variables=init, device=dev, verbose=True)
    del init
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    emit({
        "phase": "pso", "card": card, "n_patterns": PSO_SCANS, "batch": BATCH,
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [PSO_SCANS / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    require(len(losses) == PSO_NITER and all(np.isfinite(losses)), f"loss not finite: {losses}")
    require(losses[-1] < losses[0], f"PSO loss did not fall: {losses}")
    for name in PSO_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the PSO path")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd", "B4a dp_fwd", "B4b dp_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the PSO path (N = 256)")
    pso_forward_figure(solver)
    return solver, launches


def pso_forward_figure(solver) -> None:
    """One no-grad forward() of a batch, the yml's "forward" figure: finite,
    of the expected shape, and equal to the plain multislice_dp on the same
    patches within 1e-4 of its largest value."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, get_obj_patches,
                                         get_probes, multislice_dp)

    p, bufs, geom = solver.params, solver.buffers, solver.geom
    idx = torch.as_tensor(solver.batch_idx[0], device=solver.device)
    with torch.no_grad():
        dp, (obja_p, objp_p) = forward(p, bufs, geom, idx)
        ref = multislice_dp(obja_p, objp_p, get_probes(p, geom, idx),
                            compute_propagators(p, bufs, geom, idx), bufs.omode_occu, geom.eps)
    err = float((dp - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    emit({"phase": "pso_forward", "shape": list(dp.shape), "finite": bool(torch.isfinite(dp).all()),
          "max_abs_err": err, "tolerance": tol})
    require(tuple(dp.shape) == (len(idx), PSO_NPIX, PSO_NPIX) and bool(torch.isfinite(dp).all()),
            "forward() gave a non-finite or misshapen dp")
    require(err <= tol, f"forward() differs from the plain multislice_dp: {err} > {tol}")


def profile_steps(solver, card: str, path: str, niter: int, n_batches: int) -> None:
    """Where a training step's time goes: torch.profiler over n_batches steps
    of the solver's own epoch function (after the path's run, so its launches
    are not counted there). Device time by kernel, the device's busy share of
    the window's wall time, and the host time per step."""
    from torch.profiler import ProfilerActivity, profile

    dev = solver.device
    idx = torch.as_tensor(solver.batch_idx[:n_batches], device=dev)
    mask = torch.as_tensor(solver.batch_mask[:n_batches], device=dev)
    solver.train_epoch(idx[:2], mask[:2], niter)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.train_epoch(idx, mask, niter)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernels only: the host ops that launched them carry the same
    # device time again, and a user annotation (e.g. Optimizer.step) spans
    # its kernels and the gaps between them
    rows = [(e.self_device_time_total / 1e3, e.count, e.key[:70])
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "path": path, "card": card, "steps": n_batches, "wall_ms": wall_ms,
          "ms_per_step": wall_ms / n_batches,
          "device_busy_ms": busy_ms if rows else "not measured",
          "device_busy_share": busy_ms / wall_ms if rows else "not measured",
          "top_device_ms": [{"kernel": k, "calls": c, "ms": ms} for ms, c, k in rows[:12]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from ptyrad_tpu_torch.device import pin_fp32
    from ptyrad_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    pin_fp32()
    card = gpu_line()
    emit({"phase": "device", "card": card, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": path.name,
          "compiled": _build.BUILD_SECONDS is not None})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = (check_patches(dev, gen) + check_loss_chain(dev, gen) + check_dp_chain(dev, gen)
               + check_chain(dev, gen))
    torch.cuda.empty_cache()

    solver, tbl_launches, init = main_path(dev, card)
    profile_steps(solver, card, "tBL", NITER + 1, n_batches=32)
    del solver
    torch.cuda.empty_cache()
    forward_modes_check(dev, init)
    torch.cuda.empty_cache()
    solver, low_dose_launches = low_dose_path(dev, card, init)
    profile_steps(solver, card, "low-dose", NITER + 1, n_batches=32)
    del solver, init
    torch.cuda.empty_cache()
    solver, pso_launches = pso_path(dev, card)
    profile_steps(solver, card, "PSO", PSO_NITER + 1, n_batches=8)
    launches = {k: tbl_launches[k] + low_dose_launches[k] + pso_launches[k]
                for k in tbl_launches}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: {**k, "launches": launches[k["name"]]}[key] for key in keys}
                      for k in kernels]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
