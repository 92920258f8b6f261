"""Drive the PyTorch/CUDA port (ptyrad_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line each:
  1. device  - the card, torch and CUDA versions; TF32 off.
  2. build   - nvcc builds the kernels of ptyrad_tpu_torch/csrc into
               ptyrad_tpu_torch/_build (seconds).
  3. kernels - each kernel against its plain PyTorch version at the tBL_WSe2
               shapes, with its error, tolerance and CUDA-event times (median
               of 20 runs after warm-up) beside the plain version's, one
               PyTorch call's where one computes the same function, and the
               bound from bytes and operations.
  4. main    - the tBL_WSe2 reconstruction through PtyRADSolver.run(): 16,384
               simulated 128^2 patterns, 6 probe modes, 6 slices, batch 32,
               Adam, loss_single + loss_sparse, the six tBL constraints, 3
               iterations from a flat object. Asserts a finite, falling loss
               and that every kernel ran during the run.
  5. profile - torch.profiler over 32 more training steps: device time by
               kernel, the device's busy share, host time per step.
Then a {"kernels": [...]} line, the nvidia-smi name/power-limit line, and as
the last line {"ok": true, "device": {...}}. Any failed check raises, so the
exit code is not 0 and the last line is never printed. Exits non-zero at once
without CUDA.
"""

from __future__ import annotations

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
        "source": "ptyrad_tpu_torch/csrc/multislice_loss.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:548",
        "max_abs_err": err_fwd,
        "ms": time_ms(lambda: M.loss_sums_fwd_cuda(obja, objp, pr, h, meas, mask, p, eps, True)),
        "plain_ms": time_ms(lambda: M.loss_sums_plain(obja, objp, pr, h, meas, mask, p, eps,
                                                      True)),
        "library_ms": None, "bound_ms": f_bound, "bound_by": f_by,
    }
    bwd = {
        "name": "B3b loss_sums_bwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice_loss.cu",
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
    """Measurements from the known object through the port's multislice_dp
    (set-up, not the path being driven)."""
    from ptyrad_tpu_torch.models import (compute_propagators, get_obj_patches, get_probes,
                                         make_model, multislice_dp)

    params, buffers, geom = make_model(init, None, dev)
    meas = torch.empty((N_SCANS, NPIX, NPIX), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for start in range(0, N_SCANS, 512):
            idx = torch.arange(start, min(start + 512, N_SCANS), device=dev)
            obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
            meas[idx] = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                                      compute_propagators(params, buffers, geom, idx),
                                      buffers.omode_occu, eps=geom.eps)
    torch.cuda.synchronize()
    return meas


def kernel_counters():
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops import patches as P

    return {"B1 gather_patches": P.gather_cuda, "B2 scatter_add_patches": P.scatter_add_cuda,
            "B3a loss_sums_fwd": M.loss_sums_fwd_cuda, "B3b loss_sums_bwd": M.loss_sums_bwd_cuda}


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
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    solver.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = {name: fn.launches for name, fn in counters.items()}

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
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    return solver, launches


def profile_steps(solver, card: str, n_batches: int = 32) -> None:
    """Where a training step's time goes: torch.profiler over n_batches steps
    of the solver's own epoch function (after the main run, so its launches
    are not counted there). Device time by kernel, the device's busy share of
    the window's wall time, and the host time per step."""
    from torch.profiler import ProfilerActivity, profile

    dev = solver.device
    idx = torch.as_tensor(solver.batch_idx[:n_batches], device=dev)
    mask = torch.as_tensor(solver.batch_mask[:n_batches], device=dev)
    solver.train_epoch(idx[:2], mask[:2], NITER + 1)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.train_epoch(idx, mask, NITER + 1)
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
    emit({"phase": "profile", "card": card, "steps": n_batches, "wall_ms": wall_ms,
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
    kernels = check_patches(dev, gen) + check_loss_chain(dev, gen)

    solver, launches = main_path(dev, card)
    profile_steps(solver, card)
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
