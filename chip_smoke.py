"""Drive the PyTorch/CUDA port (ptyrad_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line each:
  1. device  - the card, torch and CUDA versions; TF32 off.
  2. build   - nvcc builds the kernels of ptyrad_tpu_torch/csrc into
               ptyrad_tpu_torch/_build (seconds), then the chain kernels'
               one-time set-up for N = 256 and 512 (ops.chain.prepare).
  3. kernels - each kernel against its plain PyTorch version at its main
               path's shapes (B1-B4 at tBL_WSe2's, B5/B6 at PSO's, B1/B2 at
               PSO's too), with its error, tolerance and CUDA-event times
               (median of 20 runs after warm-up; a row under 0.1 ms, and B1,
               B2 and their library calls always, as a run of 100
               back-to-back launches queued behind a device-side sleep,
               over 100) beside the plain version's, one PyTorch call's where
               one computes the same function, and the bound from bytes and
               operations. B1 and B2 at tolerance 0 (B2 against
               scatter_add_plain on the CPU, which sums in batch order as
               the kernel does, and run twice to repeat bit for bit), their
               pair launches (obja and objp at once) against two single
               launches, and the wrappers' host us per call; B3b and B4b
               (fixed-order sums over modes and samples) run twice to repeat
               bit for bit, with a per-position and a shared probe, and B3a/B3b
               again at one slice (nz = 1, the hypertune path); then the
               need_dh variants: B3a/B4a on a
               per-position H and B3b/B4b with dH at tBL shapes, B5b/B6b with
               dH at PSO shapes, each for a shared and a per-position H, dH
               held at 1e-4 of its largest entry; then B5a/B5b with the
               far-field exit (without and with dH) at PSO shapes and at
               N = 512, against chain_segment_plain(far_field=True), with the
               time of what the exit replaces (B5 without it plus one
               torch.fft.fft2 or its backward) as library_ms; then one
               propagation of the PSO batch (a row pass plus a column pass
               of B6a, torch.profiler) beside torch.fft's (fft2, the H
               product, ifft2), its bound from what the function reads and
               writes (psi in and out, a, phi and H once) and, apart, the
               two passes' own traffic at the memory rate.
     plain route - forward() at N = 96 and 120, which no kernel rule takes,
               through the plain torch.fft chain on the card (B1/B2 for the
               patches, no chain kernel) against the CPU, values and
               gradients at 1e-4 of the largest entry.
  4. main    - the tBL_WSe2 reconstruction through PtyRADSolver.run(): 16,384
               128^2 patterns simulated through forward() (B4a; every 8th
               batch held against the plain multislice_dp), 6 probe modes, 6
               slices, batch 32, Adam, loss_single + loss_sparse, the six tBL
               constraints, 3 iterations from a flat object. Asserts a
               finite, falling loss and that every kernel of the path ran
               during the run.
  5. profile - torch.profiler over 32 more tBL training steps: device time by
               kernel, the device's busy share, host time per step.
     params_file - the same run from its params file through the normal
               entry: the main phase's patterns written as an EMPAD .raw
               (1,024 gap bytes a frame, flipped along ky) and a .json params
               file (the yml's init_params: fitRBF, max_at_one, flipT,
               jitter 0.15, simulated probe, positions, object and tilt; every
               key written out), then load_params (validated where pydantic
               imports) -> PtyRADSolver(params, init_rng=RandomState(SEED))
               -> run(), 3 iterations. Prints which optional host packages
               import, the Initializer's seconds by stage, load_raw's GB/s,
               patterns/s and peak memory. Asserts the native .raw reader
               ran, the mean pattern's max is 1, the probe and object shapes,
               dx within 5% of the simulation's, a finite, falling loss, B1,
               B2, B3a and B3b launched and B4-B6 not; then a .npy of the
               patterns with a dx calibration, whose measurements must equal
               the patterns bit for bit.
     resume  - the tBL run at full width on the main phase's data, 3
               iterations, whose callback takes make_save_dict's checkpoint
               of iteration 2 with the optimizer state from the live run
               (seconds printed); a second solver built from that dict alone
               (resume_from: the tensors into init_variables, the optimizer
               state through optim.load_opt_state_values) runs iteration 3
               through recon_loop(start_niter=3) beside the uninterrupted
               run's: the first batch's loss, the first 8 batches' and the
               iteration's equal bit for bit (rtol 0; see resume_path), and
               a solver without the restored optimizer state must miss the
               last two.
               Where h5py imports, again through model_iter0002.hdf5 and
               load_ptyrad (write seconds printed); which routes ran is
               printed. B1, B2, B3a, B3b.
     cli     - ``python -m ptyrad_tpu_torch run --params_path`` in a
               subprocess on params_file's .raw and a .json set to 4
               iterations saved every 2 into a temporary output_dir
               (objp, obja, probe; model and optim_state where h5py
               imports): exit 0, one output folder named as
               make_output_folder names it, the params copy and the log in
               it, the objp and probe_amp TIFs of iterations 2 and 4 at
               their shapes (read back through PIL), each iteration saved
               once, finite and falling losses, the kernel library neither
               rebuilt nor replaced. Prints the seconds to training and to
               the first iteration's end, patterns/s and each save's
               seconds. Then validate-params (exit 0 on the .json, 1 on a
               copy with a bad key), check-gpu and print-system-info (exit
               0, naming the card), run at once.
     figures - the params_file phase's .raw through run_reconstruction, 2
               iterations saved every iteration with selected_figs [loss,
               forward, probe_r_amp, pos, group]: each plot_summary's
               seconds (the forward figure's forward() is B4a on 2
               patterns, one launch per save); forward_panels finite and
               equal to the plain multislice_dp within 1e-4 of its largest
               value; every expected PNG where matplotlib imports, else
               "figures: drawing skipped, matplotlib missing".
     hypertune - run_hypertune in process on the same .raw at full width
               with demo/params/tBL_WSe2_hypertune.yml's sections (one
               slice: B3 at nz = 1): 4 trials of 3 iterations tuning scale
               and rotation, TPE (seed 0, 2 startup trials) and Hyperband
               (min_resource 1, reduction_factor 2, 2 startup trials), a
               sqlite study, objp and the loss and forward figures collated.
               Each trial's seconds and peak memory, the best trial. No
               trial FAILED (a failed trial's exception printed), the
               staged re-init moved the positions, finite values, the
               sqlite file's reports, the _error_..._tNNNN names, the last
               trial's peak memory within 10% of the first's.
     hypertune_cli - a second worker, ``python -m ptyrad_tpu_torch run
               --jobid 1``, 1 trial of 2 iterations on the same study: exit
               0, 5 trials in the study, the worker's log file.
     determinism - the main phase and the resume phase's uninterrupted run
               (the same 3 iterations on the same data) equal bit for bit:
               every batch's loss terms in every iteration, the losses and
               the final obja, objp and probe; where they part, the ops
               torch.use_deterministic_algorithms(warn_only=True) names. The
               low-dose phase runs its 3 iterations twice for the same check
               through B4b.
     lbfgs   - tBL's sections with LBFGS (history_size 10), 2 iterations: the
               objective is the mean loss of all 512 batches, evaluated
               again at every line-search step. Per-iteration losses,
               line-search steps, objective evaluations and seconds; a
               finite, falling loss, probe_pos_shifts (start_iter 10)
               unchanged bit for bit, the first value equal to the batch
               mean recomputed at the start (rtol 1e-6), and a second run
               equal bit for bit (values, line-search steps, final
               tensors). B1, B2, B3a, B3b.
     grad_accum - Adam with grad_accumulation 4, 2 iterations: a finite,
               falling loss, each tensor's Adam step count the batches over
               4, patterns/s.
     optimizers - every other registry name (AdamW with weight_decay and
               obja from iteration 2, SGD with momentum, RMSprop, Adagrad,
               Adamax, NAdam, RAdam, Adadelta, Rprop, ASGD, Adafactor, Muon,
               SparseAdam), 16 tBL batches each: finite losses; one more step
               on CUDA against the same step on CPU copies of the same
               parameters, state and gradients at rtol 1e-5; AdamW's obja
               unchanged bit for bit before it starts.
     grouping - compact and sparse grouping of the 16,384 positions, one
               iteration each: make_batches' host seconds, every index in
               one batch, none empty, compact tighter than random and sparse
               wider than compact; "grouping: skipped, scikit-learn missing"
               where scikit-learn does not import.
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
  8. tilt    - the tBL reconstruction with optimizable slice thickness and
               per-position tilts: the 16,384 patterns simulated through
               forward() with a smooth tilt field within 1 mrad (B4a on a
               per-position H), reconstructed from zero tilts with obj_tilts
               and slice_thickness at lr 1e-4 and tilt_smooth (std 2), 3
               iterations. Asserts a finite, falling loss, moved dz and
               tilts, B1, B2, B3a (per-position H) and B3b (dH) launched and
               B4b not; then one batch's dH, dz and tilt gradients through B3
               against the plain route; then a profile over 32 steps. The
               forward phase also runs forward() with optimizable dz and
               per-position tilts (B4b with dH) against the plain chain.
     tbl_store - the tBL data binned 2 x 2 on the host to 64^2, stored as
               bfloat16 and resampled on the fly by (2, 2), 3 iterations
               through B3: a finite, falling loss, the store's type and bytes.
     constraints - all twelve constraints once on a tBL-sized model, on the
               card against the CPU.
     pso_ff  - the PSO run again on the same data after set_far_field(True):
               B5's kernel ends in the detector transform. The first batch's
               loss must equal the pso phase's at rtol 1e-5; from the flat
               start the run amplifies float32 rounding, so each iteration's
               loss is only held within 2e-2 there; every B5 launch must take
               the exit, B3 and B4 stay at 0; its profile beside pso's.
     pso_ff_random_start - the tight gates on the same path: the
               full-width PSO run from a seeded random object through the
               kernels with the exit off, with it on, and with fwd_fused:
               false (no chain kernel: cuFFT), each iteration's loss at rtol
               1e-4 against the first. Then one forward() at
               nz = 16 (the carve: B6 over one segment, a full B5 tail with
               the exit, dH) against the plain chain.
  9. pso_tilt - the PSO reconstruction from data simulated at a global tilt
               of (1.0, -0.5) mrad, from (0, 0) with obj_tilts and
               slice_thickness at lr 1e-4, 2 iterations: a finite, falling
               loss, moved dz and tilt, B5b and B6b with dH, B3 not; then a
               profile over 8 steps.
Then a {"kernels": [...]} line (launches summed over the driven runs: the
plain route, tBL, params_file, resume, figures, hypertune, lbfgs,
grad_accum, optimizers, grouping, low-dose (both runs), tbl_store, PSO, pso_ff (with its random-start
runs and the carve), tilt (its simulation included) and PSO tilt paths and
the forward phase's kernel routes; B1/B2's rows at the tBL shapes count the
N <= 128 runs, their rows at the PSO shapes the N = 256 runs), the
nvidia-smi name/power-limit line, and as the last line {"ok": true,
"device": {...}}. Any failed check raises, so the exit code is not 0 and the
last line is never printed. Exits non-zero at once without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and FP32
# (non-tensor-core) operations/s; used for each kernel's bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# rows under SHORT_MS, and B1/B2 always, are timed as a run of RUN_LAUNCHES
# back-to-back launches (run_ms); SLEEP_CYCLES_PER_S sizes the device-side
# sleep that queues a run ahead of its first event (the boost clock)
SHORT_MS = 0.1
RUN_LAUNCHES = 100
SLEEP_CYCLES_PER_S = 1.98e9

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
PSO_FF_FLAT_RTOL = 2e-2  # pso_ff against pso from the flat start (see pso_ff_path)
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


def _event_ms(fn, reps: int, warmup: int) -> float:
    """Median CUDA-event time of single calls of fn() in ms."""
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


def run_ms(fn, launches: int = RUN_LAUNCHES, runs: int = 5) -> float:
    """Device ms per call of fn() over a run of `launches` back-to-back calls
    between one pair of CUDA events, the median of `runs` runs. Before each
    run a device-side sleep (twice the host's time to queue the run, from
    host_us) holds the stream, so the host has queued every call before the
    first event fires: the events time the device's work, not the host's
    launch path."""
    queue_s = launches * host_us(fn, reps=20) * 1e-6
    sleep_cycles = int(2.0 * queue_s * SLEEP_CYCLES_PER_S)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """CUDA-event time of fn() in ms: the median of `reps` single calls, or,
    where that is under SHORT_MS, run_ms's time per call of a run."""
    one = _event_ms(fn, reps, warmup)
    return one if one >= SHORT_MS else run_ms(fn)


def host_us(fn, reps: int = 200) -> float:
    """Host us per call of fn(): a host clock around each call, after a
    synchronise so that the queue is empty and the call never waits on the
    device; the median of `reps` calls."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
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

PSO_SHAPES = " (PSO shapes)"  # name suffix of the B1/B2 rows at the PSO shapes


def patch_corners(dev, gen, corners: np.ndarray, h: int, w: int, n: int) -> torch.Tensor:
    """BATCH corners drawn from `corners` with the edge cases of the kernel
    checks: one past the last corner, one negative (both clamped) and a
    window three times over."""
    pick = torch.randperm(len(corners), generator=gen, device=dev)[:BATCH].cpu().numpy()
    pos = torch.as_tensor(corners[pick], device=dev)
    pos[0] = torch.tensor([h - n + 9, w - n + 3])  # past the last corner: clamped
    pos[1] = torch.tensor([-4, 7])                  # negative: clamped
    pos[3] = pos[2]                                 # duplicate windows
    pos[4] = pos[2]
    return pos.contiguous()


def check_patches_at(dev, gen, lmodes: int, h: int, w: int, n: int, pos: torch.Tensor,
                     suffix: str, atomic_b2: bool = False) -> list:
    """B1 and B2 at one shape: a (1, lmodes, h, w) canvas, BATCH n^2 windows at
    `pos`. B1 against advanced indexing and B2 against scatter_add_plain on
    the CPU, both at tolerance 0; B2 run twice must repeat bit for bit; the
    pair launch against two single launches. The kernels and their library
    calls are timed as runs of back-to-back launches (run_ms), with the
    wrapper's host us per call apart. `atomic_b2` is for a tree from before
    the pair launch, whose B2 summed with atomics (chain_bench.py
    --atomic-b2 times one): B2 held at rtol 1e-5 of the largest sum, with
    no repeat check and no pair rows."""
    from ptyrad_tpu_torch.ops import patches as P

    shape = (n, n)
    canvas = torch.rand((1, lmodes, h, w), generator=gen, device=dev)
    canvas_p = torch.rand((1, lmodes, h, w), generator=gen, device=dev)
    out_k = P.gather_cuda(canvas, pos, shape)
    err_g = float((out_k - P.gather_plain(canvas, pos, shape)).abs().max())
    iy, ix = P._clamped_index(pos, (h, w), shape)
    covered = np.zeros((h, w), bool)
    for y, x in np.minimum(pos.clamp(min=0).cpu().numpy(), [h - n, w - n]):
        covered[y:y + n, x:x + n] = True
    g_bound, g_by = bound(4 * (lmodes * covered.sum() + out_k.numel()) + pos.numel() * 4, 0)
    gather = {
        "name": "B1 gather_patches" + suffix, "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/patches.cu",
        "replaces": "ptyrad_tpu/ops/patches.py:136",
        "shape": {"canvas": [1, lmodes, h, w], "batch": BATCH, "window": n},
        "max_abs_err": err_g, "tolerance": 0.0,
        "ms": run_ms(lambda: P.gather_cuda(canvas, pos, shape)),
        "host_us": host_us(lambda: P.gather_cuda(canvas, pos, shape)),
        "plain_ms": time_ms(lambda: P.gather_plain(canvas, pos, shape)),
        "library_ms": run_ms(lambda: canvas[..., iy, ix]),
        "bound_ms": g_bound, "bound_by": g_by,
    }
    if not atomic_b2:
        pair = P.gather_pair_cuda(canvas, canvas_p, pos, shape)
        require(torch.equal(pair[0], out_k)
                and torch.equal(pair[1], P.gather_cuda(canvas_p, pos, shape)),
                f"B1{suffix}: the pair launch differs from two single launches")
        gather["pair_ms"] = run_ms(lambda: P.gather_pair_cuda(canvas, canvas_p, pos, shape))
    del out_k
    emit({"phase": "kernel", **gather, "note": "bit-exact against advanced indexing"})
    require(err_g == 0.0, f"B1{suffix} gather differs from its plain version: {err_g}")

    cshape = (1, lmodes, h, w)
    grads = torch.randn((BATCH, 1, lmodes, n, n), generator=gen, device=dev)
    grads_p = torch.randn((BATCH, 1, lmodes, n, n), generator=gen, device=dev)
    sc_k = P.scatter_add_cuda(cshape, grads, pos)
    ref = P.scatter_add_plain(cshape, grads.cpu(), pos.cpu())
    err_s = float((sc_k.cpu() - ref).abs().max())
    tol_s = 1e-5 * float(ref.abs().max()) if atomic_b2 else 0.0
    repeats = torch.equal(sc_k, P.scatter_add_cuda(cshape, grads, pos))
    flat = ((torch.arange(lmodes, device=dev)[:, None, None, None] * h + iy) * w + ix)
    flat = flat.expand(lmodes, BATCH, n, n).reshape(-1)
    vals = grads[:, 0].transpose(0, 1).reshape(-1)
    s_bound, s_by = bound(4 * (grads.numel() + lmodes * h * w) + pos.numel() * 4, grads.numel())
    scatter = {
        "name": "B2 scatter_add_patches" + suffix, "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/patches.cu",
        "replaces": "ptyrad_tpu/ops/patches.py:98",
        "shape": {"canvas": list(cshape), "batch": BATCH, "window": n},
        "max_abs_err": err_s, "tolerance": tol_s, "repeats_bit_for_bit": repeats,
        "ms": run_ms(lambda: P.scatter_add_cuda(cshape, grads, pos)),
        "host_us": host_us(lambda: P.scatter_add_cuda(cshape, grads, pos)),
        "plain_ms": time_ms(lambda: P.scatter_add_plain(cshape, grads, pos)),
        "library_ms": run_ms(lambda: torch.zeros(lmodes * h * w, device=dev).index_put_(
            (flat,), vals, accumulate=True)),
        "bound_ms": s_bound, "bound_by": s_by,
    }
    if not atomic_b2:
        pair = P.scatter_add_pair_cuda(cshape, grads, grads_p, pos)
        require(torch.equal(pair[0], sc_k)
                and torch.equal(pair[1], P.scatter_add_cuda(cshape, grads_p, pos)),
                f"B2{suffix}: the pair launch differs from two single launches")
        scatter["pair_ms"] = run_ms(
            lambda: P.scatter_add_pair_cuda(cshape, grads, grads_p, pos))
        require(repeats, f"B2{suffix}: two runs differ")
    emit({"phase": "kernel", **scatter,
          "note": ("atomics: order varies run to run; rtol 1e-5 of the largest sum"
                   if atomic_b2 else "batch-order sums: bit-exact against the CPU's index_add_")})
    require(err_s <= tol_s, f"B2{suffix} scatter differs from its plain version: "
                            f"{err_s} > {tol_s}")
    return [gather, scatter]


def check_patches(dev, gen, atomic_b2: bool = False) -> list:
    """B1 and B2 at the tBL shapes (canvas 6 x 520 x 520, 128^2 windows on
    tbl_positions' raster) and at the PSO shapes (21 x 436 x 436, 256^2
    windows on pso_positions')."""
    corners, side = tbl_positions()
    rows = check_patches_at(dev, gen, NZ, side, side, NPIX,
                            patch_corners(dev, gen, corners, side, side, NPIX), "", atomic_b2)
    torch.cuda.empty_cache()
    corners, side = pso_positions()
    rows += check_patches_at(dev, gen, PSO_NZ, side, side, PSO_NPIX,
                             patch_corners(dev, gen, corners, side, side, PSO_NPIX), PSO_SHAPES,
                             atomic_b2)
    return rows


def _chain_flops(n: int, n_fft: int, nz: int) -> float:
    """FP32 operations of one wavefield's chain: n_fft 2D FFTs at
    10 N^2 log2 N each, plus the T and H complex products (6 each)."""
    nn = n * n
    return n_fft * 10 * nn * np.log2(n) + (2 * nz - 1) * 6 * nn


def repeats_bitwise(fn, first) -> bool:
    """Does a second call of fn() give the tensors of ``first`` bit for
    bit? (B3b/B4b reduce over modes and samples in a fixed order.)"""
    return all(torch.equal(a, b) for a, b in zip(first, fn()))


def check_loss_chain(dev, gen, atomic_b3: bool = False) -> list:
    """B3a/B3b against loss_sums_plain and its autograd VJP at tBL shapes,
    for per-position probe spectra (the main path's case, which is timed)
    and a shared real-space probe; B3b run twice must repeat bit for bit
    (``atomic_b3``: a tree from before the fixed-order reduce, whose B3b
    added with atomics; chain_bench.py --atomic-b3 times one)."""
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
        def bwd(pr=pr, dp=dp, kspace=kspace):
            return M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p, eps,
                                        kspace)[:3]

        g_kern = bwd()
        repeat = repeats_bitwise(bwd, g_kern)
        errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
        scales = [float(b.abs().max()) for b in g_plain]
        # 24 transforms by two FFT algorithms: 1e-4 of each cotangent's largest entry
        tols = [1e-4 * s for s in scales]
        err_bwd = max(errs)
        emit({"phase": "kernel_check", "name": "B3 loss chain", "kspace": kspace,
              "shared_probe": not kspace,
              "s1": [float(s1k), float(s1p)], "s2": [float(s2k), float(s2p)],
              "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd,
              "bwd_max_abs_err": errs, "bwd_tolerance": tols,
              "bwd_names": ["d obja", "d objp", "d probe"], "bwd_repeats_bitwise": repeat})
        require(err_fwd <= tol_fwd, f"B3a (kspace={kspace}) differs: {err_fwd} > {tol_fwd}")
        require(repeat or atomic_b3, f"B3b (kspace={kspace}) run twice differs")
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
    return [fwd, bwd] + check_loss_chain_one_slice(obja, objp, pr, h, meas, mask, p, eps, cvec,
                                                   atomic_b3)


def check_loss_chain_one_slice(obja, objp, pr, h, meas, mask, p, eps, cvec,
                               atomic_b3: bool = False) -> list:
    """B3a/B3b at nz = 1 (the hypertune demo's obj_Nlayer: 1, no
    propagation in the chain) against loss_sums_plain and its VJP, with the
    per-position probe spectra of the main path, at check_loss_chain's
    tolerances; B3b run twice must repeat bit for bit."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    n = NPIX
    a1, p1 = obja[:, :, :1].contiguous(), objp[:, :, :1].contiguous()
    args = (meas, mask, p, eps, True)
    s1k, s2k, dp = M.loss_sums_fwd_cuda(a1, p1, pr, h, *args)
    with torch.no_grad():
        s1p, s2p = M.loss_sums_plain(a1, p1, pr, h, *args)
    err_fwd = max(abs(float(s1k - s1p)), abs(float(s2k - s2p)))
    tol_fwd = 1e-4 * max(abs(float(s1p)), abs(float(s2p)))
    leaves = [t.clone().requires_grad_(True) for t in (a1, p1, pr)]
    s1_plain, _ = M.loss_sums_plain(*leaves, h, *args)
    g_plain = torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec, retain_graph=True)

    def bwd():
        return M.loss_sums_bwd_cuda(a1, p1, pr, h, meas, mask, dp, cvec, p, eps, True)[:3]

    g_kern = bwd()
    repeat = repeats_bitwise(bwd, g_kern)
    errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
    tols = [1e-4 * float(b.abs().max()) for b in g_plain]
    emit({"phase": "kernel_check", "name": "B3 loss chain, nz = 1", "kspace": True,
          "s1": [float(s1k), float(s1p)], "s2": [float(s2k), float(s2p)],
          "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd, "bwd_max_abs_err": errs,
          "bwd_tolerance": tols, "bwd_names": ["d obja", "d objp", "d probe"],
          "bwd_repeats_bitwise": repeat})
    require(err_fwd <= tol_fwd, f"B3a (nz = 1) differs: {err_fwd} > {tol_fwd}")
    require(repeat or atomic_b3, "B3b (nz = 1) run twice differs")
    for name, e, t in zip(("obja", "objp", "probe"), errs, tols):
        require(e <= t, f"B3b d{name} (nz = 1) differs: {e} > {t}")
    n_wave = BATCH * PMODE
    in_bytes = 4 * (a1.numel() + p1.numel() + meas.numel() + mask.numel()) \
        + 8 * (pr.numel() + h.numel())
    f_bound, f_by = bound(in_bytes + 8, n_wave * _chain_flops(n, 2, 1))
    b_bytes = in_bytes + 4 * dp.numel() + 4 * (a1.numel() + p1.numel()) + 8 * pr.numel()
    b_bound, b_by = bound(b_bytes, n_wave * 2 * _chain_flops(n, 2, 1))
    fwd = {
        "name": "B3a loss_sums_fwd (nz=1)", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:548",
        "max_abs_err": err_fwd,
        "ms": time_ms(lambda: M.loss_sums_fwd_cuda(a1, p1, pr, h, *args)),
        "plain_ms": time_ms(lambda: M.loss_sums_plain(a1, p1, pr, h, *args)),
        "library_ms": None, "bound_ms": f_bound, "bound_by": f_by,
    }
    bwd_row = {
        "name": "B3b loss_sums_bwd (nz=1)", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:588",
        "max_abs_err": max(errs),
        "ms": time_ms(bwd),
        "plain_ms": time_ms(lambda: torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec,
                                                        retain_graph=True)),
        "library_ms": None, "bound_ms": b_bound, "bound_by": b_by,
    }
    for k in (fwd, bwd_row):
        emit({"phase": "kernel", **k, "note": "kspace probe, one slice: the hypertune path"})
    return [fwd, bwd_row]


def check_dp_chain(dev, gen, atomic_b3: bool = False) -> list:
    """B4a/B4b against multislice_dp_plain and its autograd VJP at tBL
    shapes, for per-position probe spectra (the low-dose path's case, which
    is timed) and a shared real-space probe; B4b run twice must repeat bit
    for bit (``atomic_b3`` as in check_loss_chain)."""
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
        def bwd(pr=pr, kspace=kspace):
            return M.dp_bwd_cuda(obja, objp, pr, h, g, kspace)[:3]

        g_kern = bwd()
        repeat = repeats_bitwise(bwd, g_kern)
        errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
        # 24 transforms by two FFT algorithms, sums over modes (and over
        # samples for a shared probe) in another order: 1e-4 of each
        # cotangent's largest entry
        tols = [1e-4 * float(b.abs().max()) for b in g_plain]
        emit({"phase": "kernel_check", "name": "B4 dp chain", "kspace": kspace,
              "shared_probe": not kspace, "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd,
              "bwd_max_abs_err": errs, "bwd_tolerance": tols,
              "bwd_names": ["d obja", "d objp", "d probe"], "bwd_repeats_bitwise": repeat})
        require(err_fwd <= tol_fwd, f"B4a (kspace={kspace}) differs: {err_fwd} > {tol_fwd}")
        require(repeat or atomic_b3, f"B4b (kspace={kspace}) run twice differs")
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


def pso_probe(npix: int = PSO_NPIX) -> np.ndarray:
    from ptyrad_tpu_torch.physics import make_mixed_probe, make_stem_probe

    probe = make_stem_probe({"kv": PSO_KV, "conv_angle": 21.4, "Npix": npix,
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
    g_kern = C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False)[:3]
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
        g_kern = C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, last)[:3]
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


def propagation_yardstick(dev, gen) -> dict:
    """One propagation ifft2(H fft2(psi)) of the PSO batch (32 x 4 fields of
    256^2): the kernels' share of it, one row pass plus one column pass
    (their mean device times over one B6a call, torch.profiler; the row
    pass also applies T), against one PyTorch call each of torch.fft.fft2,
    the H product and torch.fft.ifft2 (cuFFT) on the same field. The bound
    is that of the function the passes compute, T product included: psi
    read and written once, a, phi and H read once."""
    from torch.profiler import ProfilerActivity, profile

    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, b = PSO_NPIX, BATCH
    lam = electron_wavelength(PSO_KV)
    h = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
    psi = torch.complex(torch.randn((b, PSO_PMODE, n, n), generator=gen, device=dev),
                        torch.randn((b, PSO_PMODE, n, n), generator=gen, device=dev))
    a = 1.0 + 0.05 * torch.randn((b, 2 * PSO_SG, n, n), generator=gen, device=dev)
    p = 0.1 * torch.randn((b, 2 * PSO_SG, n, n), generator=gen, device=dev)
    C.stack_fwd_cuda(psi, a, p, h, PSO_SG, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        C.stack_fwd_cuda(psi, a, p, h, PSO_SG, False)
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        for kind in ("row_fwd_kernel", "col_kernel"):
            if kind in e.key and e.self_device_time_total > 0:
                us[kind] = e.self_device_time_total / e.count
    require(set(us) == {"row_fwd_kernel", "col_kernel"}, f"the profiler saw {sorted(us)}")
    field = 8 * psi.numel()
    nn = n * n
    # the function: psi read and written once, one slice of a and phi, H
    fn_bytes = 2 * field + 2 * 4 * b * nn + 8 * h.numel()
    out = {
        "phase": "propagation_yardstick", "shape": list(psi.shape),
        "row_pass_ms": us["row_fwd_kernel"] / 1e3, "column_pass_ms": us["col_kernel"] / 1e3,
        "ms": (us["row_fwd_kernel"] + us["col_kernel"]) / 1e3,
        "library_ms": time_ms(lambda: torch.fft.ifft2(h * torch.fft.fft2(psi))),
        "note": "ms: one row pass (with the T product) plus one column pass of B6a; "
                "library_ms: torch.fft.fft2, the H product, torch.fft.ifft2; "
                "design_traffic_ms: the two passes' own bytes (the field in and out of "
                "each) at the card's memory rate, not a bound of the function",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(fn_bytes, b * PSO_PMODE * (20 * nn * np.log2(n) + 12 * nn)))),
        "design_traffic_ms": (fn_bytes + 2 * field) / PEAK_BYTES_PER_S * 1e3,
    }
    emit(out)
    return out


def tilted_h(h: torch.Tensor, tilts: torch.Tensor, dx: float, dz: float) -> torch.Tensor:
    """Per-position propagators (B, N, N): the shared h times the port's
    tilt_ramp (models/forward.py), tilts (B, 2) in mrad."""
    from ptyrad_tpu_torch.models import tilt_ramp
    from ptyrad_tpu_torch.physics import propagator_kgrid

    ky, kx = (torch.as_tensor(k, dtype=torch.float32, device=h.device)
              for k in propagator_kgrid(tuple(h.shape[-2:]), dx))
    return (h * tilt_ramp(ky, kx, tilts, dz)).contiguous()


def _grad_errs(kern, plain) -> tuple[list, list]:
    """Max abs error of each cotangent and its tolerance, 1e-4 of the plain
    cotangent's largest entry (float32 chains by two FFT algorithms; the
    kernels' sums over modes and samples run in another fixed order)."""
    return ([float((a - b).abs().max()) for a, b in zip(kern, plain)],
            [1e-4 * float(b.abs().max()) for b in plain])


def check_fused_dh(dev, gen) -> list:
    """B3 and B4 with a per-position H (B3a, B4a) and with dH (B3b, B4b) at
    tBL shapes and per-position probe spectra, for a per-position H (tilts
    within 1 mrad; the tilt path's case, which is timed) and a shared one:
    values and every cotangent, dH included, against the plain versions."""
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, dz = NPIX, 2.0
    lam = electron_wavelength(80.0)
    probe = torch.as_tensor(tbl_probe(), device=dev)
    h1 = torch.as_tensor(near_field_evolution((n, n), 0.1494, dz, lam), device=dev)[None]
    tilts = 2.0 * torch.rand((BATCH, 2), generator=gen, device=dev) - 1.0
    h_each = tilted_h(h1, tilts, 0.1494, dz)
    obja = 1.0 + 0.05 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    pr = fourier_shift_kspace(probe, 0.3 * torch.randn((BATCH, 2), generator=gen, device=dev))
    meas = torch.rand((BATCH, n, n), generator=gen, device=dev) * 2e-4
    mask = torch.ones(BATCH, device=dev)
    mask[BATCH - 1] = 0.0
    g = torch.randn((BATCH, n, n), generator=gen, device=dev)
    p, eps, cvec = 0.5, 1e-10, torch.tensor(0.7, device=dev)
    names = ["d obja", "d objp", "d probe", "d h"]
    timed = {}
    for layout, h in (("each", h_each), ("shared", h1)):
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr, h)]
        # B3: the loss-folded pair
        s1k, s2k, dp = M.loss_sums_fwd_cuda(obja, objp, pr, h, meas, mask, p, eps, True)
        s1p, s2p = M.loss_sums_plain(*leaves, meas, mask, p, eps, True)
        e3f = max(abs(float(s1k - s1p.detach())), abs(float(s2k - s2p)))
        t3f = 1e-4 * max(abs(float(s1p.detach())), abs(float(s2p)))
        g3p = torch.autograd.grad(s1p, leaves, grad_outputs=cvec, retain_graph=True)
        g3k = M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p, eps, True,
                                   need_dh=True)
        e3b, t3b = _grad_errs(g3k, g3p)
        # B4: the plain pair
        dp_k = M.dp_fwd_cuda(obja, objp, pr, h, True)
        dp_p = M.multislice_dp_plain(*leaves, True)
        e4f = float((dp_k - dp_p.detach()).abs().max())
        t4f = 1e-4 * float(dp_p.detach().abs().max())
        g4p = torch.autograd.grad(dp_p, leaves, grad_outputs=g, retain_graph=True)
        g4k = M.dp_bwd_cuda(obja, objp, pr, h, g, True, need_dh=True)
        e4b, t4b = _grad_errs(g4k, g4p)
        for name, ef, tf, eb, tb in (("B3", e3f, t3f, e3b, t3b), ("B4", e4f, t4f, e4b, t4b)):
            emit({"phase": "kernel_check", "name": f"{name} with dH", "h": layout,
                  "fwd_max_abs_err": ef, "fwd_tolerance": tf, "bwd_max_abs_err": eb,
                  "bwd_tolerance": tb, "bwd_names": names})
            require(ef <= tf, f"{name}a ({layout} H) differs: {ef} > {tf}")
            for nm, e, t in zip(names, eb, tb):
                require(e <= t, f"{name}b {nm} ({layout} H) differs: {e} > {t}")
        timed[layout] = (leaves, s1p, dp, dp_p, e3f, max(e3b), e4f, max(e4b))

    leaves, s1p, dp, dp_p, e3f, e3b, e4f, e4b = timed["each"]
    h = h_each
    n_wave = BATCH * PMODE
    obj_bytes = 4 * (obja.numel() + objp.numel())
    in_bytes = obj_bytes + 8 * (pr.numel() + h.numel())
    loss_in = 4 * (meas.numel() + mask.numel())
    # the K scratch, written by the recompute and read by the walk: the
    # design's own traffic, reported apart; the bound counts only what the
    # function must move (the JAX kernel recomputes K instead)
    k_bytes = 2 * 8 * n_wave * (NZ - 1) * n * n
    # dH: U conj(K) and its sum, 8 operations per element and propagation
    dh_ops = n_wave * (NZ - 1) * 8 * n * n
    fwd_ops = n_wave * _chain_flops(n, 2 * NZ, NZ)
    bwd_out = obj_bytes + 8 * (pr.numel() + h.numel())
    note = ("tBL shapes, per-position probe spectra and H (tilts within 1 mrad); "
            "scratch_bytes: the K scratch written and read back, not in the bound")
    rows = [
        {"name": "B3a loss_sums_fwd (per-position H)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:548", "max_abs_err": e3f,
         "ms": time_ms(lambda: M.loss_sums_fwd_cuda(obja, objp, pr, h, meas, mask, p, eps, True)),
         "plain_ms": time_ms(lambda: M.loss_sums_plain(obja, objp, pr, h, meas, mask, p, eps,
                                                       True)),
         "library_ms": None,
         **dict(zip(("bound_ms", "bound_by"), bound(in_bytes + loss_in + 8, fwd_ops)))},
        {"name": "B3b loss_sums_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:588", "max_abs_err": e3b,
         "ms": time_ms(lambda: M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p,
                                                    eps, True, need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(s1p, leaves, grad_outputs=cvec,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": k_bytes,
         **dict(zip(("bound_ms", "bound_by"),
                    bound(in_bytes + loss_in + 4 * dp.numel() + bwd_out, 2 * fwd_ops + dh_ops)))},
        {"name": "B4a dp_fwd (per-position H)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:128", "max_abs_err": e4f,
         "ms": time_ms(lambda: M.dp_fwd_cuda(obja, objp, pr, h, True)),
         "plain_ms": time_ms(lambda: M.multislice_dp_plain(obja, objp, pr, h, True)),
         "library_ms": None,
         **dict(zip(("bound_ms", "bound_by"), bound(in_bytes + 4 * g.numel(), fwd_ops)))},
        {"name": "B4b dp_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:145", "max_abs_err": e4b,
         "ms": time_ms(lambda: M.dp_bwd_cuda(obja, objp, pr, h, g, True, need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(dp_p, leaves, grad_outputs=g,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": k_bytes,
         **dict(zip(("bound_ms", "bound_by"),
                    bound(in_bytes + 4 * g.numel() + bwd_out, 2 * fwd_ops + dh_ops)))},
    ]
    for k in rows:
        emit({"phase": "kernel", **k, "note": note})
    return rows


def check_chain_dh(dev, gen) -> list:
    """B5b and B6b with dH at the PSO shapes the main path gives them (B6
    over 2 x 8 slices with last_mega False, B5 over the 5-slice tail with
    `last` both ways), for a shared H (the PSO tilt path's case, which is
    timed) and a per-position one: every cotangent, dH included, against the
    plain chain's VJP."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.shift import fourier_shift
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, b, pm = PSO_NPIX, BATCH, PSO_PMODE
    lam = electron_wavelength(PSO_KV)
    h1 = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
    h_each = tilted_h(h1, 2.0 * torch.rand((b, 2), generator=gen, device=dev) - 1.0, PSO_DX,
                      PSO_DZ)
    probe = torch.as_tensor(pso_probe(), device=dev)
    psi = fourier_shift(probe, 0.3 * torch.randn((b, 2), generator=gen, device=dev))
    obja = 1.0 + 0.05 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    nz_main, sg_tail = 2 * PSO_SG, PSO_NZ - 2 * PSO_SG
    a_main, p_main = obja[:, 0, :nz_main], objp[:, 0, :nz_main]
    a_tail, p_tail = obja[:, 0, nz_main:], objp[:, 0, nz_main:]
    g = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                      torch.randn(psi.shape, generator=gen, device=dev)) * float(psi.abs().max())
    names = ["d psi", "d a", "d phi", "d h"]

    def plain_vjp(fn, inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return out, leaves, torch.autograd.grad(out, leaves, grad_outputs=g, retain_graph=True)

    timed = {}
    for layout, h in (("shared", h1), ("each", h_each)):
        _, stack = C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False)
        stack_fn = lambda x, y, z, w: C.chain_stack_plain(x, y, z, w, PSO_SG, False)  # noqa: E731
        out6, leaves6, g6p = plain_vjp(stack_fn, (psi, a_main, p_main, h))
        e6, t6 = _grad_errs(C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False,
                                             need_dh=True), g6p)
        checks = [("B6", {"S": 2, "sg": PSO_SG, "last_mega": False}, e6, t6)]
        for last in (True, False):
            seg_fn = lambda x, y, z, w, last=last: C.chain_segment_plain(  # noqa: E731
                x, y, z, w, last)
            out5, leaves5, g5p = plain_vjp(seg_fn, (psi, a_tail, p_tail, h))
            e5, t5 = _grad_errs(C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, last,
                                                   need_dh=True), g5p)
            checks.append(("B5", {"sg": sg_tail, "last": last}, e5, t5))
            if last and layout == "shared":
                timed[layout] = (stack, out6, leaves6, max(e6), out5, leaves5, max(e5))
        for name, extra, e, t in checks:
            emit({"phase": "kernel_check", "name": f"{name} with dH", "h": layout, **extra,
                  "bwd_max_abs_err": e, "bwd_tolerance": t, "bwd_names": names})
            for nm, ei, ti in zip(names, e, t):
                require(ei <= ti, f"{name}b {nm} ({layout} H, {extra}) differs: {ei} > {ti}")
        del stack, out6, leaves6, g6p

    stack, out6, leaves6, e6, out5, leaves5, e5 = timed["shared"]
    h = h1
    field = 8 * psi.numel()
    n_wave = b * pm

    def slab(k):
        return 2 * 4 * b * k * n * n  # a and phi

    # dH: U conj(K) and its sum, 8 operations per element and propagation
    def dh_ops(n_prop):
        return n_wave * n_prop * 8 * n * n

    # B6b: rebuild 2 x 8 propagations (the final slice's K included), walk 16
    # adjoint slices and 16 adjoint propagations (the exit's included). The
    # bound counts inputs read once and outputs written once; the K scratch
    # (one field written and read per propagation) is reported apart.
    n6 = nz_main
    b6_bytes = 3 * field + slab(nz_main) + 8 * h.numel() + field + slab(nz_main) \
        + 8 * h.numel()
    b6_ops = _chain_ops(n, n_wave, 2 * n6, n6, nz_main) + dh_ops(n6)
    n5 = sg_tail - 1  # B5b with last: 4 propagations each way
    b5_bytes = 2 * field + slab(sg_tail) + 8 * h.numel() + field + slab(sg_tail) \
        + 8 * h.numel()
    b5_ops = _chain_ops(n, n_wave, 2 * n5, n5, sg_tail) + dh_ops(n5)
    rows = [
        {"name": "B6b chain_stack_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/chain.cu",
         "replaces": "ptyrad_tpu/ops/pallas_chain.py:529", "max_abs_err": e6,
         "ms": time_ms(lambda: C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False,
                                                need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(out6, leaves6, grad_outputs=g,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": 2 * field * n6,
         **dict(zip(("bound_ms", "bound_by"), bound(b6_bytes, b6_ops)))},
        {"name": "B5b chain_segment_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/chain.cu",
         "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": e5,
         "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, True,
                                                  need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(out5, leaves5, grad_outputs=g,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": 2 * field * n5,
         **dict(zip(("bound_ms", "bound_by"), bound(b5_bytes, b5_ops)))},
    ]
    for k in rows:
        emit({"phase": "kernel", **k, "note": "PSO shapes, shared H; scratch_bytes: the K "
              "scratch written and read back, not in the bound"})
    return rows


def check_chain_ff(dev, gen) -> list:
    """B5a and B5b with the far-field exit against
    chain_segment_plain(far_field=True) and its VJP, without and with dH
    (shared H), over the 5-slice tail: at the PSO shapes the pso_ff path
    gives them (B = 32, N = 256) and at N = 512 (B = 8: the same bytes).
    library_ms is what the exit replaces, timed on the same inputs: B5
    without the exit plus torch.fft.fft2(norm="ortho"), or that transform's
    autograd backward before B5b."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.shift import fourier_shift
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    pm, sg = PSO_PMODE, PSO_NZ - 2 * PSO_SG
    lam = electron_wavelength(PSO_KV)
    names = ["d psi", "d a", "d phi", "d h"]
    rows = []
    for n, b in ((PSO_NPIX, BATCH), (512, 8)):
        h = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
        psi = fourier_shift(torch.as_tensor(pso_probe(n), device=dev),
                            0.3 * torch.randn((b, 2), generator=gen, device=dev))
        # the tail's a/phi as views into whole patches, as multislice_dp_chain passes them
        obja = 1.0 + 0.05 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
        objp = 0.1 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
        a_t, p_t = obja[:, 0, 2 * PSO_SG:], objp[:, 0, 2 * PSO_SG:]
        g = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                          torch.randn(psi.shape, generator=gen, device=dev))

        leaves = [t.detach().clone().requires_grad_(True) for t in (psi, a_t, p_t, h)]
        out_p = C.chain_segment_plain(*leaves, True, far_field=True)
        g_plain = torch.autograd.grad(out_p, leaves, grad_outputs=g, retain_graph=True)
        out_k = C.segment_fwd_cuda(psi, a_t, p_t, h, True, far_field=True)
        (e_f,), (t_f,) = _grad_errs([out_k], [out_p.detach()])
        e_b, t_b = _grad_errs(C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, far_field=True)[:3],
                              g_plain[:3])
        e_d, t_d = _grad_errs(C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, need_dh=True,
                                                 far_field=True), g_plain)
        emit({"phase": "kernel_check", "name": "B5 chain_segment with the far-field exit",
              "N": n, "B": b, "sg": sg, "fwd_max_abs_err": e_f, "fwd_tolerance": t_f,
              "bwd_max_abs_err": e_b, "bwd_tolerance": t_b, "bwd_dh_max_abs_err": e_d,
              "bwd_dh_tolerance": t_d, "bwd_names": names})
        require(e_f <= t_f, f"B5a far-field (N={n}) differs from its plain version: {e_f} > {t_f}")
        for nm, e, t in zip(names, e_b, t_b):
            require(e <= t, f"B5b far-field {nm} (N={n}) differs: {e} > {t}")
        for nm, e, t in zip(names, e_d, t_d):
            require(e <= t, f"B5b far-field with dH {nm} (N={n}) differs: {e} > {t}")

        # what the exit replaces: the detector transform through cuFFT and autograd
        x = torch.empty_like(psi).requires_grad_(True)
        y = torch.fft.fft2(x, norm="ortho")

        def fft_bwd():
            return torch.autograd.grad(y, x, grad_outputs=g, retain_graph=True)[0]

        field, nn, n_wave, n_prop = 8 * psi.numel(), n * n, b * pm, sg - 1
        slab = 2 * 4 * b * sg * nn  # a and phi
        fft_ops = n_wave * 10 * nn * np.log2(n)
        tag = "far-field" if n == PSO_NPIX else f"far-field, N={n}"
        common = {"route": "cuda", "source": "ptyrad_tpu_torch/csrc/chain.cu"}
        new = [
            {"name": f"B5a chain_segment_fwd ({tag})", **common,
             "replaces": "ptyrad_tpu/ops/pallas_chain.py:238", "max_abs_err": e_f,
             "ms": time_ms(lambda: C.segment_fwd_cuda(psi, a_t, p_t, h, True, far_field=True)),
             "plain_ms": time_ms(lambda: C.chain_segment_plain(psi, a_t, p_t, h, True,
                                                               far_field=True)),
             "library_ms": time_ms(lambda: torch.fft.fft2(
                 C.segment_fwd_cuda(psi, a_t, p_t, h, True), norm="ortho")),
             **dict(zip(("bound_ms", "bound_by"),
                        bound(2 * field + slab + 8 * h.numel(),
                              _chain_ops(n, n_wave, n_prop, sg) + fft_ops)))},
            {"name": f"B5b chain_segment_bwd ({tag})", **common,
             "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": max(e_b),
             "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, far_field=True)),
             "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves[:3], grad_outputs=g,
                                                             retain_graph=True)),
             "library_ms": time_ms(lambda: C.segment_bwd_cuda(fft_bwd(), psi, a_t, p_t, h, True)),
             **dict(zip(("bound_ms", "bound_by"),
                        bound(3 * field + 2 * slab + 8 * h.numel(),
                              _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg) + fft_ops)))},
        ]
        if n == PSO_NPIX:
            new.append(
                {"name": f"B5b chain_segment_bwd ({tag}, dH)", **common,
                 "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": max(e_d),
                 "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, need_dh=True,
                                                          far_field=True)),
                 "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves, grad_outputs=g,
                                                                 retain_graph=True)),
                 "library_ms": time_ms(lambda: C.segment_bwd_cuda(fft_bwd(), psi, a_t, p_t, h,
                                                                  True, need_dh=True)),
                 "scratch_bytes": 2 * field * n_prop,
                 **dict(zip(("bound_ms", "bound_by"),
                            bound(3 * field + 2 * slab + 16 * h.numel(),
                                  _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg) + fft_ops
                                  + n_wave * n_prop * 8 * nn)))})
        for k in new:
            emit({"phase": "kernel", **k, "B": b, "note": "the 5-slice tail, shared H; library_ms: "
                  "B5 without the exit plus torch.fft.fft2(norm='ortho') or its autograd "
                  "backward, which the exit replaces"
                  + ("" if n == PSO_NPIX else "; no driven path runs N = 512: 0 launches")})
        rows += new
        del out_p, leaves, g_plain, y, x
        torch.cuda.empty_cache()
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
    h_each = M.dp_fwd_cuda.launches_h_each
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
    h_each = M.dp_fwd_cuda.launches_h_each - h_each
    emit({"phase": "simulate", "n_patterns": N_SCANS, "batch": SIM_BATCH,
          "tilts": "per position" if not geom.global_tilt else "none",
          "seconds": time.perf_counter() - t0, "b4a_launches": launches,
          "b4a_per_position_h_launches": h_each,
          "checked_batches": len(checks), "max_abs_err": [e for e, _ in checks],
          "tolerance": [t for _, t in checks]})
    require(launches == -(-N_SCANS // SIM_BATCH), f"simulate ran B4a {launches} times")
    require(h_each == (0 if geom.global_tilt else launches),
            f"simulate ran B4a on a per-position H {h_each} times")
    require(bool(torch.isfinite(meas).all()), "simulated measurements are not finite")
    for e, t in checks:
        require(e <= t, f"forward() differs from the plain multislice_dp: {e} > {t}")
    return meas


def kernel_counters():
    """Row name -> (wrapper, count attribute): `launches` counts every
    launch; `launches_h_each` those on a per-position H; `launches_dh` the
    backwards that computed dH; `launches_ff` those of B5 that took the
    far-field exit, `launches_ff_dh` its backwards that also computed dH;
    `launches_nz1` those of B3 at one slice; PLAIN_ROUTE the forward() calls
    that took the plain torch.fft chain."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops import patches as P

    every = {"B1 gather_patches": P.gather_cuda, "B2 scatter_add_patches": P.scatter_add_cuda,
             "B3a loss_sums_fwd": M.loss_sums_fwd_cuda, "B3b loss_sums_bwd": M.loss_sums_bwd_cuda,
             "B4a dp_fwd": M.dp_fwd_cuda, "B4b dp_bwd": M.dp_bwd_cuda,
             "B5a chain_segment_fwd": C.segment_fwd_cuda,
             "B5b chain_segment_bwd": C.segment_bwd_cuda,
             "B6a chain_stack_fwd": C.stack_fwd_cuda, "B6b chain_stack_bwd": C.stack_bwd_cuda}
    out = {name: (fn, "launches") for name, fn in every.items()}
    out.update({
        PLAIN_ROUTE: (importlib.import_module("ptyrad_tpu_torch.models.forward").forward,
                      "launches_plain"),
        "B3a loss_sums_fwd (per-position H)": (M.loss_sums_fwd_cuda, "launches_h_each"),
        "B3b loss_sums_bwd (dH)": (M.loss_sums_bwd_cuda, "launches_dh"),
        "B3a loss_sums_fwd (nz=1)": (M.loss_sums_fwd_cuda, "launches_nz1"),
        "B3b loss_sums_bwd (nz=1)": (M.loss_sums_bwd_cuda, "launches_nz1"),
        "B4a dp_fwd (per-position H)": (M.dp_fwd_cuda, "launches_h_each"),
        "B4b dp_bwd (dH)": (M.dp_bwd_cuda, "launches_dh"),
        "B5b chain_segment_bwd (dH)": (C.segment_bwd_cuda, "launches_dh"),
        "B6b chain_stack_bwd (dH)": (C.stack_bwd_cuda, "launches_dh"),
        "B5a chain_segment_fwd (far-field)": (C.segment_fwd_cuda, "launches_ff"),
        "B5b chain_segment_bwd (far-field)": (C.segment_bwd_cuda, "launches_ff"),
        "B5b chain_segment_bwd (far-field, dH)": (C.segment_bwd_cuda, "launches_ff_dh"),
    })
    return out


PLAIN_ROUTE = "forward() plain route"
PATCH_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches")
CHAIN_KERNELS = ("B5a chain_segment_fwd", "B5b chain_segment_bwd", "B6a chain_stack_fwd",
                 "B6b chain_stack_bwd")
TBL_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B3a loss_sums_fwd",
               "B3b loss_sums_bwd")
LOW_DOSE_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B4a dp_fwd", "B4b dp_bwd")
PSO_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B5a chain_segment_fwd",
               "B5b chain_segment_bwd", "B6a chain_stack_fwd", "B6b chain_stack_bwd")
TILT_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches",
                "B3a loss_sums_fwd (per-position H)", "B3b loss_sums_bwd (dH)")
PSO_FF_KERNELS = PSO_KERNELS + ("B5a chain_segment_fwd (far-field)",
                                "B5b chain_segment_bwd (far-field)")
PSO_TILT_KERNELS = PSO_KERNELS + ("B5b chain_segment_bwd (dH)", "B6b chain_stack_bwd (dH)")
# Rows of the kernels line that only size the far-field kernels at N = 512: every
# driven path runs them at N = 256 (PSO_NPIX), so these rows report 0 launches.
NOT_DRIVEN = ("B5a chain_segment_fwd (far-field, N=512)",
              "B5b chain_segment_bwd (far-field, N=512)")


def counted(fn):
    """fn() with every launch count set to 0 just before it: (its result,
    the counts just after)."""
    counters = kernel_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(f, attr) for name, (f, attr) in counters.items()}


def drive(solver) -> dict:
    """solver.run() under counted(): the counts of the run."""
    return counted(solver.run)[1]


def add_counts(*runs) -> dict:
    return {k: sum(run[k] for run in runs) for k in runs[0]}


def tbl_init() -> dict:
    """init_variables of the tBL simulation: the known object, the probe,
    the raster and the yml's 2 Ang slices; no tilt; measurements to fill."""
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    crop_pos, canvas = tbl_positions()
    lam = electron_wavelength(80.0)
    return {
        "obj": np.exp(1j * ground_truth_phase(canvas))[None].astype(np.complex64),
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


def main_path(dev, card: str):
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    t0 = time.perf_counter()
    init = tbl_init()
    init["measurements"] = simulate(dev, init)
    init["obj"] = np.ones_like(init["obj"])
    setup_s = time.perf_counter() - t0

    solver = PtyRADSolver(TBL_PARAMS, init_variables=init, device=dev, verbose=True)
    torch.cuda.reset_peak_memory_stats()
    record = RunRecord()
    t1 = time.perf_counter()
    launches = counted(lambda: solver.run(callback=record))[1]
    run_s = time.perf_counter() - t1
    record.finish(solver)

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
    return solver, launches, init, record


# -- determinism (fault C9): two runs of a path equal bit for bit ---------------

class RunRecord:
    """A solver callback that keeps every iteration's per-batch loss terms;
    ``finish`` keeps the final obja, objp and probe on the host."""

    def __init__(self):
        self.batch_terms = {}
        self.losses = []
        self.tensors = {}

    def __call__(self, niter, params, history):
        self.batch_terms[niter] = {k: list(v) for k, v in history.batch_terms.items()}

    def finish(self, solver):
        self.losses = [v for _, v in solver.history.loss_iters]
        self.tensors = {k: getattr(solver.params, k).detach().cpu().clone()
                        for k in ("obja", "objp", "probe")}


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) if a.size else 0.0


def nondeterministic_ops(solver, niter: int) -> list:
    """What torch.use_deterministic_algorithms(True, warn_only=True) names
    while the solver runs 2 batches: the ops with no deterministic CUDA
    implementation on the path (the diagnostic when two runs part)."""
    import warnings

    idx = torch.as_tensor(solver.batch_idx[:2], device=solver.device)
    mask = torch.as_tensor(solver.batch_mask[:2], device=solver.device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver.train_epoch(idx, mask, niter)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:200] for w in caught})


def determinism_check(path: str, card: str, first: RunRecord, second: RunRecord,
                      solver=None) -> None:
    """Two runs of a path (same data, same sections, one process) must give
    the same per-batch loss terms in every iteration, the same losses and
    the same final obja, objp and probe, bit for bit: B3b/B4b reduce over
    modes and samples in a fixed order and B2 sums in batch order. Where
    they part, the ops torch's deterministic mode warns about are named
    (``solver``: a solver of the path to run them on)."""
    iters = sorted(first.batch_terms)
    batches_equal = {n: first.batch_terms[n] == second.batch_terms.get(n) for n in iters}
    tensors_equal = {k: torch.equal(first.tensors[k], second.tensors[k]) for k in first.tensors}
    out = {"phase": "determinism", "path": path, "card": card, "iterations": iters,
           "losses": [first.losses, second.losses],
           "losses_equal": first.losses == second.losses,
           "batch_terms_equal": batches_equal, "tensors_equal": tensors_equal,
           "batch_terms_max_rel_diff": {
               n: max(_max_rel(first.batch_terms[n][k], second.batch_terms[n][k])
                      for k in first.batch_terms[n]) for n in iters},
           "tensors_max_rel_diff": {k: _max_rel(first.tensors[k].abs().numpy(),
                                                second.tensors[k].abs().numpy())
                                    for k in first.tensors}}
    same = out["losses_equal"] and all(batches_equal.values()) and all(tensors_equal.values())
    if not same and solver is not None:
        out["nondeterministic_ops"] = nondeterministic_ops(solver, iters[-1])
    emit(out)
    require(same, f"determinism ({path}): two runs differ: {out}")


# -- the resume phase: a checkpoint of iteration 2 continues at iteration 3 ------

def resume_from(ckpt: dict, params: dict, init: dict, dev, verbose: bool = False):
    """A solver set to go on from a checkpoint: ``ckpt`` is make_save_dict's
    dict or load_ptyrad's of a model.hdf5 (which needs h5py). The
    optimizable tensors go into ``init`` (the object as float64 amplitude
    and phase, which make_model splits back into the float32 ones exactly),
    the optimizer state through optim.load_opt_state_values. Run it with
    recon_loop(start_niter=<the checkpoint's niter> + 1)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.optim import load_opt_state_values

    t = ckpt["optimizable_tensors"]
    obj = np.asarray(t["obja"], np.float64) * np.exp(1j * np.asarray(t["objp"], np.float64))
    iv = {**init, "obj": obj, "probe": t["probe"], "probe_pos_shifts": t["probe_pos_shifts"],
          "obj_tilts": t["obj_tilts"], "slice_thickness": t["slice_thickness"]}
    solver = PtyRADSolver(params, init_variables=iv, device=dev, verbose=verbose)
    solver.prepare()
    solver._build()
    load_opt_state_values(solver.optimizer, ckpt["optim_state_dict"])
    return solver


def resume_step(solver, start_niter: int, verbose: bool = False):
    """Iteration ``start_niter`` of a resumed solver; its ReconHistory."""
    from ptyrad_tpu_torch.engine.solver import recon_loop

    return recon_loop(solver.train_epoch, solver.params, solver.batch_idx, solver.batch_mask, 1,
                      solver.constraint_fn, solver.buffers, verbose=verbose,
                      optimizer=solver.optimizer, start_niter=start_niter)[1]


def batch_totals(history) -> np.ndarray:
    """The total loss of each batch of the history's last iteration, in the
    order the batches ran."""
    return np.sum([np.asarray(v) for v in history.batch_terms.values()], axis=0)


# -- the optimizer phases (A5): LBFGS, accumulation, every family, grouping ----

LBFGS_NITER = 2          # iterations of each of the lbfgs phase's two runs
GRAD_ACCUM, GRAD_ACCUM_NITER = 4, 2
FAMILY_BATCHES = 16      # batches each optimizer family runs
# every registry name but Adam (the main phase's) and LBFGS (its own phase),
# with the configs of a torch-named params file
FAMILIES = (("AdamW", {"weight_decay": 0.1}), ("SGD", {"momentum": 0.9}), ("RMSprop", {}),
            ("Adagrad", {}), ("Adamax", {}), ("NAdam", {}), ("RAdam", {}), ("Adadelta", {}),
            ("Rprop", {}), ("ASGD", {}), ("Adafactor", {}), ("Muon", {}), ("SparseAdam", {}))
FAMILY_RTOL = 1e-5       # one step on CUDA against the same step on the CPU
# seconds each of these phases is expected to take on the card (PERF.md §6)
PREDICTED_S = {"lbfgs": (10, 60), "grad_accum": (8, 20), "optimizers": (0, 20),
               "grouping": (5, 30)}


def with_optimizer(params: dict, optimizer_params: dict, **recon) -> dict:
    out = copy.deepcopy(params)
    out["model_params"]["optimizer_params"] = optimizer_params
    out["recon_params"].update(recon)
    return out


def lbfgs_run(dev, init: dict, niter: int):
    """tBL's own sections with LBFGS (history_size 10) for niter iterations:
    (solver, launches, the parameters after the last iteration on the
    host)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    params = with_optimizer(TBL_PARAMS, {"name": "LBFGS", "configs": {"history_size": 10}},
                            NITER=niter)
    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    _, launches = counted(solver.run)
    return solver, launches, {k: t.detach().cpu().clone() for k, t in solver.params.named()}


def batch_mean_loss(solver) -> float:
    """The mean of the per-batch losses at the solver's parameters (no
    gradient), summed in batch order as the LBFGS objective sums them."""
    from ptyrad_tpu_torch.engine.solver import loss_fn

    acc = torch.zeros((), dtype=torch.float32, device=solver.device)
    with torch.no_grad():
        for i, m in zip(solver.batch_idx, solver.batch_mask):
            acc = acc + loss_fn(solver.params, solver.buffers, solver.geom,
                                torch.as_tensor(i, device=solver.device),
                                torch.as_tensor(m, device=solver.device), solver.loss_params)[0]
    return float(acc / len(solver.batch_idx))


def lbfgs_path(dev, card: str, init: dict) -> dict:
    """LBFGS at tBL full width through B1, B2, B3a and B3b: the objective is
    the mean loss over all 512 batches (one backward per batch), and each
    iteration runs the zoom line search, every step of which evaluates it
    again. Gates: a finite, falling loss; probe_pos_shifts (start_iter 10)
    unchanged bit for bit; the first objective value equal to the batch
    mean recomputed at the start parameters (rtol 1e-6); a second run
    (its values, line-search steps, evaluations and final parameters) equal
    to the first bit for bit, which needs B3b's fixed-order reduce."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.optim_lbfgs import LBFGS

    t0 = time.perf_counter()
    probe = PtyRADSolver(TBL_PARAMS, init_variables=init, device=dev, verbose=False)
    probe.prepare()
    start_mean = batch_mean_loss(probe)
    shifts0 = probe.params.probe_pos_shifts.detach().cpu().clone()
    del probe
    solver, launches, final = lbfgs_run(dev, init, LBFGS_NITER)
    first_s = time.perf_counter() - t0
    h = solver.history
    losses = [v for _, v in h.loss_iters]
    steps = [(s, e) for _, s, e in h.linesearch]
    shifts = solver.params.probe_pos_shifts.detach().cpu()
    require(isinstance(solver.optimizer, LBFGS), "lbfgs: the solver did not build LBFGS")
    del solver
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    again, counts, again_final = lbfgs_run(dev, init, LBFGS_NITER)
    rerun_s = time.perf_counter() - t1
    launches = add_counts(launches, counts)
    rerun = {"losses": [v for _, v in again.history.loss_iters],
             "linesearch": [(s, e) for _, s, e in again.history.linesearch]}
    same = (rerun["losses"] == losses and rerun["linesearch"] == steps
            and all(torch.equal(final[k], again_final[k]) for k in final))
    del again
    out = {"phase": "lbfgs", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
           "history_size": 10, "iterations": len(losses), "losses": losses,
           "linesearch_steps": [s for s, _ in steps], "evaluations": [e for _, e in steps],
           "iter_s": h.iter_times, "patterns_per_s_per_evaluation": [
               N_SCANS * e / t for (_, e), t in zip(steps, h.iter_times)],
           "first_value": losses[0], "batch_mean_at_start": start_mean,
           "first_value_rel_diff": abs(losses[0] - start_mean) / abs(start_mean),
           "rerun": rerun, "rerun_bitwise": same,
           "shifts_unchanged": bool(torch.equal(shifts, shifts0)),
           "seconds": first_s + rerun_s, "rerun_s": rerun_s,
           "predicted_s": PREDICTED_S["lbfgs"], "launches": launches}
    emit(out)
    require(len(losses) == LBFGS_NITER and all(np.isfinite(losses)),
            f"lbfgs: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"lbfgs: loss did not fall: {losses}")
    require(out["shifts_unchanged"], "lbfgs: probe_pos_shifts moved before its start_iter")
    require(out["first_value_rel_diff"] <= 1e-6,
            f"lbfgs: first objective {losses[0]} is not the batch mean {start_mean}")
    require(same, f"lbfgs: a second run differs: {rerun} against {losses}, {steps}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the lbfgs path")
    return launches


def grad_accum_path(dev, card: str, init: dict) -> dict:
    """Adam with grad_accumulation 4 at tBL full width: one step every 4
    batches, the running mean carried across iterations. A finite, falling
    loss; each tensor's Adam step count is the batches run over 4."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.optim import MultiSteps

    params = with_optimizer(TBL_PARAMS, {"name": "Adam"}, NITER=GRAD_ACCUM_NITER)
    params["recon_params"]["BATCH_SIZE"] = {"size": BATCH, "grad_accumulation": GRAD_ACCUM}
    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    t0 = time.perf_counter()
    _, launches = counted(solver.run)
    seconds = time.perf_counter() - t0
    losses = [v for _, v in solver.history.loss_iters]
    opt = solver.optimizer
    n_batches = len(solver.batch_idx) * GRAD_ACCUM_NITER
    steps = {g["name"]: float(opt.state[g["params"][0]]["step"]) for g in opt.param_groups}
    out = {"phase": "grad_accum", "card": card, "grad_accumulation": GRAD_ACCUM,
           "iterations": len(losses), "losses": losses, "iter_s": solver.history.iter_times,
           "patterns_per_s": [N_SCANS / t for t in solver.history.iter_times],
           "adam_steps": steps, "mini_step": opt.mini_step, "seconds": seconds,
           "predicted_s": PREDICTED_S["grad_accum"], "launches": launches}
    emit(out)
    require(isinstance(opt, MultiSteps), "grad_accum: the optimizer is not accumulating")
    require(len(losses) == GRAD_ACCUM_NITER and all(np.isfinite(losses)),
            f"grad_accum: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"grad_accum: loss did not fall: {losses}")
    require(all(v == n_batches // GRAD_ACCUM for v in steps.values()),
            f"grad_accum: step counts {steps}, not {n_batches // GRAD_ACCUM}")
    require(opt.mini_step == n_batches % GRAD_ACCUM, f"grad_accum: mini_step {opt.mini_step}")
    return launches


def _cpu_twin(solver, name: str, configs: dict, update: dict):
    """The solver's parameters and optimizer state copied to the CPU, with
    an optimizer of the same family over them."""
    from ptyrad_tpu_torch.models.state import PtychoParams
    from ptyrad_tpu_torch.optim import create_optimizer, load_opt_state_values, \
        optim_state_values

    params = PtychoParams(**{k: t.detach().cpu().clone() for k, t in solver.params.named()})
    opt, _, _ = create_optimizer({"name": name, "configs": configs}, update, params)
    load_opt_state_values(opt, optim_state_values(solver.optimizer))
    return params, opt


def optimizers_path(dev, card: str, init: dict) -> dict:
    """Every registry name but Adam and LBFGS on the card: FAMILY_BATCHES
    tBL batches each from the same start through B1-B3 (finite losses);
    then one more step on CUDA and the same step on the CPU, from copies of
    the same parameters, optimizer state and gradients, agreeing at rtol
    1e-5 (atol 1e-5 of each tensor's largest entry: torch's foreach and
    fused CUDA paths against the CPU's). AdamW (weight_decay 0.1) starts obja
    at iteration 2: run at iteration 1, obja must not move at all."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver, build_train_epoch, loss_fn
    from ptyrad_tpu_torch.optim import create_optimizer, mask_unstarted_grads, \
        unstarted_tensors

    t0 = time.perf_counter()
    solver = PtyRADSolver(TBL_PARAMS, init_variables=init, device=dev, verbose=False)
    solver.prepare()
    start = {k: t.detach().clone() for k, t in solver.params.named()}
    idx = torch.as_tensor(solver.batch_idx[:FAMILY_BATCHES + 1], device=dev)
    mask = torch.as_tensor(solver.batch_mask[:FAMILY_BATCHES + 1], device=dev)
    rows, launches = [], None
    for name, configs in FAMILIES:
        update = copy.deepcopy(TBL_PARAMS["model_params"]["update_params"])
        if name == "AdamW":
            update["obja"]["start_iter"] = 2
        with torch.no_grad():
            for k, t in solver.params.named():
                t.copy_(start[k])
        solver.optimizer, _, start_dict = create_optimizer(
            {"name": name, "configs": configs}, update, solver.params)
        epoch = build_train_epoch(solver.params, solver.buffers, solver.geom,
                                  solver.loss_params, solver.optimizer, start_dict)
        t1 = time.perf_counter()
        (_, terms), counts = counted(lambda: epoch(idx[:-1], mask[:-1], 1))
        seconds = time.perf_counter() - t1
        launches = counts if launches is None else add_counts(launches, counts)
        totals = np.sum([np.asarray(v) for v in terms.values()], axis=0)
        obja_still = bool(torch.equal(solver.params.obja, start["obja"]))
        # one more batch's gradients, then the same step on both devices
        solver.optimizer.zero_grad(set_to_none=True)
        loss_fn(solver.params, solver.buffers, solver.geom, idx[-1], mask[-1],
                solver.loss_params)[0].backward()
        mask_unstarted_grads(solver.params, 1, start_dict)
        cpu_params, cpu_opt = _cpu_twin(solver, name, configs, update)
        for (_, a), (_, b) in zip(solver.params.named(), cpu_params.named()):
            b.grad = None if a.grad is None else a.grad.detach().cpu().clone()
        for p, o in ((solver.params, solver.optimizer), (cpu_params, cpu_opt)):
            frozen = unstarted_tensors(p, 1, start_dict)
            kept = [t.detach().clone() for t in frozen]
            o.step()
            with torch.no_grad():
                for t, k in zip(frozen, kept):
                    t.copy_(k)
        errs = {}
        for (k, a), (_, b) in zip(solver.params.named(), cpu_params.named()):
            a, b = a.detach().cpu(), b.detach()
            scale = float(b.abs().max())
            errs[k] = float(((a - b).abs() - FAMILY_RTOL * b.abs()).max()) / max(scale, 1e-30)
        rows.append({"name": name, "configs": configs, "losses_first_last":
                     [float(totals[0]), float(totals[-1])], "finite": bool(np.isfinite(totals).all()),
                     "seconds": seconds, "cuda_vs_cpu_excess": errs,
                     "obja_unchanged_before_start": obja_still if name == "AdamW" else None})
    seconds = time.perf_counter() - t0
    emit({"phase": "optimizers", "card": card, "batches": FAMILY_BATCHES, "families": rows,
          "rtol": FAMILY_RTOL, "seconds": seconds, "predicted_s": PREDICTED_S["optimizers"],
          "launches": launches})
    for r in rows:
        require(r["finite"], f"optimizers: {r['name']} gave a non-finite loss")
        bad = {k: v for k, v in r["cuda_vs_cpu_excess"].items() if v > FAMILY_RTOL}
        require(not bad, f"optimizers: {r['name']}'s step on CUDA differs from the CPU's: {bad}")
    require(rows[0]["obja_unchanged_before_start"],
            "optimizers: AdamW moved obja before its start_iter")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the optimizers path")
    return launches


def grouping_path(dev, card: str, init: dict):
    """compact and sparse grouping of the 16,384 tBL positions (scikit-learn's
    MiniBatchKMeans, then the max-min assignment), one iteration each: the
    host seconds of make_batches, every index in exactly one batch, no
    batch empty, compact batches tighter than random ones and sparse ones
    wider (tests/test_engine.py:98-138's contract); None where scikit-learn
    does not import."""
    from ptyrad_tpu_torch.engine.batching import make_batches
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    if not optional_packages()["sklearn"]:
        print("grouping: skipped, scikit-learn missing", flush=True)
        emit({"phase": "grouping", "card": card, "skipped": "scikit-learn missing"})
        return None
    pos = init["crop_pos"].astype(np.float64)
    indices = np.arange(N_SCANS)

    def spread(batches):
        return float(np.mean([np.linalg.norm(pos[b] - pos[b].mean(0), axis=1).mean()
                              for b in batches]))

    def nearest(batches):
        """The mean over batches of each batch's smallest in-batch distance
        (on 64 seeded batches: the pairwise table of 32 positions each)."""
        vals = []
        pick = np.random.default_rng(SEED).choice(len(batches), min(64, len(batches)),
                                                  replace=False)
        for i in sorted(pick):
            b = pos[batches[i]]
            d = np.linalg.norm(b[:, None] - b[None], axis=-1)
            np.fill_diagonal(d, np.inf)
            vals.append(d.min())
        return float(np.mean(vals))

    random_b = make_batches(indices, pos, BATCH, mode="random", seed=SEED)
    out = {"phase": "grouping", "card": card, "n_positions": N_SCANS, "batch": BATCH,
           "random": {"spread": spread(random_b), "nearest": nearest(random_b)}}
    launches = None
    t_all = time.perf_counter()
    for mode in ("compact", "sparse"):
        params = copy.deepcopy(TBL_PARAMS)
        params["recon_params"].update(NITER=1, GROUP_MODE=mode)
        solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
        t0 = time.perf_counter()
        solver.prepare()  # make_batches, then the padding
        make_s = time.perf_counter() - t0
        batches = [i[m > 0] for i, m in zip(solver.batch_idx, solver.batch_mask)]
        flat = np.sort(np.concatenate(batches))
        _, counts = counted(solver.run)
        launches = counts if launches is None else add_counts(launches, counts)
        loss = solver.history.loss_iters[-1][1]
        out[mode] = {"make_batches_s": make_s, "batches": len(batches),
                     "sizes": [int(min(map(len, batches))), int(max(map(len, batches)))],
                     "partition": bool(np.array_equal(flat, indices)),
                     "empty": int(sum(len(b) == 0 for b in batches)),
                     "spread": spread(batches), "nearest": nearest(batches),
                     "loss": loss, "iter_s": solver.history.iter_times[-1]}
        del solver
    out.update(seconds=time.perf_counter() - t_all, predicted_s=PREDICTED_S["grouping"],
               launches=launches)
    emit(out)
    for mode in ("compact", "sparse"):
        r = out[mode]
        require(r["partition"] and r["empty"] == 0, f"grouping ({mode}): not a partition: {r}")
        require(np.isfinite(r["loss"]), f"grouping ({mode}): loss not finite")
    require(out["compact"]["spread"] < out["random"]["spread"],
            "grouping: compact batches are not tighter than random ones")
    require(out["sparse"]["nearest"] > out["compact"]["nearest"],
            "grouping: sparse batches are not wider than compact ones")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the grouping path")
    return launches


# -- the params_file phase: the tBL run from its params file --------------------

OPTIONAL_PACKAGES = ("pydantic", "h5py", "yaml", "PIL", "scipy", "sklearn", "matplotlib",
                     "optuna")
SIM_DX = 0.1494  # Ang, the simulation's pixel size (tbl_probe, tbl_init)
RAW_GAP = 1024   # bytes after each EMPAD frame
INIT_STAGES = ("init_cache", "_load_meas", "_process_meas", "init_calibration",
               "set_variables_dict", "init_probe", "init_pos", "init_obj", "init_omode_occu",
               "init_H", "init_obj_tilts", "init_check")


def _tune(state: bool, suggest: str, **kwargs) -> dict:
    return {"state": state, "suggest": suggest, "kwargs": kwargs}


def tbl_params_file(meas_path: str) -> dict:
    """The params file of the params_file phase: the init_params of
    demo/params/tBL_WSe2_reconstruct.yml for the .raw at ``meas_path`` and
    TBL_PARAMS' other four sections, with every key that validation would
    fill written out (a fixed point of params/schema.py, held so by
    tests/test_torch_params.py), so the card's machine runs what validation
    would have given with or without pydantic. pos_scan_step_size is the
    simulated scan's (3 px of SIM_DX), not the yml's 0.4290 Ang."""
    return {
        "init_params": {
            "probe_illum_type": "electron", "probe_kv": 80.0, "probe_conv_angle": 24.9,
            "probe_defocus": 0.0, "probe_c3": 0.0, "probe_c5": 0.0,
            "beam_kev": None, "probe_dRn": None, "probe_Rn": None, "probe_D_H": None,
            "probe_D_FZP": None, "probe_Ls": None,
            "meas_Npix": NPIX, "pos_N_scans": N_SCANS, "pos_N_scan_slow": N_SIDE,
            "pos_N_scan_fast": N_SIDE, "pos_scan_step_size": STEP_PX * SIM_DX,
            "meas_calibration": {"mode": "fitRBF", "value": None, "thresh": 0.5},
            "probe_pmode_max": PMODE, "probe_pmode_init_pows": [0.02],
            "obj_omode_max": 1, "obj_omode_init_occu": {"occu_type": "uniform", "init_occu": None},
            "obj_Nlayer": NZ, "obj_slice_thickness": 2.0,
            "meas_permute": None, "meas_reshape": None, "meas_flipT": [1, 0, 0],
            "meas_crop": None, "meas_pad": None, "meas_resample": None,
            "meas_add_source_size": None, "meas_add_detector_blur": None,
            "meas_remove_neg_values": {"mode": "clip_neg", "value": None, "force": False},
            "meas_normalization": {"mode": "max_at_one", "value": None},
            "meas_add_poisson_noise": None, "meas_export": None,
            "probe_permute": None, "pos_scan_flipT": None, "pos_scan_affine": None,
            "pos_scan_rand_std": 0.15,
            "meas_source": "file",
            "meas_params": {"path": meas_path, "key": None, "shape": None, "offset": None,
                            "gap": None},
            "probe_source": "simu", "probe_params": None, "pos_source": "simu",
            "pos_params": None, "obj_source": "simu", "obj_params": None,
            "tilt_source": "simu", "tilt_params": {"tilt_type": "all", "init_tilts": [[0.0, 0.0]]},
        },
        "model_params": {
            "obj_preblur_std": None, "detector_blur_std": None,
            "optimizer_params": {"name": "Adam", "configs": {}, "load_state": None},
            "update_params": TBL_PARAMS["model_params"]["update_params"],
            "fwd_fused": None, "fwd_remat": False, "compute_dtype": "float32",
            "matmul_dtype": None, "meas_dtype": "float32",
        },
        "loss_params": {
            **TBL_PARAMS["loss_params"],
            "loss_poissn": {"state": False, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-06},
            "loss_pacbed": {"state": False, "weight": 0.5, "dp_pow": 0.2},
            "loss_simlar": {"state": False, "weight": 0.1, "obj_type": "both",
                            "scale_factor": [1.0, 1.0], "blur_std": 1.0},
        },
        "constraint_params": {
            **TBL_PARAMS["constraint_params"],
            "probe_mask_k": {"freq": None, "radius": 0.22, "width": 0.05, "power_thresh": 0.95},
            "kr_filter": {"freq": None, "obj_type": "both", "radius": 0.15, "width": 0.05},
            "kz_filter": {"freq": None, "obj_type": "both", "beta": 1.0, "alpha": 1.0},
            "complex_ratio": {"freq": None, "obj_type": "both", "alpha1": 1.0, "alpha2": 0.0},
            "mirrored_amp": {"freq": None, "relax": 0.1, "scale": 0.03, "power": 4.0},
            "tilt_smooth": {"freq": None, "std": 2.0},
        },
        "recon_params": {
            "NITER": NITER,
            "INDICES_MODE": {"mode": "full", "subscan_slow": None, "subscan_fast": None},
            "BATCH_SIZE": {"size": BATCH, "grad_accumulation": 1},
            "GROUP_MODE": "random", "GROUP_MODE_SEED": SEED, "SAVE_ITERS": 10,
            "shard_measurements": True, "shard_canvas": False, "output_dir": "output/tBL_WSe2/",
            "recon_dir_affixes": ["default"], "prefix_time": "%Y%m%d", "prefix": "",
            "postfix": "", "save_result": ["model", "objp", "probe"],
            "result_modes": {"obj_dim": [2, 3], "FOV": ["crop"], "bit": ["8"]},
            "selected_figs": ["loss", "forward", "probe_r_amp", "pos"],
            "copy_params": True, "if_quiet": False,
        },
        "hypertune_params": {
            "if_hypertune": False, "collate_results": True, "append_params": True,
            "sampler_params": {"name": "TPESampler", "configs": {}},
            "pruner_params": {"name": "HyperbandPruner", "configs": {}},
            "n_trials": 50, "timeout": None, "error_metric": "loss",
            "storage_path": "hypertune.db", "study_name": "ptyrad_hypertune",
            "tune_params": {
                "optimizer": _tune(False, "cat", choices=["Adam", "AdamW", "RMSprop", "SGD"],
                                   optim_configs={}),
                "batch_size": _tune(False, "int", low=16, high=512, log=True),
                "plr": _tune(False, "cat", choices=[1e-2, 1e-3, 1e-4]),
                **{k: _tune(False, "float", low=1e-4, high=1e-2, log=True)
                   for k in ("oalr", "oplr", "slr", "tlr", "dzlr")},
                "dx": _tune(False, "float", low=0.14, high=0.16, step=0.001),
                "pmode_max": _tune(False, "int", low=1, high=8, step=1),
                "conv_angle": _tune(False, "float", low=24, high=26, step=1),
                "defocus": _tune(False, "float", low=-50, high=50, step=0.1),
                "c3": _tune(False, "float", low=4000, high=10000, step=100),
                "c5": _tune(False, "float", low=50000, high=100000, step=5000),
                "Nlayer": _tune(False, "int", low=1, high=8, step=1),
                "dz": _tune(False, "float", low=4, high=8, step=0.5),
                "scale": _tune(True, "float", low=0.8, high=1.2, step=0.02),
                "asymmetry": _tune(False, "float", low=-0.2, high=0.2, step=0.05),
                "rotation": _tune(True, "float", low=-4, high=4, step=0.5),
                "shear": _tune(False, "float", low=-4, high=4, step=0.5),
                "tilt_y": _tune(False, "float", low=-5, high=5, step=0.5),
                "tilt_x": _tune(False, "float", low=-5, high=5, step=0.5),
            },
        },
        "params_path": None,
    }


def optional_packages() -> dict:
    """Which of the optional host packages import on this machine."""
    found = {}
    for name in OPTIONAL_PACKAGES:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def write_raw(path: str, meas: np.ndarray) -> float:
    """Write (N, H, W) float32 patterns as an EMPAD .raw (RAW_GAP zero bytes
    after each frame), flipped along ky so that meas_flipT [1, 0, 0]
    restores them; returns the seconds."""
    t0 = time.perf_counter()
    n = meas.shape[0]
    frame = meas[0].nbytes
    buf = np.zeros((n, frame + RAW_GAP), np.uint8)
    buf[:, :frame] = np.ascontiguousarray(np.flip(meas, axis=1)).view(np.uint8).reshape(n, frame)
    buf.tofile(path)
    return time.perf_counter() - t0


class StageTimer:
    """Wall seconds of each Initializer stage (INIT_STAGES) and of the CBED
    fit, by wrapping them on the class for the duration of a ``with``."""

    def __init__(self):
        self.seconds: dict = {}

    def _wrap(self, owner, name: str):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return fn, timed

    def __enter__(self):
        import ptyrad_tpu_torch.initialization as I

        self._saved = []
        for owner, names in ((I.Initializer, INIT_STAGES), (I, ("fit_cbed_pattern",))):
            for name in names:
                fn, timed = self._wrap(owner, name)
                self._saved.append((owner, name, fn))
                setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def params_file_path(dev, card: str, meas: np.ndarray, tmp: str) -> tuple[dict, str]:
    """The tBL run from its params file through the normal entry point:
    the main phase's patterns written as an EMPAD .raw in ``tmp`` and the
    params as a .json (no package needed), then load_params ->
    PtyRADSolver(params, init_rng=RandomState(SEED)) -> run(), validated
    where pydantic imports. Then a .npy of the same patterns with a dx
    calibration, no jitter and no normalization, whose measurements must
    equal the patterns bit for bit. Returns the run's launch counts and the
    .raw's path (the cli phase reads it again)."""
    from ptyrad_tpu_torch import load as L
    from ptyrad_tpu_torch import native
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.initialization import Initializer

    packages = optional_packages()
    emit({"phase": "params_file_packages", "imports": packages})
    raw_path, json_path = f"{tmp}/tbl.raw", f"{tmp}/tbl.json"
    write_s = write_raw(raw_path, meas)
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(tbl_params_file(raw_path), f)
    params = L.load_params(json_path, validate=packages["pydantic"])
    L.LAST_RAW_READ.clear()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the main phase's patterns, still held
    t0 = time.perf_counter()
    with StageTimer() as timer:
        solver = PtyRADSolver(params, init_rng=np.random.RandomState(SEED), device=dev,
                              verbose=True)
    init_s = time.perf_counter() - t0
    raw_read = dict(L.LAST_RAW_READ)
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1

    iv = solver.init_variables
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    mean_max = float(iv["measurements"].mean(0).max())
    out = {
        "phase": "params_file", "card": card, "validated": packages["pydantic"],
        "raw_bytes": os.path.getsize(raw_path), "write_raw_s": write_s,
        "raw_reader": raw_read.get("reader"), "native_build_error": native.BUILD_ERROR,
        "load_raw_s": raw_read.get("seconds"),
        "load_raw_gb_per_s": raw_read["bytes"] / raw_read["seconds"] / 1e9,
        "init_s": init_s, "init_stage_s": timer.seconds,
        "measurements": [list(iv["measurements"].shape), str(iv["measurements"].dtype)],
        "mean_pattern_max": mean_max, "fitRBF": iv["fitRBF"], "dx": iv["dx"],
        "dx_rel_err": iv["dx"] / SIM_DX - 1.0,
        "probe": list(solver.params.probe.shape), "obja": list(solver.params.obja.shape),
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [N_SCANS / t for t in times], "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "resident_before_gb": resident / 1e9, "launches": launches,
    }
    emit(out)
    require(raw_read.get("reader") == "native",
            f"the .raw was not read by the native reader: {raw_read}, "
            f"build error {native.BUILD_ERROR}")
    require(iv["measurements"].shape == (N_SCANS, NPIX, NPIX)
            and iv["measurements"].dtype == np.float32,
            f"measurements {iv['measurements'].shape} {iv['measurements'].dtype}")
    require(abs(mean_max - 1.0) <= 1e-6, f"max_at_one left the mean pattern's max at {mean_max}")
    require(tuple(solver.params.probe.shape) == (PMODE, NPIX, NPIX),
            f"probe {tuple(solver.params.probe.shape)}")
    require(tuple(solver.params.obja.shape[:2]) == (1, NZ), f"object {solver.params.obja.shape}")
    require(abs(iv["dx"] / SIM_DX - 1.0) <= 0.05, f"fitted dx {iv['dx']} vs {SIM_DX}")
    require(len(losses) == NITER and all(np.isfinite(losses)), f"loss not finite: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the params_file path")
    for name in ("B4a dp_fwd", "B4b dp_bwd") + CHAIN_KERNELS:
        require(launches[name] == 0, f"kernel {name} was launched on the params_file path")
    del solver, iv
    torch.cuda.empty_cache()

    npy_path = f"{tmp}/tbl.npy"
    np.save(npy_path, meas)
    ip = tbl_params_file(npy_path)["init_params"]
    ip.update(meas_flipT=None, pos_scan_rand_std=None,
              meas_calibration={"mode": "dx", "value": SIM_DX, "thresh": 0.5},
              meas_normalization={"mode": "divide_const", "value": 1.0})
    t2 = time.perf_counter()
    npy_init = Initializer(ip, verbose=False, rng=np.random.RandomState(SEED)).init_all()
    got = npy_init.init_variables["measurements"]
    same = got.dtype == meas.dtype and got.shape == meas.shape and np.array_equal(got, meas)
    emit({"phase": "params_file_npy", "init_s": time.perf_counter() - t2,
          "bit_exact": bool(same), "dx": npy_init.init_variables["dx"]})
    require(same, "the .npy round trip changed the measurements")
    os.remove(npy_path)
    return launches, raw_path


# resume gates (see resume_path): the first batch of the resumed iteration,
# its first RESUME_BATCHES batches, and the whole iteration; 0: bit for bit
# (they were 1e-6, 1e-5 and 5e-3 while B3b added with atomics)
RESUME_FIRST_RTOL = 0.0
RESUME_BATCHES, RESUME_BATCHES_RTOL = 8, 0.0
RESUME_ITER_RTOL = 0.0


def resume_path(dev, card: str, init: dict, main_losses: list, tmp: str, record: RunRecord):
    """The tBL run at full width on the main phase's data, stopped and
    resumed in process: 3 iterations whose callback takes make_save_dict's
    checkpoint of iteration 2 (with the optimizer state) from the live run;
    then a second solver from that dict alone (resume_from) runs iteration
    3 through recon_loop(start_niter=3), batch by batch beside the
    uninterrupted run's iteration 3. Every kernel of the path sums in a
    fixed order (B2 in batch order, B3b over modes and samples), so the
    first batch's loss (before any step of iteration 3: the restored
    parameters), the first 8 batches' (the restored optimizer state's
    first steps) and the iteration's are held equal bit for bit (rtol 0;
    Adam turns a difference in the last bits of a gradient of rounding
    size into a step of lr, so any difference would show). A third solver
    from the checkpoint without its optimizer state must miss the last two
    gates: a resume that drops the state fails them. Where h5py
    imports, the resume again through model_iter0002.hdf5 and load_ptyrad.
    ``record`` takes the uninterrupted run's per-batch terms and final
    tensors (the determinism phase's second run of the main path). Returns
    the launch counts and the uninterrupted solver."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.load import load_ptyrad
    from ptyrad_tpu_torch.save import make_save_dict, save_dict_to_hdf5

    params = copy.deepcopy(TBL_PARAMS)
    params["recon_params"]["save_result"] = ["model", "optim_state"]
    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    taken = {}

    def callback(niter, cur_params, history, optimizer=None):
        record(niter, cur_params, history)
        if niter == 2:
            t0 = time.perf_counter()
            taken["ckpt"] = make_save_dict("", cur_params, solver.buffers, solver.geom, params,
                                           optimizer, history, niter, solver.indices,
                                           solver.lr_dict, solver.start_dict)
            taken["make_save_dict_s"] = time.perf_counter() - t0

    _, launches = counted(lambda: solver.run(callback=callback))
    record.finish(solver)
    losses = [v for _, v in solver.history.loss_iters]
    ref = batch_totals(solver.history)
    ckpt = taken["ckpt"]
    routes = {"dict": ckpt}
    write_s = None
    if optional_packages()["h5py"]:
        path = f"{tmp}/model_iter0002.hdf5"
        t0 = time.perf_counter()
        save_dict_to_hdf5(ckpt, path)
        write_s = time.perf_counter() - t0
        routes["file"] = load_ptyrad(path)
    routes["dict, fresh optimizer"] = ckpt
    resumed = {}
    for route, c in routes.items():
        other = resume_from(c, params, init, dev, verbose=True)
        if route.endswith("fresh optimizer"):
            other.optimizer.state.clear()
        history, counts = counted(lambda: resume_step(other, 3, verbose=True))
        launches = add_counts(launches, counts)
        got = batch_totals(history)
        resumed[route] = {
            "iter3": history.loss_iters[-1][1],
            "rel_diff": abs(history.loss_iters[-1][1] - losses[2]) / abs(losses[2]),
            "first_batch_rel_diff": float(abs(got[0] - ref[0]) / abs(ref[0])),
            "batches_rel_diff_max": {n: float(np.max(np.abs(got[:n] - ref[:n]) / np.abs(ref[:n])))
                                     for n in (RESUME_BATCHES, 64, 512)},
        }
        del other
    out = {
        "phase": "resume", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "routes": sorted(routes), "losses": losses, "resumed": resumed,
        "main_losses": main_losses,
        "rel_diff_to_main": [abs(a - b) / abs(b) for a, b in zip(losses, main_losses)],
        "make_save_dict_s": taken["make_save_dict_s"],
        "write_s": write_s if write_s is not None else "not measured: h5py does not import",
        "optim_state_groups": [g["name"] for g in solver.optimizer.param_groups],
        "launches": launches,
    }
    emit(out)
    require(len(losses) == NITER and all(np.isfinite(losses)), f"resume: loss not finite: {losses}")
    require(ckpt["optim_state_dict"] is not None and ckpt["niter"] == 2,
            "resume: the checkpoint of iteration 2 holds no optimizer state")
    for route, r in resumed.items():
        require(r["first_batch_rel_diff"] <= RESUME_FIRST_RTOL,
                f"resume ({route}): the first batch of iteration 3 differs by "
                f"{r['first_batch_rel_diff']} > {RESUME_FIRST_RTOL}")
        gates = ((r["batches_rel_diff_max"][RESUME_BATCHES], RESUME_BATCHES_RTOL,
                  f"the first {RESUME_BATCHES} batches"), (r["rel_diff"], RESUME_ITER_RTOL,
                                                            "iteration 3"))
        for diff, tol, what in gates:
            if route.endswith("fresh optimizer"):
                require(diff > tol, f"resume without the optimizer state: {what} within "
                                    f"{tol} ({diff}); the gate cannot tell")
            else:
                require(diff <= tol, f"resume ({route}): {what} differ from the "
                                     f"uninterrupted run's by {diff} > {tol}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the resume path")
    return launches, solver


CLI_NITER, CLI_SAVE_ITERS = 4, 2
_ITER_LINE = re.compile(r"Iter: (\d+), Total Loss: (\S+?),.* in ([0-9.]+) sec")
_SAVE_LINE = re.compile(r"Saved the results of iteration (\d+) to .* in ([0-9.]+) sec")


def _run_cli(args: list, timeout_s: float) -> tuple[int, list, float]:
    """``python -m ptyrad_tpu_torch <args>`` from the repository root, its
    output read line by line as it comes: (exit code, [(seconds since the
    start, line)], seconds)."""
    proc = subprocess.Popen([sys.executable, "-m", "ptyrad_tpu_torch", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    timer = threading.Timer(timeout_s, proc.kill)
    t0 = time.perf_counter()
    timer.start()
    try:
        lines = [(time.perf_counter() - t0, line.rstrip("\n")) for line in proc.stdout]
        rc = proc.wait()
    finally:
        timer.cancel()
        proc.stdout.close()
    return rc, lines, time.perf_counter() - t0


def _tail(lines: list, n: int = 30) -> str:
    return "\n".join(line for _, line in lines[-n:])


def cli_path(card: str, tmp: str, raw_path: str, named_like) -> None:
    """The tBL run as a user starts it: ``python -m ptyrad_tpu_torch run
    --params_path`` in a subprocess, on the params_file phase's .raw, with
    its .json set to 4 iterations saved every 2 into a temporary output_dir
    (objp, obja and probe; model and optim_state where h5py imports). The
    kernels built for this process serve the subprocess unbuilt. Then
    validate-params (on the .json and on a copy with a bad key), check-gpu
    and print-system-info, all three at once. ``named_like``: a solver of
    the same shapes, to name the output folder as make_output_folder does."""
    from PIL import Image

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.save import make_output_folder

    h5py = optional_packages()["h5py"]
    d = tbl_params_file(raw_path)
    out_dir = f"{tmp}/cli_out"
    d["recon_params"].update(
        NITER=CLI_NITER, SAVE_ITERS=CLI_SAVE_ITERS, output_dir=out_dir,
        save_result=["objp", "obja", "probe"] + (["model", "optim_state"] if h5py else []))
    json_path = f"{tmp}/tbl_cli.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)

    def folder_name():
        return os.path.basename(make_output_folder(
            out_dir, np.arange(N_SCANS), d, named_like.params, named_like.geom, make_dir=False))

    build_files = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}
    names = {folder_name()}
    rc, lines, seconds = _run_cli(["run", "--params_path", json_path], 600)
    names.add(folder_name())
    text = [line for _, line in lines]
    require(rc == 0, f"cli run exited {rc}:\n{_tail(lines)}")
    iters = [(t, _ITER_LINE.search(line)) for t, line in lines if _ITER_LINE.search(line)]
    saves = [_SAVE_LINE.search(line) for line in text if _SAVE_LINE.search(line)]
    start_s = next(t for t, line in lines if "Starting reconstruction" in line)
    losses = [float(m.group(2)) for _, m in iters]
    iter_s = [float(m.group(3)) for _, m in iters]
    folders = os.listdir(out_dir)
    folder = os.path.join(out_dir, folders[0]) if len(folders) == 1 else None
    files = sorted(os.listdir(folder)) if folder else []
    shapes = {}
    for name in files:
        if name.endswith(".tif"):
            with Image.open(os.path.join(folder, name)) as im:
                shapes[name] = [getattr(im, "n_frames", 1), im.size[1], im.size[0]]
    out = {
        "phase": "cli", "card": card, "rc": rc, "seconds": seconds,
        "seconds_to_training": start_s, "seconds_to_first_iteration_end": iters[0][0],
        "iterations": len(losses), "losses": losses, "iter_s": iter_s,
        "patterns_per_s": [N_SCANS / t for t in iter_s],
        "saves": [[int(m.group(1)), float(m.group(2))] for m in saves],
        "folder": folders, "files": files, "tif_shapes": shapes,
        "rebuilt": build_files != {p.name: p.stat().st_mtime_ns
                                   for p in _build.BUILD_DIR.iterdir()},
    }
    emit(out)
    require(len(folders) == 1 and folders[0] in names,
            f"cli output folders {folders}, expected one of {sorted(names)}")
    date = folders[0].split("_")[0]
    require({"tbl_cli.json", f"{date}_ptyrad_tpu_torch_log.txt"} <= set(files),
            f"cli: no params copy or log in {files}")
    require(not out["rebuilt"], "cli: the subprocess rebuilt or replaced the kernel library")
    require(len(losses) == CLI_NITER and all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"cli: losses {losses}")
    require([int(m.group(1)) for m in saves] == [2, 4],
            f"cli: saves at iterations {[m.group(1) for m in saves]}, expected 2 and 4 once each")
    for it in (2, 4):
        zsum, zstack = f"objp_zsum_crop_08bit_iter{it:04d}.tif", f"objp_zstack_crop_08bit_iter{it:04d}.tif"
        probe = f"probe_amp_08bit_iter{it:04d}.tif"
        require(shapes.get(probe) == [1, NPIX, PMODE * NPIX], f"cli: {probe} {shapes.get(probe)}")
        require(zsum in shapes and zstack in shapes and shapes[zstack][0] == NZ
                and shapes[zstack][1:] == shapes[zsum][1:]
                and all(0.9 * (N_SIDE - 1) * STEP_PX <= v <= 1.1 * (N_SIDE - 1) * STEP_PX + 2
                        for v in shapes[zsum][1:]),
                f"cli: object images {shapes.get(zsum)} {shapes.get(zstack)}")
        if h5py:
            require(f"model_iter{it:04d}.hdf5" in files, f"cli: no checkpoint of iteration {it}")
    log = open(os.path.join(folder, f"{date}_ptyrad_tpu_torch_log.txt")).read()
    require(f"Iter: {CLI_NITER}, Total Loss" in log and "### System information ###" in log,
            "cli: the log file misses the run")

    bad_path = f"{tmp}/tbl_bad.json"
    with open(bad_path, "w", encoding="utf-8") as f:
        json.dump({**d, "init_params": {**d["init_params"], "bogus_key": 1}}, f)
    commands = {"validate-params": ["validate-params", "--params_path", json_path],
                "validate-params (bad key)": ["validate-params", "--params_path", bad_path],
                "check-gpu": ["check-gpu"], "print-system-info": ["print-system-info"]}
    with concurrent.futures.ThreadPoolExecutor(len(commands)) as pool:
        futures = {k: pool.submit(_run_cli, args, 180) for k, args in commands.items()}
        results = {k: f.result() for k, f in futures.items()}
    emit({"phase": "cli_commands",
          **{k: {"rc": rc, "seconds": sec, "tail": [line for _, line in lines[-3:]]}
             for k, (rc, lines, sec) in results.items()}})
    expected = {"validate-params": 0, "validate-params (bad key)": 1, "check-gpu": 0,
                "print-system-info": 0}
    for k, want in expected.items():
        require(results[k][0] == want, f"cli {k} exited {results[k][0]}, expected {want}:\n"
                                       f"{_tail(results[k][1])}")
    gpu_name = torch.cuda.get_device_name(0)
    for k in ("check-gpu", "print-system-info"):
        require(any(gpu_name in line for _, line in results[k][1]),
                f"cli {k} does not name the card {gpu_name}")


# -- the figures and hypertune phases (A9) ---------------------------------------

FIG_NITER = 2
FIGS = ["loss", "forward", "probe_r_amp", "pos", "group"]
HT_TRIALS, HT_NITER = 4, 3
HT_CLI_NITER = 2
HT_MEM_RTOL = 0.10  # the last trial's peak device memory against the first's


def figures_path(dev, card: str, tmp: str, raw_path: str) -> dict:
    """The tBL run from its params file through run_reconstruction, 2
    iterations saved every iteration with selected_figs [loss, forward,
    probe_r_amp, pos, group]: each plot_summary's seconds (the "forward"
    figure's forward() is B4a on a batch of 2). Gate 1: forward_panels on
    the first 2 indices is finite and equal to the plain multislice_dp on
    the same patches within 1e-4 of its largest value. Gate 2, where
    matplotlib imports: every expected PNG exists. Returns the run's launch
    counts."""
    import ptyrad_tpu_torch.engine.workflow as W
    from ptyrad_tpu_torch import load as L
    from ptyrad_tpu_torch.models import (compute_propagators, forward_route, get_obj_patches,
                                         get_probes, multislice_dp)
    from ptyrad_tpu_torch.visualization import forward_panels

    t0 = time.perf_counter()
    drawing = optional_packages()["matplotlib"]
    d = tbl_params_file(raw_path)
    d["recon_params"].update(NITER=FIG_NITER, SAVE_ITERS=1, selected_figs=FIGS,
                             output_dir=f"{tmp}/fig_out", save_result=["objp"])
    json_path = f"{tmp}/tbl_figs.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    params = L.load_params(json_path, validate=optional_packages()["pydantic"])
    seconds = []
    plot = W.plot_summary

    def timed(*args, **kwargs):
        t1 = time.perf_counter()
        try:
            return plot(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t1)

    W.plot_summary = timed
    try:
        solver, launches = counted(lambda: W.run_reconstruction(
            params, device=dev, init_rng=np.random.RandomState(SEED)))
    finally:
        W.plot_summary = plot
    files = sorted(os.listdir(solver.output_path))
    idx = torch.as_tensor(np.asarray(solver.indices)[:2], device=dev)
    route = forward_route(solver.params, solver.geom, idx)
    panels = forward_panels(solver.params, solver.buffers, solver.geom, idx.cpu().numpy())
    with torch.no_grad():
        obja_p, objp_p = get_obj_patches(solver.params, solver.buffers, solver.geom, idx)
        ref = multislice_dp(obja_p, objp_p, get_probes(solver.params, solver.geom, idx),
                            compute_propagators(solver.params, solver.buffers, solver.geom, idx),
                            solver.buffers.omode_occu, solver.geom.eps).cpu().numpy()
    dp = panels["model_dp"]
    err = float(np.abs(dp - ref).max())
    tol = 1e-4 * float(np.abs(ref).max())
    want = {"summary_grouping.png"} | {f"summary_{f}_iter{i:04d}.png"
                                       for f in FIGS[:-1] for i in range(1, FIG_NITER + 1)}
    losses = [v for _, v in solver.history.loss_iters]
    emit({"phase": "figures", "card": card, "seconds": time.perf_counter() - t0,
          "matplotlib": drawing, "route": route, "plot_summary_s": seconds, "losses": losses, "pngs": [f for f in files
                                                                  if f.endswith(".png")],
          "panel_shapes": {k: list(v.shape) for k, v in panels.items()},
          "max_abs_err": err, "tolerance": tol, "launches": launches})
    require(route == "fused", f"figures: forward() of 2 patterns took the {route} route")
    require(all(np.isfinite(v).all() for v in panels.values()), "figures: non-finite panels")
    require(dp.shape == (2, NPIX, NPIX), f"figures: model_dp {dp.shape}")
    require(err <= tol, f"figures: forward_panels differs from the plain chain: {err} > {tol}")
    require(len(seconds) == FIG_NITER, f"figures: plot_summary ran {len(seconds)} times")
    require(launches["B4a dp_fwd"] == FIG_NITER,
            f"figures: {launches['B4a dp_fwd']} B4a launches, expected one per save")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"figures: kernel {name} was not launched")
    if drawing:
        require(want <= set(files), f"figures: missing {sorted(want - set(files))}")
    else:
        print("figures: drawing skipped, matplotlib missing", flush=True)
    del solver
    torch.cuda.empty_cache()
    return launches


def hypertune_params_file(raw_path: str, tmp: str, n_trials: int, niter: int) -> dict:
    """demo/params/tBL_WSe2_hypertune.yml on the params_file phase's .raw:
    tbl_params_file with one slice of 12 Ang, the demo's constraints (no
    obj_rblur), quiet trials collating objp and the loss and forward
    figures into one folder, and its study: scale and rotation,
    TPESampler(seed 0, 2 startup trials, the demo's multivariate, group and
    constant_liar), HyperbandPruner(min_resource 1, reduction_factor 2, 2
    startup trials), a sqlite file in ``tmp``."""
    d = tbl_params_file(raw_path)
    d["init_params"].update(obj_Nlayer=1, obj_slice_thickness=12.0)
    d["constraint_params"]["obj_rblur"]["freq"] = None
    d["recon_params"].update(
        NITER=niter, SAVE_ITERS=None, output_dir=f"{tmp}/ht_out", recon_dir_affixes=[],
        save_result=["objp"], selected_figs=["loss", "forward"], if_quiet=True,
        result_modes={"obj_dim": [2, 3], "FOV": ["crop"], "bit": ["8"]})
    d["hypertune_params"].update(
        if_hypertune=True, collate_results=True, n_trials=n_trials,
        sampler_params={"name": "TPESampler",
                        "configs": {"seed": 0, "n_startup_trials": 2, "multivariate": True,
                                    "group": True, "constant_liar": True}},
        pruner_params={"name": "HyperbandPruner",
                       "configs": {"min_resource": 1, "reduction_factor": 2,
                                   "n_startup_trials": 2}},
        storage_path=f"sqlite:///{tmp}/hypertune.sqlite3", study_name="tBL_WSe2")
    return d


class TrialRecorder:
    """Wraps hypertune_objective for the duration of a ``with``: each
    trial's seconds, peak device memory (the peak reset at its start), the
    memory allocated before it, its params, crop_pos after its re-init, and
    the exception of a trial that raised anything but TrialPruned."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        import ptyrad_tpu_torch.engine.hypertune as H

        self._module, self._fn = H, H.hypertune_objective

        def recorded(trial, params, init, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row = {"number": trial.number, "before_gb": torch.cuda.memory_allocated() / 1e9}
            t0 = time.perf_counter()
            try:
                return self._fn(trial, params, init, **kwargs)
            except Exception as e:
                if "Pruned" not in type(e).__name__:
                    row["exception"] = f"{type(e).__name__}: {e}"
                raise
            finally:
                torch.cuda.synchronize()
                row.update(seconds=time.perf_counter() - t0,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                           params=dict(trial.params),
                           crop_pos=np.array(init.init_variables["crop_pos"]))
                self.rows.append(row)

        H.hypertune_objective = recorded
        return self

    def __exit__(self, *exc):
        self._module.hypertune_objective = self._fn
        return False


def hypertune_path(dev, card: str, tmp: str, raw_path: str) -> dict:
    """run_hypertune in process on the .raw at full width (16,384 patterns
    of 128², 6 probe modes, batch 32, one slice): 4 trials of 3 iterations
    (hypertune_params_file), trials 3 and 4 past the TPE startup and
    consulted by the pruner. Gates: no trial FAILED (each failed trial's
    exception printed), every trial COMPLETE or PRUNED; each trial's
    crop_pos differs from the previous one's (the staged re-init); every
    completed value finite; the sqlite file holds the 4 trials with a report
    per iteration run; the collated objp files carry the
    _error_<value>_tNNNN names; B3a/B3b launched at one slice; the last
    trial's peak memory within 10% of the first's. Returns the launch counts."""
    from ptyrad_tpu_torch import load as L
    from ptyrad_tpu_torch.engine import tuner
    from ptyrad_tpu_torch.engine.hypertune import run_hypertune

    d = hypertune_params_file(raw_path, tmp, HT_TRIALS, HT_NITER)
    json_path = f"{tmp}/tbl_hypertune.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    params = L.load_params(json_path, validate=optional_packages()["pydantic"])
    t0 = time.perf_counter()
    with TrialRecorder() as rec:
        study, launches = counted(lambda: run_hypertune(
            params, device=dev, init_rng=np.random.RandomState(SEED), use_optuna=False))
    seconds = time.perf_counter() - t0
    trials = tuner.create_study("tBL_WSe2", d["hypertune_params"]["storage_path"]).trials
    out_dir = d["recon_params"]["output_dir"]
    files = sorted(os.listdir(out_dir))
    best = study.best_trial
    emit({"phase": "hypertune", "card": card, "seconds": seconds,
          "trials": [{"number": t["number"], "state": t["state"], "value": t["value"],
                      "params": t["params"], "reports": t["reports"]} for t in trials],
          "trial_s": [r["seconds"] for r in rec.rows],
          "trial_peak_gb": [r["peak_gb"] for r in rec.rows],
          "allocated_before_trial_gb": [r["before_gb"] for r in rec.rows],
          "best": None if best is None else {k: best[k] for k in ("number", "value", "params")},
          "files": files, "launches": launches})
    for r in rec.rows:
        if "exception" in r:
            print(f"hypertune: trial {r['number']} raised {r['exception']}", flush=True)
    states = [t["state"] for t in trials]
    require(len(trials) == HT_TRIALS and len(rec.rows) == HT_TRIALS,
            f"hypertune: {len(trials)} trials in the study, {len(rec.rows)} run")
    require(set(states) <= {"COMPLETE", "PRUNED"} and "COMPLETE" in states,
            f"hypertune: trial states {states}")
    # init_pos runs again in every trial (scale and rotation are tuned) and
    # draws a new jitter (pos_scan_rand_std), so even a repeated affine moves
    for prev, cur in zip(rec.rows, rec.rows[1:]):
        require(not np.array_equal(prev["crop_pos"], cur["crop_pos"]),
                f"hypertune: trial {cur['number']} kept the positions of trial "
                f"{prev['number']}: the staged re-init did not run")
    for t in trials:
        niter = HT_NITER if t["state"] == "COMPLETE" else len(t["reports"])
        require(t["value"] is not None and np.isfinite(t["value"]),
                f"hypertune: trial {t['number']} value {t['value']}")
        require(sorted(t["reports"], key=int) == [str(i) for i in range(1, niter + 1)],
                f"hypertune: trial {t['number']} reports {t['reports']}")
        stamp = f"_error_{t['value']:.5f}_t{t['number']:04d}_scale_"
        require(any(f.startswith("objp_") and stamp in f for f in files),
                f"hypertune: no objp file named with {stamp} in {files}")
    for name in ("B3a loss_sums_fwd (nz=1)", "B3b loss_sums_bwd (nz=1)", "B4a dp_fwd"):
        require(launches[name] > 0, f"hypertune: kernel {name} was not launched")
    peaks = [r["peak_gb"] for r in rec.rows]
    require(abs(peaks[-1] - peaks[0]) <= HT_MEM_RTOL * peaks[0],
            f"hypertune: peak memory of the trials {peaks}")
    torch.cuda.empty_cache()
    return launches


def hypertune_cli_path(card: str, tmp: str, raw_path: str) -> None:
    """A second worker on the same study: ``python -m ptyrad_tpu_torch run
    --params_path <json> --jobid 1`` with 1 trial of 2 iterations on the
    hypertune phase's sqlite file, as demo/scripts/LoopSubmit.sh starts
    workers. Gates: exit 0, the study holds 5 trials, the worker's log file
    carries its job id, the kernel library neither rebuilt nor replaced."""
    from ptyrad_tpu_torch.engine import tuner
    from ptyrad_tpu_torch.ops import _build

    d = hypertune_params_file(raw_path, tmp, 1, HT_CLI_NITER)
    json_path = f"{tmp}/tbl_hypertune_cli.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    build_files = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}
    rc, lines, seconds = _run_cli(["run", "--params_path", json_path, "--jobid", "1"], 600)
    trials = tuner.create_study("tBL_WSe2", d["hypertune_params"]["storage_path"]).trials
    out_dir = d["recon_params"]["output_dir"]
    logs = [f for f in os.listdir(out_dir) if f.endswith("_1_ptyrad_tpu_torch_log.txt")]
    out = {"phase": "hypertune_cli", "card": card, "rc": rc, "seconds": seconds,
           "trials": [[t["number"], t["state"], t["value"]] for t in trials], "logs": logs,
           "rebuilt": build_files != {p.name: p.stat().st_mtime_ns
                                      for p in _build.BUILD_DIR.iterdir()},
           "tail": [line for _, line in lines[-4:]]}
    emit(out)
    require(rc == 0, f"hypertune_cli exited {rc}:\n{_tail(lines)}")
    require([t["number"] for t in trials] == list(range(HT_TRIALS + 1)),
            f"hypertune_cli: the study holds trials {[t['number'] for t in trials]}")
    require(trials[-1]["state"] in ("COMPLETE", "PRUNED"),
            f"hypertune_cli: the worker's trial is {trials[-1]['state']}")
    require(len(logs) == 1, f"hypertune_cli: worker logs {logs}")
    require(not out["rebuilt"], "hypertune_cli: the kernel library was rebuilt or replaced")


# -- the forward() figure and the low-dose path ---------------------------------

def float64_cpu(params, buffers):
    """CPU copies of a model in float64 / complex128, the parameters as
    fresh leaves that want gradients: the reference for the gradients that
    float32 rounding dominates."""
    from ptyrad_tpu_torch.models.state import PtychoParams

    def up(t):
        if t is None:
            return None
        t = t.detach().cpu()
        if t.is_complex():
            return t.to(torch.complex128)
        return t.double() if t.is_floating_point() else t

    p64 = PtychoParams(**{n: up(t).requires_grad_(True) for n, t in params.named()})
    b64 = dataclasses.replace(buffers, **{f.name: up(getattr(buffers, f.name))
                                          for f in dataclasses.fields(buffers)})
    return p64, b64


def scalar_grads_check(label: str, names, kern, plain, ref64) -> None:
    """The dz and tilt gradients, which autograd contracts out of dH. The
    global phase exp(i dz k) of every propagator (k = 2 pi / lambda, about
    150 / Ang at 80 kV) contributes a term that is zero in exact arithmetic
    but of order float32 epsilon x k x sum |dH| in any float32 route, so the
    kernels' gradients are held against the float64 plain route: each entry
    within 5e-2 of its own size (the rtol of the JAX package's own test,
    tests/test_forward.py:1192-1198) plus 1e-3 of the largest entry, for
    entries near zero. The float32 plain route's error is reported beside."""
    errs_k, errs_p, worst = [], [], []
    for name, k, p, r in zip(names, kern, plain, ref64):
        r = r.detach().cpu().double()
        dk = (k.detach().cpu().double() - r).abs()
        scale = float(r.abs().max())
        tol = 5e-2 * r.abs() + 1e-3 * scale
        errs_k.append(float(dk.max()))
        errs_p.append(float((p.detach().cpu().double() - r).abs().max()))
        worst.append(float((dk / tol).max()) if scale > 0 else float("inf"))
        require(scale > 0, f"{label}: the float64 {name} gradient is zero")
        require(worst[-1] <= 1.0, f"{label}: the kernels' {name} gradient is off the float64 "
                f"one by {worst[-1]} of the limit (max abs err {errs_k[-1]}, largest entry "
                f"{scale}; the float32 plain route's error: {errs_p[-1]})")
    emit({"phase": "scalar_gradients", "path": label, "names": list(names),
          "kernel_err_vs_float64": errs_k, "plain_float32_err_vs_float64": errs_p,
          "kernel_err_over_limit": worst, "limit": "5e-2 |ref| + 1e-3 max |ref| per entry",
          "float64": [r.detach().cpu().reshape(-1)[:4].tolist() for r in ref64]})


def forward_vs_plain(dev, data: dict, mp: dict, label: dict, scalar_names=()) -> dict:
    """One forward() of a batch spread over the scan (B4a, and B4b under
    autograd) against the plain multislice_dp plus the same detector blur on
    the same CUDA tensors: dp within 1e-4 of its largest value, each
    gradient within 1e-4 of its largest entry, dH (the cotangent of the
    batch's H, kept in both routes) included; the scalars autograd
    contracts out of dH (dz, tilts) go to scalar_grads_check against a
    float64 plain route on the CPU. Returns the kernel route's launch
    counts (forward and backward, under counted())."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, forward_route,
                                         get_obj_patches, get_probes, make_model, multislice_dp)
    F = importlib.import_module("ptyrad_tpu_torch.models.forward")
    from ptyrad_tpu_torch.ops.blur import gaussian_blur_2d

    idx = torch.arange(0, N_SCANS, N_SCANS // BATCH, device=dev)
    w = torch.rand((BATCH, NPIX, NPIX), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev)

    held = []

    def keep_h(*args):
        """compute_propagators, its H kept for dH when it wants a gradient"""
        h = compute_propagators(*args)
        if h.requires_grad:
            h.retain_grad()
            held.append(h)
        return h

    def run(route):
        params, buffers, geom = make_model(data, mp, dev)
        for _, t in params.named():
            t.requires_grad_(True)
        at, wr = idx, w
        held.clear()
        if route == "float64":
            params, buffers = float64_cpu(params, buffers)
            at, wr = idx.cpu(), w.cpu().double()
        if route == "kernels":
            require(forward_route(params, geom, idx) == "fused", "forward() left the B4 route")
            F.compute_propagators = keep_h  # forward() looks it up at call time
            try:
                dp, _ = forward(params, buffers, geom, idx)
            finally:
                F.compute_propagators = compute_propagators
        else:
            obja_p, objp_p = get_obj_patches(params, buffers, geom, at)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, at),
                               keep_h(params, buffers, geom, at), buffers.omode_occu, eps=geom.eps)
            if geom.detector_blur_std:
                dp = gaussian_blur_2d(dp, kernel_size=5, sigma=geom.detector_blur_std)
        (wr * dp).sum().backward()
        grads = {n: t.grad for n, t in params.named() if t.grad is not None}
        if held:
            grads["H"] = held[0].grad
        return dp.detach(), grads

    (dp_k, g_k), launches = counted(lambda: run("kernels"))
    dp_p, g_p = run("plain")
    if scalar_names:
        g_64 = run("float64")[1]
        scalar_grads_check(f"forward() {label}", scalar_names,
                           [g_k[n] for n in scalar_names], [g_p[n] for n in scalar_names],
                           [g_64[n] for n in scalar_names])
    err = float((dp_k - dp_p).abs().max())
    tol = 1e-4 * float(dp_p.abs().max())
    # every gradient at 1e-4 of its largest entry, dH (B4b's own output) too
    names = sorted(set(g_p) - set(scalar_names))
    errs = [float((g_k[n] - g_p[n]).abs().max()) for n in names]
    tols = [1e-4 * float(g_p[n].abs().max()) for n in names]
    emit({"phase": "forward_modes", **label, "batch": BATCH,
          "finite": bool(torch.isfinite(dp_k).all()), "max_abs_err": err, "tolerance": tol,
          "grad_names": names, "grad_max_abs_err": errs, "grad_tolerance": tols,
          "launches": launches})
    expected = {"obja", "objp", "probe", "probe_pos_shifts", *scalar_names,
                *(("H",) if scalar_names else ())}
    require(set(g_k) == set(g_p) == expected, f"gradients reached {sorted(g_k)} and {sorted(g_p)}")
    require(bool(torch.isfinite(dp_k).all()) and err <= tol,
            f"forward() ({label}) differs from the plain version: {err} > {tol}")
    for name, e, t in zip(names, errs, tols):
        require(e <= t, f"forward() ({label}) gradient of {name} differs: {e} > {t}")
    n_dh = launches["B4b dp_bwd (dH)"]
    require(n_dh == (1 if scalar_names else 0), f"B4b computed dH {n_dh} times")
    return launches


def forward_modes_check(dev, init: dict) -> dict:
    """forward() against the plain chain in two cases: 2 object modes (a
    random weak object), per-position shifted probes and detector blur (B4a
    per object mode, B4b per mode under autograd); then optimizable slice
    thickness and per-position tilts within 1 mrad (B4a on a per-position H,
    B4b with dH), every gradient checked, dz's and the tilts' included.
    Returns the kernel routes' launch counts."""
    rng = np.random.default_rng(SEED + 2)
    shape = (2, *init["obj"].shape[1:])
    obj = (1.0 + 0.02 * rng.standard_normal(shape)) * np.exp(0.1j * rng.standard_normal(shape))
    shifts = (0.3 * rng.standard_normal((N_SCANS, 2))).astype(np.float32)
    two = dict(init, obj=obj.astype(np.complex64), omode_occu=np.array([0.7, 0.3], np.float32),
               probe_pos_shifts=shifts)
    modes = forward_vs_plain(dev, two, {"update_params": {"probe_pos_shifts": {"lr": 1e-4}},
                                        "detector_blur_std": 0.5},
                             {"omode": 2, "detector_blur_std": 0.5})
    one = (1.0 + 0.02 * rng.standard_normal(init["obj"].shape)) * np.exp(
        0.1j * rng.standard_normal(init["obj"].shape))
    tilted = dict(init, obj=one.astype(np.complex64), probe_pos_shifts=shifts,
                  obj_tilts=rng.uniform(-1.0, 1.0, (N_SCANS, 2)).astype(np.float32))
    tilts = forward_vs_plain(dev, tilted, {"update_params": {
        "probe_pos_shifts": {"lr": 1e-4}, "obj_tilts": {"lr": 1e-4},
        "slice_thickness": {"lr": 1e-4}}},
        {"omode": 1, "tilts": "per position", "slice_thickness": "optimizable"},
        scalar_names=("obj_tilts", "slice_thickness"))
    return add_counts(modes, tilts)


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
    record = RunRecord()
    t1 = time.perf_counter()
    launches = counted(lambda: solver.run(callback=record))[1]
    run_s = time.perf_counter() - t1
    record.finish(solver)
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
    # determinism through B4b: the same 3 iterations again
    again = PtyRADSolver(LOW_DOSE_PARAMS, init_variables=data, device=dev, verbose=False)
    second = RunRecord()
    launches = add_counts(launches, counted(lambda: again.run(callback=second))[1])
    second.finish(again)
    determinism_check("low-dose (B4b)", card, record, second, again)
    del again
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


def pso_dataset(dev, tilt=(0.0, 0.0)) -> dict:
    """init_variables for PSO: 256^2 patterns simulated through the port's
    plain multislice_dp (set-up, not the path being driven) with a global
    crystal tilt (mrad), cropped to [68, 188)^2, normalised to max at one,
    and padded on the fly; the probe scaled to the mean measured intensity
    with its pad, as the Initializer's _probe_normalize does; a flat initial
    object and zero tilt."""
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
        "obj_tilts": np.array([tilt], np.float32),
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
                obj_tilts=np.zeros((1, 2), np.float32), on_the_fly_meas_padded=padded,
                on_the_fly_meas_padded_idx=pad_idx)
    return init


def pso_path(dev, card: str):
    t0 = time.perf_counter()
    init = pso_dataset(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    solver, launches, first = run_pso_solver(dev, card, "pso", init, setup_s)
    for name in PSO_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the PSO path")
    for name in ("B5a chain_segment_fwd (far-field)", "B5b chain_segment_bwd (far-field)"):
        require(launches[name] == 0, f"{name} ran with the exit switched off")
    pso_forward_figure(solver)
    ref = {"losses": [v for _, v in solver.history.loss_iters], "first_batch_loss": first}
    return solver, launches, init, ref


def first_batch_loss(solver) -> float:
    """The loss of the solver's first batch before any step (no gradient:
    the chain runs B5 segment by segment)."""
    from ptyrad_tpu_torch.engine.solver import loss_fn

    solver.prepare()
    idx, mask = (torch.as_tensor(x[0], device=solver.device)
                 for x in (solver.batch_idx, solver.batch_mask))
    with torch.no_grad():
        total, _ = loss_fn(solver.params, solver.buffers, solver.geom, idx, mask,
                           solver.loss_params)
    return float(total)


def run_pso_solver(dev, card: str, phase: str, init: dict, setup_s: float):
    """PtyRADSolver.run() on the PSO data with the counts set to 0 just before
    it; asserts a finite, falling loss and that neither B3 nor B4 ran.
    Returns (solver, launches, the first batch's loss before training)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    solver = PtyRADSolver(PSO_PARAMS, init_variables=init, device=dev, verbose=True)
    first = first_batch_loss(solver)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    emit({
        "phase": phase, "card": card, "n_patterns": PSO_SCANS, "batch": BATCH,
        "first_batch_loss": first, "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [PSO_SCANS / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    require(len(losses) == PSO_NITER and all(np.isfinite(losses)),
            f"{phase}: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd", "B4a dp_fwd", "B4b dp_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the {phase} path (N = 256)")
    return solver, launches, first


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


# -- the far-field exit: the PSO path again, and the carve ----------------------

def far_field_on(fn):
    """fn() with the chain's far-field exit switched on, and off again after."""
    from ptyrad_tpu_torch.ops import chain as C

    C.set_far_field(True)
    try:
        return fn()
    finally:
        C.set_far_field(False)


def pso_ff_path(dev, card: str, init: dict, pso: dict):
    """The pso phase's run on the same data after set_far_field(True): the
    5-slice B5 tail ends in the detector transform, forward and backward.
    The exit changes where the transform runs, not the result: the first
    batch's loss before training must equal the pso phase's at rtol 1e-5.
    From the flat start the dark field of every pattern is rounding residue,
    where loss_single's dp^0.5 is steepest, and Adam amplifies any float32
    rounding difference: one unit in the last place of the initial object
    moves the two losses by 1.7e-4 and 4.1e-3 (H100 80GB HBM3, 700 W). So
    the trajectory is held here only within PSO_FF_FLAT_RTOL, and
    pso_ff_random_start holds the path at rtol 1e-4. Every B5 launch of the
    run must have taken the exit."""
    def run():
        solver, launches, first = run_pso_solver(dev, card, "pso_ff", init, 0.0)
        pso_forward_figure(solver)
        return solver, launches, first

    solver, launches, first = far_field_on(run)
    losses = [v for _, v in solver.history.loss_iters]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, pso["losses"])]
    first_rel = abs(first - pso["first_batch_loss"]) / abs(pso["first_batch_loss"])
    emit({"phase": "pso_ff_vs_pso", "losses": losses, "pso_losses": pso["losses"],
          "rel_diff": rel, "limit": PSO_FF_FLAT_RTOL,
          "first_batch_loss": [first, pso["first_batch_loss"]], "first_batch_rel_diff": first_rel,
          "first_batch_rtol": 1e-5})
    require(first_rel <= 1e-5, f"pso_ff's first loss {first} differs from pso's "
            f"{pso['first_batch_loss']}")
    require(max(rel) <= PSO_FF_FLAT_RTOL, f"pso_ff losses {losses} differ from pso's "
            f"{pso['losses']}: {rel} > {PSO_FF_FLAT_RTOL}")
    for name in PSO_FF_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the pso_ff path")
    for way in ("B5a chain_segment_fwd", "B5b chain_segment_bwd"):
        require(launches[f"{way} (far-field)"] == launches[way],
                f"{way}: {launches[way]} launches on the tail, "
                f"{launches[way + ' (far-field)']} with the exit")
    return solver, launches


def random_object(shape, seed: int) -> np.ndarray:
    """A seeded object that is not flat: amplitude 1 + 0.02 n, phase 0.1 n."""
    rng = np.random.default_rng(seed)
    obj = (1.0 + 0.02 * rng.standard_normal(shape)) * np.exp(0.1j * rng.standard_normal(shape))
    return obj.astype(np.complex64)


def pso_ff_random_start(dev, init: dict) -> dict:
    """The tight gates of the chain kernels at full width: PtyRADSolver.run()
    on the PSO data from a seeded random object, through the kernels with
    the exit off, with it on, and with fwd_fused: false (the plain torch.fft
    chain through cuFFT, no chain kernel). Away from the flat start the run
    does not amplify rounding, so each iteration's loss must agree at rtol
    1e-4 between the kernels and cuFFT (a wrong pass would not pass) and
    between the exit on and off (nor a wrong adjoint of the exit); with the
    exit on every B5 launch must have taken it. Returns the three runs'
    launch counts, summed."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    data = dict(init, obj=random_object(init["obj"].shape, SEED + 5))
    plain_params = copy.deepcopy(PSO_PARAMS)
    plain_params["model_params"]["fwd_fused"] = False

    def run(params=PSO_PARAMS):
        solver = PtyRADSolver(params, init_variables=data, device=dev, verbose=False)
        launches = drive(solver)
        return [v for _, v in solver.history.loss_iters], launches

    off, launches_off = run()
    on, launches_on = far_field_on(run)
    plain, launches_plain = run(plain_params)
    rel = [abs(a - b) / abs(b) for a, b in zip(on, off)]
    rel_plain = [abs(a - b) / abs(b) for a, b in zip(off, plain)]
    emit({"phase": "pso_ff_random_start", "losses_exit_off": off, "losses_exit_on": on,
          "losses_cufft_route": plain, "rel_diff": rel, "rel_diff_kernels_vs_cufft": rel_plain,
          "rtol": 1e-4, "launches_exit_on": launches_on, "launches_cufft_route": launches_plain})
    require(len(on) == len(off) == len(plain) == PSO_NITER and all(np.isfinite(on + off + plain)),
            f"pso_ff_random_start: losses {off}, {on}, {plain}")
    require(max(rel_plain) <= 1e-4, f"from a random start the kernels' losses {off} differ from "
            f"the cuFFT route's {plain}: {rel_plain} > 1e-4")
    require(max(rel) <= 1e-4, f"from a random start the exit's losses {on} differ from "
            f"{off}: {rel} > 1e-4")
    for way in ("B5a chain_segment_fwd", "B5b chain_segment_bwd"):
        require(launches_off[f"{way} (far-field)"] == 0, f"{way} took the exit while it was off")
        require(0 < launches_on[way] == launches_on[f"{way} (far-field)"],
                f"{way}: {launches_on[way]} launches on the tail, "
                f"{launches_on[way + ' (far-field)']} with the exit")
    for name in CHAIN_KERNELS:
        require(launches_off[name] > 0 and launches_plain[name] == 0,
                f"{name}: {launches_off[name]} launches through the kernels, "
                f"{launches_plain[name]} with fwd_fused off")
    require(launches_plain[PLAIN_ROUTE] > 0 == launches_off[PLAIN_ROUTE],
            "fwd_fused: false did not take the plain route, or the kernel run did")
    return add_counts(launches_off, launches_on, launches_plain)


def carve_check(dev, init: dict) -> dict:
    """One forward() with gradients at nz = 16, a multiple of sg = 8, with
    the exit on and an optimizable slice thickness: the dispatcher carves a
    full tail segment off B6, which runs S = 1 segment, and B5 takes the
    exit with dH. dp and the gradients of obja, objp, the probe and H (the
    kernels' own dH, kept with retain_grad) against the plain multislice_dp
    on the same CUDA tensors, each within 1e-4 of its largest entry. Returns
    the kernel route's launch counts."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, forward_route,
                                         get_obj_patches, get_probes, make_model, multislice_dp)
    F = importlib.import_module("ptyrad_tpu_torch.models.forward")
    from ptyrad_tpu_torch.ops import chain as C

    nz = 2 * PSO_SG
    data = dict(init, obj=random_object((1, nz, *init["obj"].shape[2:]), SEED + 3))
    mp = {"update_params": {"slice_thickness": {"lr": 1e-4}}}
    idx = torch.arange(0, PSO_SCANS, PSO_SCANS // BATCH, device=dev)
    w = torch.rand((BATCH, PSO_NPIX, PSO_NPIX), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    held = []

    def keep_h(*args):
        h = compute_propagators(*args)
        h.retain_grad()
        held.append(h)
        return h

    def run(kernels: bool):
        params, buffers, geom = make_model(data, mp, dev)
        for name in ("obja", "objp", "probe", "slice_thickness"):
            getattr(params, name).requires_grad_(True)
        held.clear()
        if kernels:
            require(forward_route(params, geom, idx) == "chain", "forward() left the chain route")
            F.compute_propagators = keep_h  # forward() looks it up at call time
            try:
                dp, _ = far_field_on(lambda: forward(params, buffers, geom, idx))
            finally:
                F.compute_propagators = compute_propagators
        else:
            obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                               keep_h(params, buffers, geom, idx), buffers.omode_occu,
                               eps=geom.eps)
        (w * dp).sum().backward()
        return dp.detach(), {"obja": params.obja.grad, "objp": params.objp.grad,
                             "probe": params.probe.grad, "H": held[0].grad}

    (dp_k, g_k), launches = counted(lambda: run(True))
    dp_p, g_p = run(False)
    names = sorted(g_p)
    (e_dp,), (t_dp,) = _grad_errs([dp_k], [dp_p])
    errs, tols = _grad_errs([g_k[n] for n in names], [g_p[n] for n in names])
    emit({"phase": "far_field_carve", "nz": nz, "sg": C.best_sg(nz), "S": nz // PSO_SG - 1,
          "batch": BATCH, "max_abs_err": e_dp, "tolerance": t_dp, "grad_names": names,
          "grad_max_abs_err": errs, "grad_tolerance": tols, "launches": launches})
    require(bool(torch.isfinite(dp_k).all()) and e_dp <= t_dp,
            f"the carved route differs from the plain version: {e_dp} > {t_dp}")
    for name, e, t in zip(names, errs, tols):
        require(e <= t, f"the carved route's gradient of {name} differs: {e} > {t}")
    for name in ("B6a chain_stack_fwd", "B6b chain_stack_bwd", "B6b chain_stack_bwd (dH)",
                 "B5a chain_segment_fwd", "B5a chain_segment_fwd (far-field)",
                 "B5b chain_segment_bwd", "B5b chain_segment_bwd (far-field, dH)"):
        require(launches[name] == 1, f"the carved route launched {name} {launches[name]} times")
    return launches


def plain_route_check(dev) -> dict:
    """forward() where no kernel rule applies: N = 96 and 120 (not powers of
    two) on the card go through the plain torch.fft chain, the patches still
    through B1/B2. A batch of 32 with 6 probe modes, 6 slices and shifted
    probes from a seeded random object: dp and every gradient against the
    same forward() on the CPU, each within 1e-4 of its largest entry (the
    tolerance of the B4 tests). Returns the card runs' launch counts."""
    from ptyrad_tpu_torch.models import forward, forward_route, make_model
    from ptyrad_tpu_torch.physics import (electron_wavelength, make_mixed_probe,
                                          make_stem_probe, near_field_evolution)

    rng = np.random.default_rng(SEED + 6)
    lam = electron_wavelength(80.0)
    runs = []
    for n in (96, 120):
        canvas = n + 64
        probe = make_stem_probe({"kv": 80.0, "conv_angle": 24.9, "Npix": n, "dx": 0.1494})
        init = {
            "obj": random_object((1, NZ, canvas, canvas), SEED + n),
            "probe": make_mixed_probe(probe, PMODE, [0.02]),
            "probe_pos_shifts": (0.3 * rng.standard_normal((BATCH, 2))).astype(np.float32),
            "obj_tilts": np.zeros((1, 2), np.float32), "slice_thickness": 2.0,
            "H": near_field_evolution((n, n), 0.1494, 2.0, lam),
            "measurements": np.zeros((1, n, n), np.float32),
            "crop_pos": rng.integers(0, canvas - n, (BATCH, 2)).astype(np.int32),
            "omode_occu": np.ones(1, np.float32), "dx": 0.1494, "lambd": lam,
            "N_scan_slow": BATCH, "N_scan_fast": 1,
        }
        mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}}
        w = torch.from_numpy(rng.random((BATCH, n, n)).astype(np.float32))

        def run(where):
            params, buffers, geom = make_model(init, mp, where)
            for _, t in params.named():
                t.requires_grad_(True)
            idx = torch.arange(BATCH, device=where)
            require(forward_route(params, geom, idx) == "plain", f"N = {n} left the plain route")
            dp, _ = forward(params, buffers, geom, idx)
            (w.to(where) * dp).sum().backward()
            return dp.detach().cpu(), {k: t.grad.cpu() for k, t in params.named()
                                       if t.grad is not None}

        (dp_k, g_k), launches = counted(lambda: run(dev))
        dp_c, g_c = run(torch.device("cpu"))
        names = sorted(g_c)
        (e_dp,), (t_dp,) = _grad_errs([dp_k], [dp_c])
        errs, tols = _grad_errs([g_k[k] for k in names], [g_c[k] for k in names])
        emit({"phase": "forward_plain_route", "N": n, "batch": BATCH, "pmode": PMODE, "nz": NZ,
              "finite": bool(torch.isfinite(dp_k).all()), "max_abs_err_vs_cpu": e_dp,
              "tolerance": t_dp, "grad_names": names, "grad_max_abs_err": errs,
              "grad_tolerance": tols, "launches": launches})
        require(names == ["obja", "objp", "probe", "probe_pos_shifts"] and set(g_k) == set(g_c),
                f"N = {n}: gradients reached {sorted(g_k)} and {names}")
        require(bool(torch.isfinite(dp_k).all()) and e_dp <= t_dp,
                f"N = {n}: forward() on the card differs from the CPU: {e_dp} > {t_dp}")
        for k, e, t in zip(names, errs, tols):
            require(e <= t, f"N = {n}: the gradient of {k} differs from the CPU's: {e} > {t}")
        require(launches[PLAIN_ROUTE] == 1, f"N = {n}: {launches[PLAIN_ROUTE]} plain routes")
        for k in ("B1 gather_patches", "B2 scatter_add_patches"):
            require(launches[k] > 0, f"N = {n}: {k} did not gather the patches")
        for k in ("B3a loss_sums_fwd", "B4a dp_fwd", "B4b dp_bwd") + CHAIN_KERNELS:
            require(launches[k] == 0, f"N = {n}: {k} ran on the plain route")
        runs.append(launches)
    return add_counts(*runs)


# -- the measurement store and the constraints -----------------------------------

TBL_STORE_DTYPE = "bfloat16"


def tbl_store_dataset(init: dict) -> dict:
    """The tBL patterns binned 2 x 2 on the host to 64^2, as a detector
    read out at half the sampling hands them over, with the scale factors
    that resample them back to the probe's 128^2 on the fly."""
    from ptyrad_tpu_torch.initialization import meas_resample_on_the_fly

    meas = init["measurements"].cpu().numpy()
    half = NPIX // 2
    binned = meas.reshape(N_SCANS, half, 2, half, 2).sum(axis=(2, 4))
    factors, npix = meas_resample_on_the_fly(binned, (2, 2))
    require(npix == NPIX, f"the resampled patterns would be {npix} wide")
    return dict(init, measurements=binned, on_the_fly_meas_scale_factors=factors)


def tbl_store_path(dev, card: str, data: dict):
    """The tBL reconstruction from a reduced measurement store: 64^2
    patterns stored as bfloat16, each batch upcast and resampled bilinearly
    by (2, 2) with its intensity conserved, trained through B3."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    params = copy.deepcopy(TBL_PARAMS)
    params["model_params"]["meas_dtype"] = TBL_STORE_DTYPE
    torch.cuda.reset_peak_memory_stats()
    solver = PtyRADSolver(params, init_variables=data, device=dev, verbose=True)
    store = solver.buffers.measurements
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    emit({
        "phase": "tbl_store", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "store_dtype": str(store.dtype), "store_shape": list(store.shape),
        "store_bytes": store.numel() * store.element_size(),
        "float32_128_bytes": N_SCANS * NPIX * NPIX * 4,
        "scale_factors": list(solver.geom.meas_scale_factors),
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [N_SCANS / t for t in times], "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    require(store.dtype == torch.bfloat16 and tuple(store.shape[-2:]) == (NPIX // 2, NPIX // 2),
            f"the store is {store.dtype} {tuple(store.shape)}")
    require(len(losses) == NITER and all(np.isfinite(losses)), f"tbl_store: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"tbl_store: loss did not fall: {losses}")
    steps = NITER * -(-N_SCANS // BATCH)
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd"):
        require(launches[name] == steps, f"tbl_store: {name} ran {launches[name]} times in "
                f"{steps} steps")
    return solver, launches


def constraints_check(dev) -> None:
    """All twelve constraints, at their default options, applied once to a
    tBL-sized model (the simulation's object with a varying amplitude, probe
    modes of distinct powers, the per-position tilt field) on the card and
    on the CPU: finite, and each parameter within 1e-4 of its largest entry
    (float32 transforms and blurs on two devices). ortho_pmode leaves each
    mode's phase free, so the probe is compared by its mode powers and its
    incoherent intensity sum_m |p_m|^2."""
    from ptyrad_tpu_torch.constraints import DEFAULT_CONSTRAINT_PARAMS, ConstraintScheduler
    from ptyrad_tpu_torch.models import make_model
    from ptyrad_tpu_torch.physics import make_mixed_probe, make_stem_probe

    every = {name: {"freq": 1} for name in DEFAULT_CONSTRAINT_PARAMS}
    init = tbl_init()
    rng = np.random.default_rng(SEED + 4)
    amp = 1.0 + 0.03 * rng.standard_normal(init["obj"].shape).astype(np.float32)
    probe = make_stem_probe({"kv": 80.0, "conv_angle": 24.9, "Npix": NPIX, "dx": 0.1494})
    init.update(obj=(amp * init["obj"]).astype(np.complex64), obj_tilts=tilt_field(),
                probe=make_mixed_probe(probe, PMODE, [0.05, 0.04, 0.03, 0.02, 0.01]))
    out = {}
    for where in (dev, torch.device("cpu")):
        params, buffers, geom = make_model(init, None, where)
        sched = ConstraintScheduler(every, geom)
        require(len(sched.active_names) == 12, f"{sched.active_names} are active")
        sched(params, buffers, 1)
        got = {n: t.detach().cpu() for n, t in params.named() if n != "probe"}
        power = (params.probe.detach().abs() ** 2).cpu()
        got.update(probe_mode_power=power.sum(dim=(-2, -1)), probe_intensity=power.sum(0))
        out[where.type] = got
    names = sorted(out["cpu"])
    errs, tols = _grad_errs([out["cuda"][n] for n in names], [out["cpu"][n] for n in names])
    emit({"phase": "constraints", "applied": sched.active_names, "names": names,
          "finite": all(bool(torch.isfinite(t).all()) for t in out["cuda"].values()),
          "max_abs_err_vs_cpu": errs, "tolerance": tols})
    for name, e, t in zip(names, errs, tols):
        require(bool(torch.isfinite(out["cuda"][name]).all()), f"constraints: {name} not finite")
        require(e <= t, f"constraints: {name} differs from the CPU's: {e} > {t}")


# -- the tilt paths: optimizable slice thickness and crystal tilts -----------------

DZ_TILT_UPDATE = {"obj_tilts": {"start_iter": 1, "lr": 1.0e-4},
                  "slice_thickness": {"start_iter": 1, "lr": 1.0e-4}}


def with_dz_tilts(params: dict, constraints: dict | None = None) -> dict:
    """A copy of a configuration with obj_tilts and slice_thickness
    optimized from iteration 1 at lr 1e-4 (the rates of
    tests/test_forward.py:1164-1167), plus extra constraints."""
    out = copy.deepcopy(params)
    out["model_params"]["update_params"].update(copy.deepcopy(DZ_TILT_UPDATE))
    out["constraint_params"].update(constraints or {})
    return out


def tilt_field() -> np.ndarray:
    """A smooth per-position tilt field over the tBL raster, within +-1 mrad
    (tilt_y, tilt_x)."""
    ys, xs = np.meshgrid(np.arange(N_SIDE), np.arange(N_SIDE), indexing="ij")
    ty = 0.8 * np.sin(2 * np.pi * ys / N_SIDE) * np.cos(np.pi * xs / N_SIDE)
    tx = 0.6 * np.cos(2 * np.pi * xs / N_SIDE) + 0.2 * np.sin(np.pi * ys / N_SIDE)
    return np.stack([ty.ravel(), tx.ravel()], -1).astype(np.float32)


def run_tilt_solver(dev, card: str, phase: str, params: dict, init: dict, setup_s: float,
                    niter: int):
    """PtyRADSolver.run() with the counts set to 0 just before it; asserts a
    finite, falling loss and that dz and the tilts moved."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    tilts0 = solver.params.obj_tilts.detach().clone()
    dz0 = float(solver.params.slice_thickness.detach())
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    n = solver.buffers.measurements.shape[0]
    tilt_moved = float((solver.params.obj_tilts.detach() - tilts0).abs().max())
    emit({
        "phase": phase, "card": card, "n_patterns": n, "batch": BATCH,
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [n / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "dz": [dz0] + [v for _, v in solver.history.dz_iters],
        "avg_tilt": [np.asarray(v).tolist() for _, v in solver.history.avg_tilt_iters],
        "tilt_max_change": tilt_moved,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    require(len(losses) == niter and all(np.isfinite(losses)), f"{phase}: loss not finite")
    require(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    require(solver.history.dz_iters[-1][1] != dz0, f"{phase}: dz did not move")
    require(tilt_moved > 0.0, f"{phase}: the tilts did not move")
    return solver, launches


def tilt_path(dev, card: str):
    """The tBL reconstruction with per-position tilts: 16,384 patterns
    simulated through forward() with tilt_field() (B4a on a per-position H),
    reconstructed from zero tilts with obj_tilts (16,384 x 2) and
    slice_thickness optimized and tilt_smooth, the yml otherwise, 3
    iterations. The simulation and the run are driven under counted():
    B4a on a per-position H, B1, B2, B3a on a per-position H and B3b with
    dH must run, B4b must not; then one batch's dz and tilt gradients and dH
    through B3 against the plain route."""
    t0 = time.perf_counter()
    init = tbl_init()
    init["obj_tilts"] = tilt_field()
    init["measurements"], sim_launches = counted(lambda: simulate(dev, init))
    init.update(obj=np.ones_like(init["obj"]), obj_tilts=np.zeros((N_SCANS, 2), np.float32))
    setup_s = time.perf_counter() - t0
    params = with_dz_tilts(TBL_PARAMS, {"tilt_smooth": {"freq": 1, "std": 2.0}})
    solver, launches = run_tilt_solver(dev, card, "tilt", params, init, setup_s, NITER)
    launches = add_counts(sim_launches, launches)
    require(not solver.geom.global_tilt, "the tilt path runs one global tilt")
    for name in TILT_KERNELS + ("B4a dp_fwd (per-position H)",):
        require(launches[name] > 0, f"kernel {name} was not launched on the tilt path")
    for name in ("B4b dp_bwd", "B5a chain_segment_fwd", "B6b chain_stack_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the tilt path")
    tilt_gradients_check(solver)
    return solver, launches


def tilt_gradients_check(solver) -> None:
    """On the first batch of the trained state: s1 of the loss-folded chain
    through B3 (per-position H, dH) and through its plain version on the
    same CUDA tensors, dH within 1e-4 of its largest entry; the dz and tilt
    gradients through scalar_grads_check against the plain version in
    float64 on the CPU."""
    from ptyrad_tpu_torch.models import compute_propagators, get_measurements, get_obj_patches
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.fourier import ifftshift2
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace

    p, bufs, geom = solver.params, solver.buffers, solver.geom
    idx = torch.as_tensor(solver.batch_idx[0], device=solver.device)
    mask = torch.as_tensor(solver.batch_mask[0], device=solver.device)
    with torch.no_grad():
        obja_p, objp_p = get_obj_patches(p, bufs, geom, idx)
        probe = (fourier_shift_kspace(p.probe, p.probe_pos_shifts[idx]) if geom.shift_probes
                 else p.probe[None])
        meas_cc = ifftshift2(get_measurements(bufs, geom, idx))
    out = {}
    p64, b64 = float64_cpu(p, bufs)
    for route in ("kernels", "plain", "float64"):
        model, bb, at, ops = p, bufs, idx, (obja_p, objp_p, probe)
        if route == "float64":
            model, bb, at = p64, b64, idx.cpu()
            ops = (obja_p.cpu().double(), objp_p.cpu().double(), probe.cpu().to(torch.complex128))
        model.slice_thickness.grad = model.obj_tilts.grad = None
        h = compute_propagators(model, bb, geom, at)
        h.retain_grad()
        rest = (meas_cc, mask) if route != "float64" else (meas_cc.cpu().double(),
                                                           mask.cpu().double())
        args = (*ops, h, *rest, 0.5, geom.eps)
        s1 = (M.multislice_loss_sums_fused(*args, probe_kspace=geom.shift_probes)
              if route == "kernels" else M.loss_sums_plain(*args, geom.shift_probes))[0]
        s1.backward()
        out[route] = (h.grad, model.slice_thickness.grad.clone(), model.obj_tilts.grad[at].clone())
    (e_dh,), (t_dh,) = _grad_errs(out["kernels"][:1], out["plain"][:1])
    emit({"phase": "tilt_gradients", "batch": len(idx), "dh_max_abs_err": e_dh,
          "dh_tolerance": t_dh})
    require(e_dh <= t_dh, f"tilt path dH differs from the plain route: {e_dh} > {t_dh}")
    scalar_grads_check("tilt path", ("slice_thickness", "obj_tilts"), *(
        out[r][1:] for r in ("kernels", "plain", "float64")))
    p.slice_thickness.grad = p.obj_tilts.grad = None


def pso_tilt_path(dev, card: str):
    """The PSO reconstruction with a global tilt: the data simulated at
    (1.0, -0.5) mrad, reconstructed from (0, 0) with obj_tilts (1 x 2) and
    slice_thickness (10 Ang) optimized, 2 iterations. B5b and B6b must run
    with dH, B3 must not."""
    t0 = time.perf_counter()
    init = pso_dataset(dev, tilt=(1.0, -0.5))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    solver, launches = run_tilt_solver(dev, card, "pso_tilt", with_dz_tilts(PSO_PARAMS), init,
                                       setup_s, PSO_NITER)
    require(solver.geom.global_tilt, "the PSO tilt path runs per-position tilts")
    for name in PSO_TILT_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the PSO tilt path")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd", "B4a dp_fwd", "B4b dp_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the PSO tilt path (N = 256)")
    return solver, launches


def profile_steps(solver, card: str, path: str, niter: int, n_batches: int):
    """Where a training step's time goes: torch.profiler over n_batches steps
    of the solver's own epoch function (after the path's run, so its launches
    are not counted there). Device time by kernel, the device's busy share of
    the window's wall time, and the host time per step. Returns the record
    it prints."""
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
    # B1 and B2 by their kernels' names in csrc/patches.cu, and every memset
    # (a B2 of the parent design zeroed its canvas with one)
    patch_ms = {item: sum(ms for ms, _, k in rows if k.startswith(match)) / n_batches if rows
                else "not measured"
                for item, match in (("B1", "(anonymous namespace)::gather_kernel("),
                                    ("B2", "(anonymous namespace)::scatter_add_kernel("),
                                    ("memset", "Memset"))}
    out = {"phase": "profile", "path": path, "card": card, "steps": n_batches,
           "wall_ms": wall_ms, "ms_per_step": wall_ms / n_batches,
           "device_busy_ms": busy_ms if rows else "not measured",
           "device_ms_per_step": busy_ms / n_batches if rows else "not measured",
           "device_busy_share": busy_ms / wall_ms if rows else "not measured",
           "patches_device_ms_per_step": patch_ms,
           "top_device_ms": [{"kernel": k, "calls": c, "ms": ms} for ms, c, k in rows[:12]]}
    emit(out)
    return out


def fused_plan(n: int) -> dict:
    """The plan csrc/multislice.cu compiled for N (ptyrad_fused_plan)."""
    import ctypes

    from ptyrad_tpu_torch.ops import _build

    out = (ctypes.c_int * 11)()
    _build.check(_build.lib().ptyrad_fused_plan(n.bit_length() - 1, out), "ptyrad_fused_plan")
    keys = ("n", "elems", "line_threads", "line", "fwd_threads", "fwd_sweeps", "bwd_threads",
            "bwd_sweeps", "group_threads", "smem_bytes", "chunks")
    return dict(zip(keys, out))


KERNEL_CHECKS = ("check_patches", "check_loss_chain", "check_dp_chain", "check_chain",
                 "check_fused_dh", "check_chain_dh", "check_chain_ff")


def kernel_rows(dev, gen, atomic_b2: bool = False, atomic_b3: bool = False,
                checks=KERNEL_CHECKS) -> list:
    """Every kernel against its plain version at the main paths' shapes, and
    its times: the rows of the kernels line (chain_bench.py times the same
    rows, or those of the named ``checks``; `atomic_b2` as in
    check_patches_at, `atomic_b3` as in check_loss_chain)."""
    rows = []
    for name in checks:
        if name == "check_patches":
            rows += check_patches(dev, gen, atomic_b2)
        elif name in ("check_loss_chain", "check_dp_chain"):
            rows += globals()[name](dev, gen, atomic_b3)
        else:
            rows += globals()[name](dev, gen)
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from ptyrad_tpu_torch.device import pin_fp32
    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import fused_multislice as M

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
    for n in (PSO_NPIX, 512):
        C.prepare(dev, n)
    M.prepare(dev, NPIX)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": path.name,
          "compiled": _build.BUILD_SECONDS is not None, "fused_plan": fused_plan(NPIX)})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = kernel_rows(dev, gen)
    propagation_yardstick(dev, gen)
    torch.cuda.empty_cache()
    plain_launches = plain_route_check(dev)

    solver, tbl_launches, init, main_record = main_path(dev, card)
    main_losses = [v for _, v in solver.history.loss_iters]
    profile_steps(solver, card, "tBL", NITER + 1, n_batches=32)
    del solver
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        params_file_launches, raw_path = params_file_path(
            dev, card, init["measurements"].cpu().numpy(), tmp)
        torch.cuda.empty_cache()
        resume_record = RunRecord()
        resume_launches, solver = resume_path(dev, card, init, main_losses, tmp, resume_record)
        determinism_check("tBL", card, main_record, resume_record, solver)
        torch.cuda.empty_cache()
        cli_path(card, tmp, raw_path, solver)
        del solver
        torch.cuda.empty_cache()
        figures_launches = figures_path(dev, card, tmp, raw_path)
        hypertune_launches = hypertune_path(dev, card, tmp, raw_path)
        hypertune_cli_path(card, tmp, raw_path)
    torch.cuda.empty_cache()
    lbfgs_launches = lbfgs_path(dev, card, init)
    torch.cuda.empty_cache()
    accum_launches = grad_accum_path(dev, card, init)
    torch.cuda.empty_cache()
    family_launches = optimizers_path(dev, card, init)
    torch.cuda.empty_cache()
    grouping_launches = grouping_path(dev, card, init)
    torch.cuda.empty_cache()
    forward_launches = forward_modes_check(dev, init)
    torch.cuda.empty_cache()
    solver, low_dose_launches = low_dose_path(dev, card, init)
    profile_steps(solver, card, "low-dose", NITER + 1, n_batches=32)
    store_data = tbl_store_dataset(init)
    del solver, init
    torch.cuda.empty_cache()
    solver, store_launches = tbl_store_path(dev, card, store_data)
    profile_steps(solver, card, "tBL-store", NITER + 1, n_batches=32)
    del solver, store_data
    torch.cuda.empty_cache()
    constraints_check(dev)
    torch.cuda.empty_cache()
    solver, pso_launches, pso_init, pso_ref = pso_path(dev, card)
    pso_ms = profile_steps(solver, card, "PSO", PSO_NITER + 1, n_batches=8)["device_ms_per_step"]
    del solver
    torch.cuda.empty_cache()
    solver, pso_ff_launches = pso_ff_path(dev, card, pso_init, pso_ref)
    pso_ff_ms = far_field_on(
        lambda: profile_steps(solver, card, "PSO-ff", PSO_NITER + 1, n_batches=8)
    )["device_ms_per_step"]
    emit({"phase": "pso_ff_profile", "card": card,
          "device_ms_per_step": {"pso": pso_ms, "pso_ff": pso_ff_ms}})
    del solver
    torch.cuda.empty_cache()
    random_start_launches = pso_ff_random_start(dev, pso_init)
    torch.cuda.empty_cache()
    carve_launches = carve_check(dev, pso_init)
    del pso_init
    torch.cuda.empty_cache()
    solver, tilt_launches = tilt_path(dev, card)
    profile_steps(solver, card, "tBL-tilt", NITER + 1, n_batches=32)
    del solver
    torch.cuda.empty_cache()
    solver, pso_tilt_launches = pso_tilt_path(dev, card)
    profile_steps(solver, card, "PSO-tilt", PSO_NITER + 1, n_batches=8)
    narrow = add_counts(plain_launches, tbl_launches, params_file_launches, resume_launches,
                        forward_launches, low_dose_launches, store_launches, tilt_launches,
                        lbfgs_launches, accum_launches, family_launches, figures_launches,
                        hypertune_launches,
                        *([grouping_launches] if grouping_launches else []))
    wide = add_counts(pso_launches, pso_ff_launches, random_start_launches, carve_launches,
                      pso_tilt_launches)
    launches = add_counts(narrow, wide)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    launches.update({name: 0 for name in NOT_DRIVEN})
    # B1/B2's rows at the tBL shapes count the launches of the N <= 128 runs,
    # their rows at the PSO shapes those of the N = 256 runs
    for name in PATCH_KERNELS:
        launches[name], launches[name + PSO_SHAPES] = narrow[name], wide[name]
    emit({"kernels": [{key: {**k, "launches": launches[k["name"]]}[key] for key in keys}
                      for k in kernels]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
