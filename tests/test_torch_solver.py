"""The slice as a whole: ptyrad_tpu's PtyRADSolver and ptyrad_tpu_torch's,
from the same init_variables with the tBL_WSe2 sections at small widths
(16^2 patterns, 2 probe modes, 3 slices, 11 scans; BATCH_SIZE 3 makes
batches of 4, 4 and 3, so the last is padded), a fixed GROUP_MODE_SEED, 3
iterations.

The port's solver runs on the CPU, where its loss-folded chain is the plain
torch.fft version; the JAX solver runs its XLA reference path.
"""

import copy

import numpy as np
import pytest
import torch

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.models import forward, make_model
from torch_port_helpers import CPU, cplx_np, np_, toy_init

LR = {"obja": 5.0e-4, "objp": 5.0e-4, "probe": 1.0e-4, "probe_pos_shifts": 1.0e-4}
SHIFTS_START = 3

TBL_CONSTRAINTS = {
    "ortho_pmode": {"freq": 1},
    "fix_probe_int": {"freq": 1},
    "obj_rblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5},
    "obj_zblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 1.0},
    "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
    "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
}


def tbl_params(constraints):
    update = {name: {"start_iter": 1, "lr": lr} for name, lr in LR.items()}
    update["probe_pos_shifts"]["start_iter"] = SHIFTS_START
    update["obj_tilts"] = {"start_iter": None, "lr": 0}
    update["slice_thickness"] = {"start_iter": None, "lr": 0}
    return {
        "model_params": {"optimizer_params": {"name": "Adam"}, "update_params": update},
        "loss_params": {
            "loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
            "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1},
        },
        "constraint_params": constraints,
        "recon_params": {"NITER": 3, "BATCH_SIZE": {"size": 3}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


@pytest.fixture(scope="module")
def dataset():
    """Measurements simulated from a weak phase object; reconstruction then
    starts from a flat object."""
    rng = np.random.default_rng(7)
    init = toy_init(rng, n_scans=11, npix=16, nz=3, pmode=2, canvas=32)
    params, buffers, geom = make_model(init, None, device=CPU)
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(11))
    init["measurements"] = np_(dp)
    init["obj"] = np.ones_like(init["obj"])
    return init


def run_both(init, constraints):
    """Both solvers; per-iteration probe_pos_shifts recorded by callback."""
    jax_shifts, our_shifts = {}, {}
    js = JaxSolver(tbl_params(constraints), init_variables=copy.deepcopy(init), verbose=False)
    js.run(callback=lambda n, p, h: jax_shifts.__setitem__(n, np.array(p.probe_pos_shifts)))
    ts = PtyRADSolver(tbl_params(constraints), init_variables=copy.deepcopy(init), device="cpu",
                      verbose=False)
    ts.run(callback=lambda n, p, h: our_shifts.__setitem__(n, np_(p.probe_pos_shifts).copy()))
    assert ts.batch_idx.shape == (3, 4) and ts.batch_mask[-1, -1] == 0.0  # padded tail
    np.testing.assert_array_equal(ts.batch_idx, js.batch_idx)
    return js, ts, jax_shifts, our_shifts


@pytest.fixture(scope="module")
def runs_without_ortho(dataset):
    constraints = {k: v for k, v in TBL_CONSTRAINTS.items() if k != "ortho_pmode"}
    return run_both(dataset, constraints)


def test_trajectory_matches_jax(runs_without_ortho):
    """Per-iteration losses at rtol 1e-4; final objects and probe at an atol
    that admits 2.5 lr: where a gradient is near zero its sign can differ
    between the two float32 paths, and Adam's step is then about lr in the
    opposite direction (the reasoning of __graft_entry__.py:238-241)."""
    js, ts, _, _ = runs_without_ortho
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert len(ours) == len(ref) == 3
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    np.testing.assert_allclose(np_(ts.params.objp), np.asarray(js.params.objp),
                               atol=2.5 * LR["objp"])
    np.testing.assert_allclose(np_(ts.params.obja), np.asarray(js.params.obja),
                               atol=2.5 * LR["obja"])
    np.testing.assert_allclose(np_(ts.params.probe), cplx_np(js.params.probe),
                               atol=2.5 * LR["probe"])


def test_gated_shifts_agree(runs_without_ortho, dataset):
    """probe_pos_shifts stays exactly unchanged before its start_iter in both
    packages, then moves, and the two agree."""
    _, _, jax_shifts, our_shifts = runs_without_ortho
    start = dataset["probe_pos_shifts"]
    for n in range(1, SHIFTS_START):
        np.testing.assert_array_equal(jax_shifts[n], start)
        np.testing.assert_array_equal(our_shifts[n], start)
    assert np.abs(our_shifts[SHIFTS_START] - start).max() > 0
    np.testing.assert_allclose(our_shifts[SHIFTS_START], jax_shifts[SHIFTS_START],
                               atol=2.5 * LR["probe_pos_shifts"])


def test_with_ortho_pmode_gauge_invariant(dataset):
    """All six tBL constraints. ortho_pmode fixes each mode's phase only up to
    a gauge each eigh picks as it likes, and Adam's elementwise steps then
    part the two trajectories legitimately; so compare gauge-invariant
    observables, as tests/test_reference_parity.py:466 does. Iteration 1's
    loss precedes the first constraint pass (rtol 1e-4); the later losses
    drift apart by a few 1e-3 here (rtol 1e-2, the reference test allows 5%
    over 12 iterations). The objects stay within 2.5 lr as above, and the
    probe's mixed-state density (the mode sum of |psi|^2) within 2% of its
    peak."""
    js, ts, _, _ = run_both(dataset, TBL_CONSTRAINTS)
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert np.all(np.isfinite(ours)) and ours[-1] < ours[0]
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=1e-2)
    np.testing.assert_allclose(np_(ts.params.objp), np.asarray(js.params.objp),
                               atol=2.5 * LR["objp"])
    np.testing.assert_allclose(np_(ts.params.obja), np.asarray(js.params.obja),
                               atol=2.5 * LR["obja"])
    density_ours = (np.abs(np_(ts.params.probe)) ** 2).sum(0)
    density_ref = (np.abs(cplx_np(js.params.probe)) ** 2).sum(0)
    np.testing.assert_allclose(density_ours, density_ref, atol=2e-2 * density_ref.max())


def test_solver_needs_cuda_unless_cpu_is_asked(dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PtyRADSolver(tbl_params({}), init_variables=dataset)
