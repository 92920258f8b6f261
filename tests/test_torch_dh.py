"""The need_dh path: optimizable slice thickness and crystal tilts, where the
propagator H depends on parameters (per position for tilt_type 'each') and
every chain kernel's backward returns its cotangent dH. The port's plain
versions (what its wrappers run on a CPU tensor) against ptyrad_tpu on the
CPU, with the JAX kernels in Pallas interpret mode:

(a) loss_sums_plain (B3's plain version) against multislice_loss_sums_fused;
(b) chain_segment_plain, chain_stack_plain and multislice_dp_chain (B5/B6)
    against chain_segment, chain_stack and multislice_dp_chain with
    need_dh=True;
(c) loss_fn (B3's route) and forward() + combined_loss (B4's) with
    optimizable dz and global or per-position tilts, against the JAX
    forward() + combined_loss;
(d) tilt_smooth through the scheduler;
(e) a 2-iteration tBL-like solver run with tilt_type 'each', optimizable dz
    and tilt_smooth.

Tolerances: dH fields at atol 2e-5 of the largest reference entry and rtol
1e-3 (float32 chains through two FFT implementations, as for every other
cotangent, tests/test_forward.py:356-372); the chain's values at rtol 1e-4
(tests/test_torch_chain.py). The dz and tilt gradients at rtol 5e-2, the
tolerance the JAX package's own test needs (tests/test_forward.py:1188-1198):
autograd contracts the dH field against Kz, Ky and Kx into those scalars,
O(100) entries into an O(0.01) sum, so float32 rounding in either package
shows at the percent level there although dH itself agrees to ~1e-6.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.constraints import ConstraintScheduler as JaxScheduler
from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.losses import combined_loss as j_combined_loss
from ptyrad_tpu.models import forward as j_forward
from ptyrad_tpu.models import get_measurements as j_get_measurements
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.ops import pallas_chain as pch
from ptyrad_tpu.ops import pallas_multislice as jpm
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu_torch.constraints import ConstraintScheduler
from ptyrad_tpu_torch.engine.solver import PtyRADSolver, loss_fn
from ptyrad_tpu_torch.losses import combined_loss
from ptyrad_tpu_torch.models import forward, forward_route, make_model
from ptyrad_tpu_torch.ops import chain as C
from ptyrad_tpu_torch.ops import fused_multislice as tfm
from torch_port_helpers import CPU, assert_grad_close, np_, toy_init

B, PMODE, N = 2, 2, 16
TILT_RTOL = 5e-2  # the dz / tilt scalars: see the module docstring
LR = 1e-4         # dz and tilt rates of tests/test_forward.py:1164-1167
DZ_TILT_UPDATE = {"slice_thickness": {"lr": LR, "start_iter": 1},
                  "obj_tilts": {"lr": LR, "start_iter": 1}}
LOSS_SINGLE = {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
               "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}}
LOW_DOSE = {"loss_single": {"state": False, "weight": 0.0, "dp_pow": 0.5},
            "loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
            "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2}}


def _close_h(actual, expected_r, expected_i):
    assert_grad_close(actual.real, expected_r, "dH.re")
    assert_grad_close(actual.imag, expected_i, "dH.im")


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


# -- (a) B3: the loss-folded chain ------------------------------------------

@pytest.mark.parametrize("h_b", [1, B])
def test_loss_sums_dh_matches_pallas_interpret(rng, h_b):
    nz = 3
    obja = (1 + 0.05 * rng.standard_normal((B, 1, nz, N, N))).astype(np.float32)
    objp = (0.1 * rng.standard_normal((B, 1, nz, N, N))).astype(np.float32)
    probe = _cplx(rng, (B, PMODE, N, N), 1.0 / N)
    h = np.exp(1j * rng.uniform(-np.pi, np.pi, (h_b, N, N))).astype(np.complex64)
    meas = np.abs(rng.standard_normal((B, N, N))).astype(np.float32) * 4.0 / (N * N)
    mask = np.array([1.0, 0.5], np.float32)
    mask_pad = jnp.zeros((B, 8, 128), jnp.float32).at[:, 0, 0].set(jnp.asarray(mask))

    def j_s1(hr, hi):
        return jpm.multislice_loss_sums_fused(
            jnp.asarray(obja), jnp.asarray(objp), jnp.asarray(probe.real),
            jnp.asarray(probe.imag), hr, hi, jnp.asarray(meas), mask_pad, 0.5, 1e-10, True,
            True)[0]

    jpm.set_interpret(True)
    try:
        j_g = jax.grad(j_s1, argnums=(0, 1))(jnp.asarray(h.real), jnp.asarray(h.imag))
    finally:
        jpm.set_interpret(False)

    th = torch.from_numpy(h).requires_grad_(True)
    s1, _ = tfm.multislice_loss_sums_fused(
        torch.from_numpy(obja), torch.from_numpy(objp), torch.from_numpy(probe), th,
        torch.from_numpy(meas), torch.from_numpy(mask), 0.5, 1e-10, probe_kspace=True)
    s1.backward()
    assert th.grad.shape == (h_b, N, N)
    _close_h(np_(th.grad), j_g[0], j_g[1])


# -- (b) B5/B6: the segmented chain ---------------------------------------------

def _chain_inputs(rng, nz, h_b):
    psi = _cplx(rng, (B, PMODE, N, N))
    a = rng.uniform(0.9, 1.0, (B, nz, N, N)).astype(np.float32)
    p = rng.uniform(-0.3, 0.3, (B, nz, N, N)).astype(np.float32)
    h = np.exp(1j * rng.uniform(0, 6, (h_b, N, N))).astype(np.complex64)
    g = _cplx(rng, (B, PMODE, N, N))
    return psi, a, p, h, g


def _compare_chain_vjp(j_fn, t_fn, psi, a, p, h, g):
    """The exit and the cotangents of (psi, a, p, h) of a JAX chain function
    of (psi_r, psi_i, a, p, h_r, h_i) and the port's of (psi, a, p, h)."""
    j_args = [jnp.asarray(x) for x in (psi.real, psi.imag, a, p, h.real, h.imag)]
    (out_r, out_i), vjp = jax.vjp(j_fn, *j_args)
    dr, di, da, dp, dhr, dhi = vjp((jnp.asarray(g.real), jnp.asarray(g.imag)))

    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (psi, a, p, h)]
    out = t_fn(*leaves)
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    np.testing.assert_allclose(np_(out), np.asarray(out_r) + 1j * np.asarray(out_i),
                               rtol=1e-4, atol=1e-6)
    assert_grad_close(np_(grads[0]).real, dr, "psi.re")
    assert_grad_close(np_(grads[0]).imag, di, "psi.im")
    assert_grad_close(np_(grads[1]), da, "a")
    assert_grad_close(np_(grads[2]), dp, "phi")
    _close_h(np_(grads[3]), dhr, dhi)


@pytest.fixture()
def chain_interpret():
    pch.set_interpret(True)
    try:
        yield
    finally:
        pch.set_interpret(False)


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("h_b", [1, B])
def test_chain_segment_dh_matches_jax(chain_interpret, last, h_b):
    psi, a, p, h, g = _chain_inputs(np.random.default_rng(11), 3, h_b)
    _compare_chain_vjp(lambda *x: pch.chain_segment(*x, last, True),
                       lambda *x: C.chain_segment_plain(*x, last), psi, a, p, h, g)


@pytest.mark.parametrize("last_mega,h_b", [(True, 1), (False, B)])
def test_chain_stack_dh_matches_jax(chain_interpret, last_mega, h_b):
    """S = 2 segments of sg = 2: the propagation across the segment boundary
    and, with last_mega False, the exit's own propagation carry dH too."""
    psi, a, p, h, g = _chain_inputs(np.random.default_rng(12), 4, h_b)
    _compare_chain_vjp(lambda *x: pch.chain_stack(*x, 2, last_mega, True),
                       lambda *x: C.chain_stack_plain(*x, 2, last_mega), psi, a, p, h, g)


@pytest.mark.parametrize("h_b,nz,seg", [(1, 5, 2), (B, 5, 2)])
def test_multislice_dp_chain_dh_matches_jax(chain_interpret, h_b, nz, seg):
    """B6 over 4 slices, B5 over a 1-slice tail: dH summed over both calls."""
    rng = np.random.default_rng(13)
    obja = rng.uniform(0.9, 1.0, (B, 1, nz, N, N)).astype(np.float32)
    objp = rng.uniform(-0.3, 0.3, (B, 1, nz, N, N)).astype(np.float32)
    probe = _cplx(rng, (1, PMODE, N, N))
    h = np.exp(1j * rng.uniform(0, 6, (h_b, N, N))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, (B, N, N)).astype(np.float32)
    occu = jnp.ones(1, jnp.float32)

    def j_loss(hr, hi):
        dp = pch.multislice_dp_chain(jnp.asarray(obja), jnp.asarray(objp),
                                     Cplx(jnp.asarray(probe.real), jnp.asarray(probe.imag)),
                                     Cplx(hr, hi), occu, 1e-10, need_dh=True,
                                     seg_override=seg)
        return jnp.sum(jnp.asarray(w) * jnp.sqrt(dp))

    j_g = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(h.real), jnp.asarray(h.imag))
    th = torch.from_numpy(h).requires_grad_(True)
    dp = C.multislice_dp_chain(torch.from_numpy(obja), torch.from_numpy(objp),
                               torch.from_numpy(probe), th, torch.ones(1), 1e-10,
                               seg_override=seg)
    (torch.from_numpy(w) * torch.sqrt(dp)).sum().backward()
    _close_h(np_(th.grad), j_g[0], j_g[1])


# -- (c) forward() and loss_fn with optimizable dz and tilts ---------------------

@pytest.mark.parametrize("tilt_each", [False, True])
@pytest.mark.parametrize("loss_params", [LOSS_SINGLE, LOW_DOSE], ids=["B3", "B4"])
def test_dz_tilt_gradients_match_jax(rng, tilt_each, loss_params):
    """The port's loss_fn (fused_loss_terms through B3's plain version for
    loss_single; forward() through B4's and combined_loss for the low-dose
    mix) against the JAX forward() + combined_loss on its jnp path: the loss
    at rtol 1e-5, the dz and tilt gradients at TILT_RTOL, the object and
    probe gradients as usual."""
    n_scans = 6
    init = toy_init(rng, n_scans=n_scans, nz=3, pmode=2)
    rows = n_scans if tilt_each else 1
    init["obj_tilts"] = (0.5 + 0.1 * rng.standard_normal((rows, 2))).astype(np.float32)
    mp = {"update_params": DZ_TILT_UPDATE}
    jp, jb, jg = j_make_model(init, mp)
    jg = dataclasses.replace(jg, fwd_fused=False)
    tp, tb, tg = make_model(init, mp, device=CPU)
    assert tg.change_thickness and tg.tilt_obj and tg.global_tilt is not tilt_each
    idx = np.arange(4)
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

    def j_loss(p):
        dp, (oa, op) = j_forward(p, jb, jg, jnp.asarray(idx))
        meas = j_get_measurements(jb, jg, jnp.asarray(idx))
        return j_combined_loss(dp, meas, oa, op, jb.omode_occu, loss_params, jnp.asarray(mask))[0]

    j_total, j_grads = jax.value_and_grad(j_loss)(jp)

    for _, t in tp.named():
        t.requires_grad_(True)
    t_idx = torch.from_numpy(idx)
    assert forward_route(tp, tg, t_idx) == "fused"
    total, _ = loss_fn(tp, tb, tg, t_idx, torch.from_numpy(mask), loss_params)
    total.backward()

    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    assert float(np.abs(np.asarray(j_grads.slice_thickness))) > 0.0
    np.testing.assert_allclose(float(tp.slice_thickness.grad), float(j_grads.slice_thickness),
                               rtol=TILT_RTOL)
    np.testing.assert_allclose(np_(tp.obj_tilts.grad), np.asarray(j_grads.obj_tilts),
                               rtol=TILT_RTOL, atol=1e-8)
    assert_grad_close(np_(tp.objp.grad), j_grads.objp, "objp")
    assert_grad_close(np_(tp.obja.grad), j_grads.obja, "obja")
    assert_grad_close(np_(tp.probe.grad.real), j_grads.probe.re, "probe.re")
    assert_grad_close(np_(tp.probe.grad.imag), j_grads.probe.im, "probe.im")


def test_fixed_nonzero_tilt_needs_no_dh(rng):
    """A nonzero tilt that is not optimized still makes H per position, but
    H then needs no gradient: forward() runs and only the object and probe
    get gradients."""
    init = toy_init(rng, n_scans=4, nz=3, pmode=2)
    init["obj_tilts"] = np.full((4, 2), 0.7, np.float32)
    tp, tb, tg = make_model(init, None, device=CPU)
    assert tg.tilt_obj and not tg.global_tilt and not tg.change_thickness
    for name in ("obja", "objp", "probe"):
        getattr(tp, name).requires_grad_(True)
    dp, (oa, op) = forward(tp, tb, tg, torch.arange(4))
    meas = torch.from_numpy(init["measurements"][:4])
    combined_loss(dp, meas, oa, op, tb.omode_occu, LOW_DOSE, None)[0].backward()
    assert tp.obj_tilts.grad is None and tp.slice_thickness.grad is None
    assert float(tp.objp.grad.abs().max()) > 0.0


# -- (d) tilt_smooth -----------------------------------------------------------------

@pytest.mark.parametrize("std", [2.0, 0.7])
def test_tilt_smooth_matches_jax(rng, std):
    n_slow, n_fast = 4, 5
    init = toy_init(rng, n_scans=n_slow * n_fast)
    init.update(N_scan_slow=n_slow, N_scan_fast=n_fast,
                obj_tilts=rng.standard_normal((n_slow * n_fast, 2)).astype(np.float32))
    cfg = {"tilt_smooth": {"freq": 1, "std": std}}
    jp, jb, jg = j_make_model(init, None)
    tp, tb, tg = make_model(init, None, device=CPU)
    j_out = JaxScheduler(cfg, jg)(jp, jb, 1)
    sched = ConstraintScheduler(cfg, tg)
    assert sched.active_names == ["tilt_smooth"]
    sched(tp, tb, 1)
    np.testing.assert_allclose(np_(tp.obj_tilts), np.asarray(j_out.obj_tilts), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(np_(tp.obj_tilts), init["obj_tilts"])


def test_tilt_smooth_leaves_a_global_tilt(rng):
    init = toy_init(rng, n_scans=4)
    init["obj_tilts"] = np.array([[0.3, -0.2]], np.float32)
    tp, tb, tg = make_model(init, None, device=CPU)
    ConstraintScheduler({"tilt_smooth": {"freq": 1}}, tg)(tp, tb, 1)
    np.testing.assert_array_equal(np_(tp.obj_tilts), init["obj_tilts"])


# -- (e) the slice as a whole: a tBL-like run with per-position tilts ----------------

N_SLOW, N_FAST = 3, 4


def tilt_params():
    update = {"obja": {"start_iter": 1, "lr": 5e-4}, "objp": {"start_iter": 1, "lr": 5e-4},
              "probe": {"start_iter": 1, "lr": 1e-4},
              "probe_pos_shifts": {"start_iter": None, "lr": 0}, **DZ_TILT_UPDATE}
    return {
        "model_params": {"optimizer_params": {"name": "Adam"}, "update_params": update},
        "loss_params": LOSS_SINGLE,
        "constraint_params": {"fix_probe_int": {"freq": 1},
                              "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
                              "tilt_smooth": {"freq": 1, "std": 2.0}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 4}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


@pytest.fixture(scope="module")
def tilt_runs():
    """Patterns simulated with a smooth per-position tilt field (within
    0.8 mrad), reconstructed by both solvers from a flat object, zero tilts
    and the simulation's dz; ortho_pmode is left out, its eigenvector phases
    being a free gauge (tests/test_torch_solver.py)."""
    rng = np.random.default_rng(21)
    n_scans = N_SLOW * N_FAST
    init = toy_init(rng, n_scans=n_scans, npix=16, nz=3, pmode=2, canvas=32)
    init.update(N_scan_slow=N_SLOW, N_scan_fast=N_FAST)
    ys, xs = np.meshgrid(np.arange(N_SLOW), np.arange(N_FAST), indexing="ij")
    tilts = 0.8 * np.stack([np.sin(ys.ravel() / 2.0), np.cos(xs.ravel() / 3.0)], -1)
    params, buffers, geom = make_model(dict(init, obj_tilts=tilts.astype(np.float32)), None,
                                       device=CPU)
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(n_scans))
    init.update(measurements=np_(dp), obj=np.ones_like(init["obj"]),
                obj_tilts=np.zeros((n_scans, 2), np.float32))
    js = JaxSolver(tilt_params(), init_variables=copy.deepcopy(init), verbose=False)
    js.run()
    ts = PtyRADSolver(tilt_params(), init_variables=copy.deepcopy(init), device="cpu",
                      verbose=False)
    ts.run()
    assert ts.geom.tilt_obj and not ts.geom.global_tilt and ts.geom.change_thickness
    np.testing.assert_array_equal(ts.batch_idx, js.batch_idx)
    return js, ts, init


def test_tilt_solver_trajectory_matches_jax(tilt_runs):
    js, ts, _ = tilt_runs
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert len(ours) == len(ref) == 2 and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_tilt_solver_dz_and_tilts_match_jax(tilt_runs):
    """dz and the mean tilt per iteration at atol 2.5 lr: Adam's steps are
    about lr each, and where a gradient is near zero its sign can differ
    between the two float32 paths (tests/test_torch_solver.py). Both must
    have moved from their start."""
    js, ts, init = tilt_runs
    dz = np.array([v for _, v in ts.history.dz_iters])
    dz_ref = np.array([v for _, v in js.history.dz_iters])
    np.testing.assert_allclose(dz, dz_ref, rtol=0, atol=2.5 * LR)
    assert dz[-1] != init["slice_thickness"]
    tilt = np.array([v for _, v in ts.history.avg_tilt_iters])
    tilt_ref = np.array([v for _, v in js.history.avg_tilt_iters])
    np.testing.assert_allclose(tilt, tilt_ref, rtol=0, atol=2.5 * LR)
    assert np.abs(np_(ts.params.obj_tilts)).max() > 0.0
    np.testing.assert_allclose(np_(ts.params.obj_tilts), np.asarray(js.params.obj_tilts),
                               rtol=0, atol=2.5 * LR)
