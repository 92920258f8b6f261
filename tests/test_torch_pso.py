"""The PSO slice (demo/params/PSO_reconstruct.yml) at small widths:
ptyrad_tpu_torch against ptyrad_tpu on the CPU.

The on-the-fly measurement pad, get_measurements with it, fftn3 and the
kz_filter constraint, the decline of the loss-folded path at N = 256, and a
PSO-like solver run: 2 x 2 scan, 64^2 crops padded on the fly to 256^2,
2 probe modes, 5 slices, batch 2, the yml's constraints and learning rates
(probe_pos_shifts from iteration 1), 2 iterations. N = 256 is the smallest
size that the fused rule declines and the chain accepts, so there the port's
solver goes forward() -> the chain (plain on the CPU) -> combined_loss,
while the JAX solver takes its XLA path off the TPU.
"""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptyrad_tpu.constraints as JC
from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.initialization import Initializer
from ptyrad_tpu.models import get_measurements as j_get_measurements
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu.ops.fourier import fftn3 as j_fftn3
from ptyrad_tpu_torch import constraints as TC
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.initialization import meas_pad_on_the_fly
from ptyrad_tpu_torch.models import fused_loss_terms, get_measurements, make_model
from ptyrad_tpu_torch.models.forward import forward
from ptyrad_tpu_torch.ops.fourier import fftn3
from torch_port_helpers import CPU, cplx_np, np_, toy_init

NPIX, CROP, NZ, PMODE = 256, 64, 5, 2
LO = (NPIX - CROP) // 2

PSO_PARAMS = {
    "model_params": {
        "optimizer_params": {"name": "Adam"},
        "update_params": {
            "obja": {"start_iter": 1, "lr": 5.0e-4},
            "objp": {"start_iter": 1, "lr": 5.0e-4},
            "probe": {"start_iter": 1, "lr": 1.0e-4},
            "probe_pos_shifts": {"start_iter": 1, "lr": 1.0e-4},
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
    "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 2}, "GROUP_MODE": "random",
                     "GROUP_MODE_SEED": 0},
}


def _crops(rng, n=6):
    """Diffraction-like crops: a bright disk over a decaying background."""
    y, x = np.mgrid[:CROP, :CROP] - CROP // 2
    r = np.sqrt(y**2 + x**2) + 1.0
    base = np.where(r < 12, 1.0, 0.0) + 0.05 * r**-1.5
    return (base * rng.uniform(0.8, 1.2, (n, CROP, CROP))).astype(np.float32)


@pytest.mark.parametrize("padding_type", ["power", "exp", "constant", "edge", "linear_ramp"])
def test_meas_pad_on_the_fly_matches_initializer(padding_type):
    meas = _crops(np.random.default_rng(0))
    cfg = {"mode": "on_the_fly", "padding_type": padding_type, "target_Npix": NPIX,
           "threshold": 70, "value": 3}
    stub = types.SimpleNamespace(init_variables={}, init_params={})
    out = Initializer._meas_pad(stub, meas, cfg)
    assert out is meas
    padded, idx = meas_pad_on_the_fly(meas, padding_type, NPIX, threshold=70, value=3)
    assert idx == list(stub.init_variables["on_the_fly_meas_padded_idx"]) == [LO, LO + CROP] * 2
    ref = stub.init_variables["on_the_fly_meas_padded"]
    assert padded.shape == ref.shape == (NPIX, NPIX) and padded.dtype == np.float32
    np.testing.assert_allclose(padded, ref, rtol=1e-6, atol=0)
    assert not padded[LO:LO + CROP, LO:LO + CROP].any()


def test_meas_pad_rejects_unknown_type():
    with pytest.raises(ValueError, match="padding_type"):
        meas_pad_on_the_fly(np.ones((2, 8, 8), np.float32), "mirror", 16)


def _pad_init(rng, n_scans=4):
    init = toy_init(rng, n_scans=n_scans, npix=NPIX, nz=NZ, pmode=PMODE, canvas=NPIX + 8)
    crops = _crops(rng, n_scans)
    padded, idx = meas_pad_on_the_fly(crops, "power", NPIX, 70)
    init.update(measurements=crops, on_the_fly_meas_padded=padded,
                on_the_fly_meas_padded_idx=idx)
    return init


def test_get_measurements_with_pad_matches_jax():
    init = _pad_init(np.random.default_rng(1), n_scans=5)
    _, jb, jg = j_make_model(init)
    _, tb, tg = make_model(init, None, device=CPU)
    idx = np.array([4, 0, 2])
    ref = np.asarray(j_get_measurements(jb, jg, jnp.asarray(idx)))
    ours = np_(get_measurements(tb, tg, torch.from_numpy(idx)))
    assert ours.shape == (3, NPIX, NPIX)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[:, LO:LO + CROP, LO:LO + CROP], init["measurements"][idx])


def test_half_a_pad_pair_is_rejected():
    init = _pad_init(np.random.default_rng(1))
    del init["on_the_fly_meas_padded_idx"]
    with pytest.raises(ValueError, match="both"):
        make_model(init, None, device=CPU)


@pytest.mark.parametrize("inverse", [False, True])
def test_fftn3_matches_jax(inverse):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 12, 16)) + 1j * rng.standard_normal((2, 5, 12, 16)))
    x = x.astype(np.complex64)
    ref = cplx_np(j_fftn3(Cplx(jnp.asarray(x.real), jnp.asarray(x.imag)), inverse=inverse))
    ours = np_(fftn3(torch.from_numpy(x), inverse=inverse))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("obj_type", ["amplitude", "phase"])
@pytest.mark.parametrize("beta,alpha", [(1.0, 1.0), (0.5, 3.0)])
def test_kz_filter_fn_matches_jax(obj_type, beta, alpha):
    rng = np.random.default_rng(3)
    obj = (1.0 + 0.1 * rng.standard_normal((1, NZ, 24, 20))).astype(np.float32)
    ref = np.asarray(JC.kz_filter_fn(jnp.asarray(obj), beta, alpha, obj_type))
    ours = np_(TC.kz_filter_fn(torch.from_numpy(obj), beta, alpha, obj_type))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_fused_loss_terms_declines_at_n256():
    """At N = 256 the loss-folded chain (B3) declines instead of raising;
    the solver then takes forward() through the segmented chain."""
    init = _pad_init(np.random.default_rng(4))
    params, buffers, geom = make_model(init, PSO_PARAMS["model_params"], device=CPU)
    idx = torch.arange(2)
    assert fused_loss_terms(params, buffers, geom, idx, torch.ones(2),
                            PSO_PARAMS["loss_params"]) is None
    dp, _ = forward(params, buffers, geom, idx)
    assert dp.shape == (2, NPIX, NPIX) and bool(torch.isfinite(dp).all())


@pytest.fixture(scope="module")
def pso_dataset():
    """Measurements simulated from a weak phase object on a 2 x 2 scan at
    256^2, cropped to the central 64^2 and normalised to max at one; the
    reconstruction starts from a flat object."""
    rng = np.random.default_rng(7)
    init = toy_init(rng, n_scans=4, npix=NPIX, nz=NZ, pmode=PMODE, canvas=NPIX + 8)
    init.update(crop_pos=np.array([[0, 0], [0, 6], [6, 0], [6, 6]], np.int32),
                N_scan_slow=2, N_scan_fast=2)
    params, buffers, geom = make_model(init, None, device=CPU)
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(4))
    crops = np_(dp)[:, LO:LO + CROP, LO:LO + CROP]
    crops = (crops / crops.max()).astype(np.float32)
    padded, idx = meas_pad_on_the_fly(crops, "power", NPIX, 70)
    init.update(measurements=crops, on_the_fly_meas_padded=padded,
                on_the_fly_meas_padded_idx=idx, obj=np.ones_like(init["obj"]))
    return init


def test_pso_like_trajectory_matches_jax(pso_dataset):
    """Losses per iteration at rtol 1e-4; the objects within 2.5 lr, the
    reasoning of tests/test_torch_solver.py (where a gradient is near zero
    its sign can differ between the two float32 paths)."""
    js = JaxSolver(copy.deepcopy(PSO_PARAMS), init_variables=copy.deepcopy(pso_dataset),
                   verbose=False)
    js.run()
    ts = PtyRADSolver(copy.deepcopy(PSO_PARAMS), init_variables=copy.deepcopy(pso_dataset),
                      device="cpu", verbose=False)
    ts.run()
    np.testing.assert_array_equal(ts.batch_idx, js.batch_idx)
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert len(ours) == len(ref) == 2 and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    np.testing.assert_allclose(np_(ts.params.objp), np.asarray(js.params.objp), atol=2.5 * 5e-4)
    np.testing.assert_allclose(np_(ts.params.obja), np.asarray(js.params.obja), atol=2.5 * 5e-4)


def test_nan_halt_on_the_chain_path(pso_dataset):
    """The solver's loss_fn takes forward() + combined_loss at N = 256; a
    non-finite loss there still halts the run after the iteration that
    produced it, as in the JAX package."""
    init = copy.deepcopy(pso_dataset)
    init["measurements"] = init["measurements"].copy()
    init["measurements"][1, 5, 5] = np.nan
    results = {}
    for name, solver in (("jax", JaxSolver(copy.deepcopy(PSO_PARAMS), init_variables=init,
                                           verbose=False)),
                         ("torch", PtyRADSolver(copy.deepcopy(PSO_PARAMS), init_variables=init,
                                                device="cpu", verbose=False))):
        solver.run()
        results[name] = solver.history
    for history in results.values():
        assert len(history.loss_iters) == 1 and not np.isfinite(history.loss_iters[0][1])
        assert history.iter_times == []
