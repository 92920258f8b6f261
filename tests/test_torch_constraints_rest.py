"""ops/masks.py and the constraints probe_mask_k, kr_filter, complex_ratio
and mirrored_amp, then all twelve together: ptyrad_tpu_torch against
ptyrad_tpu's functions and its ConstraintScheduler on the CPU.

Tolerances: the mask atol 1e-6 (float32 exp in two libraries), the
constraints atol 1e-5 (float32 transforms through dense DFT matrices in the
JAX package against torch.fft, on values of order one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptyrad_tpu.constraints as JC
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.ops import masks as JM
from ptyrad_tpu_torch import constraints as TC
from ptyrad_tpu_torch.models import make_model
from ptyrad_tpu_torch.ops import masks as TM
from torch_port_helpers import CPU, jax_params_numpy, np_, toy_init

ATOL = 1e-5


# -- ops/masks.py -------------------------------------------------------------------

@pytest.mark.parametrize("npix,radius,width,center", [
    (16, 2.0 / 3.0, 0.2, None), (32, 0.22, 0.05, None), (15, 0.5, 0.1, (6.5, 8.0))])
def test_sigmoid_mask_matches_jax(npix, radius, width, center):
    ours = TM.make_sigmoid_mask(npix, radius, width, center)
    ref = np.asarray(JM.make_sigmoid_mask(npix, radius, width, center))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (npix, npix)
    np.testing.assert_allclose(np_(ours), ref, rtol=0, atol=1e-6)
    c = npix // 2 if center is None else None
    if c is not None:
        assert float(ours[c, c]) > 0.99 and float(ours[0, 0]) < 0.01


# -- the four constraints ---------------------------------------------------------------

def _state(rng, pmode=3, tilt_each=False, n_scans=12, **kw):
    """The same model in both packages, with a probe whose modes differ in
    power and an object away from the constraints' fixed points."""
    init = toy_init(rng, n_scans=n_scans, pmode=pmode, **kw)
    init["probe"] = (init["probe"] * np.array([1.0, 0.5, 0.2, 0.1][:pmode],
                                              np.float32)[:, None, None]).astype(np.complex64)
    init["obj"] = ((1.0 + 0.1 * rng.standard_normal(init["obj"].shape))
                   * np.exp(1j * 0.4 * rng.standard_normal(init["obj"].shape))
                   ).astype(np.complex64)
    if tilt_each:
        init.update(obj_tilts=rng.standard_normal((n_scans, 2)).astype(np.float32),
                    N_scan_slow=n_scans // 3, N_scan_fast=3)
    return j_make_model(init), make_model(init, None, device=CPU)


def _assert_params_close(tp, jp, atol=ATOL):
    ref = jax_params_numpy(jp)
    for name, t in tp.named():
        np.testing.assert_allclose(np_(t), ref[name], rtol=0, atol=atol,
                                   err_msg=f"parameter mismatch: {name}")


def _apply_one(name, cfg, rng, **kw):
    (jp, jb, jg), (tp, tb, tg) = _state(rng, **kw)
    before = {n: np_(t).copy() for n, t in tp.named()}
    jp = JC.ConstraintScheduler({name: {"freq": 1, **cfg}}, jg)(jp, jb, 1)
    sched = TC.ConstraintScheduler({name: {"freq": 1, **cfg}}, tg)
    assert sched.active_names == [name]
    assert sched(tp, tb, 1) is tp
    _assert_params_close(tp, jp)
    return before, {n: np_(t) for n, t in tp.named()}


@pytest.mark.parametrize("power_thresh,n_masked", [(0.99, 3), (0.5, 1), (0.95, 2)])
def test_probe_mask_k_matches_jax(power_thresh, n_masked):
    """Mode powers 1 : 0.25 : 0.04 (cumulative fractions 0.775, 0.969, 1):
    mode 0 is always masked, mode i when the modes before it hold at most
    power_thresh. The mask is wide enough to leave the modes' order alone."""
    before, after = _apply_one("probe_mask_k", {"radius": 0.9, "width": 0.05,
                                                "power_thresh": power_thresh},
                               np.random.default_rng(0))
    changed = [not np.allclose(after["probe"][i], before["probe"][i], atol=1e-7)
               for i in range(3)]
    assert changed == [i < n_masked for i in range(3)]
    np.testing.assert_array_equal(after["obja"], before["obja"])


@pytest.mark.parametrize("obj_type", ["both", "amplitude", "phase"])
@pytest.mark.parametrize("canvas", [(32, 32), (32, 40)], ids=["square", "rectangular"])
def test_kr_filter_matches_jax(obj_type, canvas):
    rng = np.random.default_rng(1)
    obj = (1.0 + 0.1 * rng.standard_normal((2, 3, *canvas))).astype(np.float32)
    ref = np.asarray(JC.kr_filter_fn(jnp.asarray(obj), 0.3, 0.08))
    ours = TC.kr_filter_fn(torch.from_numpy(obj), 0.3, 0.08)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(np_(ours), ref, rtol=0, atol=ATOL)
    before, after = _apply_one("kr_filter", {"obj_type": obj_type, "radius": 0.3, "width": 0.08},
                               np.random.default_rng(2))
    assert np.array_equal(after["obja"], before["obja"]) == (obj_type == "phase")
    assert np.array_equal(after["objp"], before["objp"]) == (obj_type == "amplitude")


@pytest.mark.parametrize("obj_type", ["both", "amplitude", "phase"])
@pytest.mark.parametrize("alpha1,alpha2", [(1.0, 0.0), (0.3, 0.6)])
def test_complex_ratio_matches_jax(obj_type, alpha1, alpha2):
    rng = np.random.default_rng(3)
    obja = rng.uniform(0.8, 1.0, (1, 3, 8, 8)).astype(np.float32)
    objp = rng.uniform(-0.1, 0.5, (1, 3, 8, 8)).astype(np.float32)
    refs = JC.complex_ratio_fn(jnp.asarray(obja), jnp.asarray(objp), alpha1, alpha2)
    ours = TC.complex_ratio_fn(torch.from_numpy(obja), torch.from_numpy(objp), alpha1, alpha2)
    for x, y in zip(ours, refs):
        np.testing.assert_allclose(np_(x), np.asarray(y), rtol=1e-5, atol=ATOL)
    before, after = _apply_one("complex_ratio", {"obj_type": obj_type, "alpha1": alpha1,
                                                 "alpha2": alpha2}, np.random.default_rng(4))
    assert np.array_equal(after["obja"], before["obja"]) == (obj_type == "phase")
    # alpha2 = 0 leaves the phase as it is
    assert np.array_equal(after["objp"], before["objp"]) == (obj_type == "amplitude"
                                                             or alpha2 == 0.0)


@pytest.mark.parametrize("cfg", [{}, {"relax": 0.0, "scale": 0.1, "power": 2.0},
                                 {"relax": 1.0}])
def test_mirrored_amp_matches_jax(cfg):
    before, after = _apply_one("mirrored_amp", cfg, np.random.default_rng(5))
    np.testing.assert_array_equal(after["objp"], before["objp"])
    if cfg.get("relax") == 1.0:
        np.testing.assert_allclose(after["obja"], before["obja"], rtol=0, atol=1e-7)
    else:
        assert not np.allclose(after["obja"], before["obja"], atol=1e-4)


# -- all twelve, in the scheduler's order -------------------------------------------------

ALL_TWELVE = {
    "ortho_pmode": {"freq": 1},
    "probe_mask_k": {"freq": 1, "radius": 0.6, "width": 0.1, "power_thresh": 0.95},
    "fix_probe_int": {"freq": 1},
    "obj_rblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5},
    "obj_zblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 1.0},
    "kr_filter": {"freq": 1, "obj_type": "both", "radius": 0.4, "width": 0.1},
    "kz_filter": {"freq": 1, "obj_type": "both", "beta": 1.0, "alpha": 1.0},
    "complex_ratio": {"freq": 1, "obj_type": "both", "alpha1": 0.5, "alpha2": 0.1},
    "mirrored_amp": {"freq": 1, "relax": 0.1, "scale": 0.03, "power": 4.0},
    "obja_thresh": {"freq": 1, "relax": 0.0, "thresh": [0.9, 1.1]},
    "objp_postiv": {"freq": 1, "relax": 0.0, "mode": "clip_neg"},
    "tilt_smooth": {"freq": 1, "std": 1.0},
}


def _probe_close_up_to_mode_phase(ours, ref, atol):
    """ortho_pmode leaves each mode's global phase free (the eigenvectors'
    gauge), so modes are compared after aligning that phase."""
    for i, (a, b) in enumerate(zip(ours, ref)):
        phase = np.vdot(a, b)
        phase /= abs(phase)
        np.testing.assert_allclose(a * phase, b, rtol=0, atol=atol, err_msg=f"probe mode {i}")


def test_all_twelve_constraints_match_jax():
    (jp, jb, jg), (tp, tb, tg) = _state(np.random.default_rng(6), tilt_each=True, nz=5)
    j_sched = JC.ConstraintScheduler(ALL_TWELVE, jg)
    t_sched = TC.ConstraintScheduler(ALL_TWELVE, tg)
    assert t_sched.active_names == j_sched.active_names == list(TC._ORDER) and len(TC._ORDER) == 12
    jp = j_sched(jp, jb, 1)
    t_sched(tp, tb, 1)
    ref = jax_params_numpy(jp)
    for name, t in tp.named():
        assert bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all()), name
        if name == "probe":
            _probe_close_up_to_mode_phase(np_(t), ref[name], ATOL)
        else:
            np.testing.assert_allclose(np_(t), ref[name], rtol=0, atol=ATOL,
                                       err_msg=f"parameter mismatch: {name}")


def test_mixed_frequencies_gate_like_jax():
    """probe_mask_k every iteration, kr_filter every 2nd, mirrored_amp every
    3rd, over three iterations."""
    cfg = {"probe_mask_k": {"freq": 1, "radius": 0.6, "width": 0.1},
           "kr_filter": {"freq": 2, "radius": 0.4, "width": 0.1},
           "mirrored_amp": {"freq": 3}}
    (jp, jb, jg), (tp, tb, tg) = _state(np.random.default_rng(7))
    j_sched, t_sched = JC.ConstraintScheduler(cfg, jg), TC.ConstraintScheduler(cfg, tg)
    for niter in (1, 2, 3):
        jp = j_sched(jp, jb, niter)
        t_sched(tp, tb, niter)
        _assert_params_close(tp, jp)
