"""ptyrad_tpu_torch model state, forward model, losses and constraints
against ptyrad_tpu on the CPU.

State built from one init dict is identical in both packages (exact).
Computed quantities are float32 through different kernels (torch.fft vs DFT
matrix products, conv1d vs lax convolutions): rtol 1e-5 with an atol of 1e-5
of the largest magnitude; gradients as in tests/test_forward.py:356-372.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptyrad_tpu.constraints as JC
from ptyrad_tpu.losses import combined_loss as j_combined_loss
from ptyrad_tpu.models import compute_propagators as j_compute_propagators
from ptyrad_tpu.models import forward as j_forward
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.models import multislice_dp as j_multislice_dp
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu_torch import constraints as TC
from ptyrad_tpu_torch.losses import combined_loss, merge_loss_params
from ptyrad_tpu_torch.models import (compute_propagators, forward, forward_route, make_model,
                                     multislice_dp, params_from_numpy)
from ptyrad_tpu_torch.models.state import Geometry, PtychoParams
from torch_port_helpers import CPU, assert_grad_close, cplx_np, jax_params_numpy, np_, toy_init


def close(actual, expected, rtol=1e-5):
    expected = np.asarray(expected)
    atol = 1e-5 * max(float(np.abs(expected).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=rtol, atol=atol)


def test_make_model_and_params_from_numpy_round_trip(rng):
    init = toy_init(rng, omode=2)
    mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}, "obj_preblur_std": 0.5}
    jp, jb, jg = j_make_model(init, mp)
    tp, tb, tg = make_model(init, mp, device=CPU)
    carried = params_from_numpy(jax_params_numpy(jp), device=CPU)
    for name, t in tp.named():
        np.testing.assert_array_equal(np_(t), np_(getattr(carried, name)), err_msg=name)
    np.testing.assert_array_equal(np_(tp.obja), np.asarray(jp.obja))
    np.testing.assert_array_equal(np_(tp.probe), cplx_np(jp.probe))
    np.testing.assert_array_equal(np_(tb.H), cplx_np(jb.H))
    for name in ("measurements", "crop_pos", "omode_occu", "Ky", "Kx", "Kz", "probe_int_sum"):
        np.testing.assert_array_equal(np_(getattr(tb, name)), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    for f in dataclasses.fields(tg):
        assert getattr(tg, f.name) == getattr(jg, f.name), f.name


@pytest.mark.parametrize("change_thickness,tilts", [
    (False, None), (True, None), (False, "global"), (True, "each")])
def test_compute_propagators_four_cases(rng, change_thickness, tilts):
    n_scans = 6
    init = toy_init(rng, n_scans=n_scans)
    upd = {}
    if change_thickness:
        upd["slice_thickness"] = {"lr": 1e-3}
    if tilts == "global":
        init["obj_tilts"] = np.array([[1.5, -2.0]], np.float32)
    elif tilts == "each":
        init["obj_tilts"] = rng.standard_normal((n_scans, 2)).astype(np.float32)
        upd["obj_tilts"] = {"lr": 1e-3}
    jp, jb, jg = j_make_model(init, {"update_params": upd})
    tp, tb, tg = make_model(init, {"update_params": upd}, device=CPU)
    idx = np.array([0, 3, 5])
    ref = j_compute_propagators(jp, jb, jg, jnp.asarray(idx))
    out = compute_propagators(tp, tb, tg, torch.from_numpy(idx))
    assert tuple(out.shape) == tuple(ref.shape)
    close(np_(out), cplx_np(ref))


def test_multislice_dp_matches_jax(rng):
    b, omode, nz, n, pmode = 3, 2, 3, 16, 2
    obja = (1 + 0.05 * rng.standard_normal((b, omode, nz, n, n))).astype(np.float32)
    objp = (0.1 * rng.standard_normal((b, omode, nz, n, n))).astype(np.float32)
    probes = (rng.standard_normal((b, pmode, n, n))
              + 1j * rng.standard_normal((b, pmode, n, n))).astype(np.complex64)
    h = np.exp(1j * rng.uniform(-1, 1, (b, n, n))).astype(np.complex64)
    occu = np.array([0.7, 0.3], np.float32)
    ref = j_multislice_dp(jnp.asarray(obja), jnp.asarray(objp),
                          Cplx(jnp.asarray(probes.real), jnp.asarray(probes.imag)),
                          Cplx(jnp.asarray(h.real), jnp.asarray(h.imag)), jnp.asarray(occu))
    out = multislice_dp(*(torch.from_numpy(x) for x in (obja, objp, probes, h, occu)))
    close(np_(out), ref)


def test_forward_and_gradients_match_jax(rng):
    """forward() on the CPU (multislice_dp with shifted probes, two object
    modes, detector blur) and its gradients."""
    init = toy_init(rng, n_scans=6, omode=2)
    init["probe_pos_shifts"] = (0.3 * rng.standard_normal((6, 2))).astype(np.float32)
    mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}, "detector_blur_std": 0.7}
    jp, jb, jg = j_make_model(init, mp)
    tp, tb, tg = make_model(init, mp, device=CPU)
    idx = np.arange(4)
    j_dp, j_g = jax.value_and_grad(
        lambda p: jnp.sum(jnp.sqrt(j_forward(p, jb, jg, jnp.asarray(idx))[0])))(jp)
    for _, t in tp.named():
        t.requires_grad_(True)
    dp, _ = forward(tp, tb, tg, torch.from_numpy(idx))
    torch.sqrt(dp).sum().backward()
    close(float(torch.sqrt(dp).sum().detach()), float(j_dp))
    assert_grad_close(np_(tp.obja.grad), j_g.obja, "obja")
    assert_grad_close(np_(tp.objp.grad), j_g.objp, "objp")
    assert_grad_close(np_(tp.probe.grad.real), j_g.probe.re, "probe.re")
    assert_grad_close(np_(tp.probe_pos_shifts.grad), j_g.probe_pos_shifts, "pos")


def test_forward_raises_off_the_cpu():
    """Outside the CPU, forward() takes the fused kernels (B4) at their shapes
    (N = 8 here) and the chain kernels at theirs (N = 256); at shapes neither
    rule takes (N = 96) it has no kernel and raises before any work."""
    meta = torch.empty((1, 2, 8, 8), device="meta")
    params = PtychoParams(meta, meta, meta, meta, meta, meta)
    idx = torch.arange(3, device="meta")

    def geom(n):
        return Geometry(probe_shape=(n, n), obj_shape=(1, 2, 200, 200), n_scan_slow=3,
                        n_scan_fast=1, dx=0.1, lambd=0.02)

    assert forward_route(params, geom(8), idx) == "fused"
    assert forward_route(params, geom(256), idx) == "chain"
    with pytest.raises(NotImplementedError, match="neither"):
        forward(params, None, geom(96), idx)


LOSS_ALL = {
    "loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
    "loss_poissn": {"state": True, "weight": 0.7, "dp_pow": 1.0, "eps": 1e-6},
    "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2},
    "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1},
    "loss_simlar": {"state": True, "weight": 0.1, "obj_type": "both", "blur_std": 1.0,
                    "scale_factor": [0.5, 0.5]},
}


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_combined_loss(rng, masked):
    b, omode, nz, n = 4, 2, 3, 16
    dp = np.abs(rng.standard_normal((b, n, n))).astype(np.float32) + 0.1
    meas = np.abs(rng.standard_normal((b, n, n))).astype(np.float32) + 0.1
    oa = (1 + 0.05 * rng.standard_normal((b, omode, nz, n, n))).astype(np.float32)
    op = (0.1 * rng.standard_normal((b, omode, nz, n, n))).astype(np.float32)
    occu = np.array([0.6, 0.4], np.float32)
    mask = np.array([1, 1, 1, 0], np.float32) if masked else None
    j_total, j_terms = j_combined_loss(*(jnp.asarray(x) for x in (dp, meas, oa, op, occu)),
                                       LOSS_ALL, None if mask is None else jnp.asarray(mask))
    t_total, t_terms = combined_loss(*(torch.from_numpy(x) for x in (dp, meas, oa, op, occu)),
                                     LOSS_ALL, None if mask is None else torch.from_numpy(mask))
    close(float(t_total), float(j_total))
    for k in j_terms:
        close(float(t_terms[k]), float(j_terms[k]))


def test_merge_loss_params_rejects_unknown_terms():
    with pytest.raises(ValueError, match="loss_sparce"):
        merge_loss_params({"loss_sparce": {"state": True}})


def _constraint_state(rng, pmode=3):
    init = toy_init(rng, pmode=pmode, nz=4)
    jp, jb, jg = j_make_model(init)
    tp, tb, tg = make_model(init, None, device=CPU)
    return (jp, jb, jg), (tp, tb, tg)


@pytest.mark.parametrize("name,cfg", [
    ("fix_probe_int", {"freq": 1}),
    ("obj_rblur", {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5}),
    ("obj_zblur", {"freq": 1, "obj_type": "phase", "kernel_size": 5, "std": 1.0}),
    ("obja_thresh", {"freq": 1, "relax": 0.3, "thresh": [0.98, 1.02]}),
    ("objp_postiv", {"freq": 1, "relax": 0.0, "mode": "clip_neg"}),
    ("objp_postiv", {"freq": 1, "relax": 0.2, "mode": "subtract_min"}),
])
def test_constraints_match_scheduler(rng, name, cfg):
    (jp, jb, jg), (tp, tb, tg) = _constraint_state(rng)
    tp.probe.mul_(1.3)  # so fix_probe_int has something to undo
    jp = dataclasses.replace(jp, probe=jp.probe * 1.3)
    j_out = JC.ConstraintScheduler({name: cfg}, jg)(jp, jb, 1)
    TC.ConstraintScheduler({name: cfg})(tp, tb, 1)
    close(np_(tp.obja), j_out.obja)
    close(np_(tp.objp), j_out.objp)
    close(np_(tp.probe), cplx_np(j_out.probe))


def test_ortho_pmode_gauge_invariant(rng):
    """Each eigenvector's phase is a free gauge (any eigh picks its own), so
    compare what it does not change, as tests/test_reference_parity.py:466
    does: each sorted mode's intensity map, the mixed-state density sum, and
    the orthogonality of the result."""
    (jp, jb, jg), (tp, tb, tg) = _constraint_state(rng, pmode=4)
    j_out = JC.ConstraintScheduler({"ortho_pmode": {"freq": 1}}, jg)(jp, jb, 1)
    TC.ConstraintScheduler({"ortho_pmode": {"freq": 1}})(tp, tb, 1)
    ours, ref = np_(tp.probe), cplx_np(j_out.probe)
    close(np.abs(ours) ** 2, np.abs(ref) ** 2, rtol=1e-4)
    flat = ours.reshape(4, -1)
    gram = flat @ flat.conj().T
    off = gram - np.diag(np.diag(gram))
    assert np.abs(off).max() < 1e-4 * np.abs(np.diag(gram)).max()


def test_scheduler_gating_and_strict_config(rng):
    _, (tp, tb, tg) = _constraint_state(rng)
    sched = TC.ConstraintScheduler(
        {"obja_thresh": {"freq": 2, "relax": 0.0, "thresh": [0.99, 1.01]},
         "objp_postiv": {"freq": 1}})
    assert sched.active_names == ["obja_thresh", "objp_postiv"]
    before = np_(tp.obja).copy()
    sched(tp, tb, 1)  # obja_thresh not due at iteration 1
    np.testing.assert_array_equal(np_(tp.obja), before)
    assert np_(tp.objp).min() >= 0
    sched(tp, tb, 2)
    assert np_(tp.obja).max() <= 1.01 + 1e-7
    with pytest.raises(ValueError, match="Unknown constraint"):
        TC.ConstraintScheduler({"ortho_pmod": {"freq": 1}})
    with pytest.raises(ValueError, match="Unknown option"):
        TC.ConstraintScheduler({"obj_rblur": {"freq": 1, "sdt": 1.0}})
    with pytest.raises(ValueError, match="freq"):
        TC.ConstraintScheduler({"obj_rblur": {"freq": 0}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TC.ConstraintScheduler({"kr_filter": {"freq": 1}})


@pytest.mark.parametrize("extra_init,model_params", [
    ({"on_the_fly_meas_padded": np.zeros((20, 20), np.float32),
      "on_the_fly_meas_padded_idx": (2, 18, 2, 18),
      "on_the_fly_meas_scale_factors": (1.25, 1.25)}, None),  # a pad is ported, a resample not
    ({"on_the_fly_meas_scale_factors": (0.5, 0.5)}, None),
    ({}, {"compute_dtype": "bfloat16"}),
])
def test_unported_model_options_raise(rng, extra_init, model_params):
    """Options of later slices raise at make_model instead of being ignored."""
    init = {**toy_init(rng), **extra_init}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_model(init, model_params, device=CPU)
