"""The loss-folded chain (B3): the port's fused_loss_terms, whose
multislice_loss_sums_fused runs its plain torch.fft version on the CPU,
against ptyrad_tpu's forward() + combined_loss (the XLA reference that
tests/test_forward.py:310-372 holds equal to the Pallas kernel), and one
direct check against the Pallas kernel in interpret mode.

Tolerances (those of tests/test_forward.py:356-372): loss and every term at
rtol 1e-5; gradients at atol 2e-5 of the largest reference entry and rtol
1e-3, since the transforms are float32 through two FFT implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.losses import combined_loss as j_combined_loss
from ptyrad_tpu.models import forward as j_forward
from ptyrad_tpu.models import get_measurements as j_get_measurements
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.ops import pallas_multislice as jpm
from ptyrad_tpu_torch.models import fused_loss_terms, make_model
from ptyrad_tpu_torch.ops import fused_multislice as tfm
from torch_port_helpers import CPU, assert_grad_close, np_, toy_init

LOSS_SINGLE = {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}}
LOSS_WITH_SPARSE = {**LOSS_SINGLE, "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}}


@pytest.mark.parametrize("shift_probes,loss_params,occu", [
    (False, LOSS_SINGLE, 1.0),
    (True, LOSS_WITH_SPARSE, 1.0),
    (False, LOSS_WITH_SPARSE, 0.8),   # omode_occu != 1 folds into the probe as sqrt
    (True, LOSS_SINGLE, 0.6),
])
def test_fused_loss_terms_match_jax(rng, shift_probes, loss_params, occu):
    init = toy_init(rng, n_scans=6, npix=16, nz=3, pmode=2)
    init["omode_occu"] = np.array([occu], np.float32)
    model_params = None
    if shift_probes:
        init["probe_pos_shifts"] = (0.3 * rng.standard_normal((6, 2))).astype(np.float32)
        model_params = {"update_params": {"probe_pos_shifts": {"lr": 1e-4, "start_iter": 1}}}
    jp, jb, jg = j_make_model(init, model_params)
    tp, tb, tg = make_model(init, model_params, device=CPU)
    assert jg.shift_probes == tg.shift_probes == shift_probes
    idx = np.arange(4)
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)  # a padded tail sample

    def j_loss(p):
        dp, (oa, op) = j_forward(p, jb, jg, jnp.asarray(idx))
        meas = j_get_measurements(jb, jg, jnp.asarray(idx))
        return j_combined_loss(dp, meas, oa, op, jb.omode_occu, loss_params, jnp.asarray(mask))

    (j_total, j_terms), j_grads = jax.value_and_grad(j_loss, has_aux=True)(jp)

    for _, t in tp.named():
        t.requires_grad_(True)
    out = fused_loss_terms(tp, tb, tg, torch.from_numpy(idx), torch.from_numpy(mask), loss_params)
    assert out is not None, "the loss-folded path declined an in-regime configuration"
    t_total, t_terms = out
    t_total.backward()

    np.testing.assert_allclose(float(t_total.detach()), float(j_total), rtol=1e-5)
    for k in j_terms:
        np.testing.assert_allclose(float(t_terms[k].detach()), float(j_terms[k]), rtol=1e-5,
                                   atol=1e-8,
                                   err_msg=f"term mismatch: {k}")
    assert_grad_close(np_(tp.obja.grad), j_grads.obja, "obja")
    assert_grad_close(np_(tp.objp.grad), j_grads.objp, "objp")
    assert_grad_close(np_(tp.probe.grad.real), j_grads.probe.re, "probe.re")
    assert_grad_close(np_(tp.probe.grad.imag), j_grads.probe.im, "probe.im")
    if shift_probes:
        assert_grad_close(np_(tp.probe_pos_shifts.grad), j_grads.probe_pos_shifts, "pos")


def test_out_of_regime_declines(rng):
    """Another dp term, detector blur or omode > 1 leave the fold (the caller
    then takes forward() + combined_loss)."""
    init = toy_init(rng, n_scans=4)
    tp, tb, tg = make_model(init, None, device=CPU)
    idx = torch.arange(4)
    assert fused_loss_terms(tp, tb, tg, idx, None,
                            {**LOSS_SINGLE, "loss_pacbed": {"state": True}}) is None
    _, tb2, tg2 = make_model(init, {"detector_blur_std": 1.0}, device=CPU)
    assert fused_loss_terms(tp, tb2, tg2, idx, None, LOSS_SINGLE) is None
    init2 = toy_init(rng, n_scans=4, omode=2)
    tp3, tb3, tg3 = make_model(init2, None, device=CPU)
    assert fused_loss_terms(tp3, tb3, tg3, idx, None, LOSS_SINGLE) is None


@pytest.mark.parametrize("kspace", [True, False])
def test_loss_sums_match_pallas_interpret(rng, kspace):
    """multislice_loss_sums_fused (plain version) against the Pallas kernel
    pair in interpret mode at the smallest shapes that exercise it: sums at
    rtol 1e-5, cotangents of obja, objp and the probe as above."""
    b, nz, n, pmode = 2, 2, 16, 2
    pb = b if kspace else 1
    obja = (1 + 0.05 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    objp = (0.1 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    pr = rng.standard_normal((pb, pmode, n, n)).astype(np.float32)
    pi = rng.standard_normal((pb, pmode, n, n)).astype(np.float32)
    h = np.exp(1j * rng.uniform(-np.pi, np.pi, (1, n, n))).astype(np.complex64)
    meas = np.abs(rng.standard_normal((b, n, n))).astype(np.float32) * 4.0
    mask = np.array([1.0, 0.0], np.float32)
    mask_pad = jnp.zeros((b, 8, 128), jnp.float32).at[:, 0, 0].set(jnp.asarray(mask))

    def j_s(a, p, r, i):
        return jpm.multislice_loss_sums_fused(
            a, p, r, i, jnp.asarray(h.real), jnp.asarray(h.imag), jnp.asarray(meas), mask_pad,
            0.5, 1e-10, False, kspace)

    jpm.set_interpret(True)
    try:
        j_args = tuple(jnp.asarray(x) for x in (obja, objp, pr, pi))
        j_s1, j_s2 = j_s(*j_args)
        j_g = jax.grad(lambda *a: j_s(*a)[0], argnums=(0, 1, 2, 3))(*j_args)
    finally:
        jpm.set_interpret(False)

    ta = torch.from_numpy(obja).requires_grad_(True)
    tpp = torch.from_numpy(objp).requires_grad_(True)
    tpr = torch.from_numpy(pr + 1j * pi).requires_grad_(True)
    s1, s2 = tfm.multislice_loss_sums_fused(ta, tpp, tpr, torch.from_numpy(h),
                                            torch.from_numpy(meas), torch.from_numpy(mask),
                                            0.5, 1e-10, need_dh=False, probe_kspace=kspace)
    s1.backward()
    np.testing.assert_allclose(float(s1.detach()), float(j_s1), rtol=1e-5)
    np.testing.assert_allclose(float(s2), float(j_s2), rtol=1e-5)
    assert_grad_close(np_(ta.grad), j_g[0], "obja")
    assert_grad_close(np_(tpp.grad), j_g[1], "objp")
    assert_grad_close(np_(tpr.grad.real), j_g[2], "probe.re")
    assert_grad_close(np_(tpr.grad.imag), j_g[3], "probe.im")
