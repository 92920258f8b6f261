"""The plain fused chain (kernel B4) and the slice it opens: forward() through
``multislice_dp_fused`` at N <= 128 and the low-dose loss mix (loss_poissn +
loss_pacbed) in training, against ptyrad_tpu on the CPU.

- ``multislice_dp_plain`` (what ``multislice_dp_fused`` runs on a CPU tensor)
  against ptyrad_tpu's ``multislice_dp_fused`` in Pallas interpret mode, dp
  and its VJP, for a shared real-space probe, per-position probes, kspace
  spectra, a per-position H and need_dh.
- The port's ``forward()`` against the JAX ``forward()`` with its fused kernel
  in interpret mode (tests/test_forward.py:556), values and gradients, with
  two object modes, detector blur and shifted probes.
- ``loss_fn`` and a 2-iteration solver run with the low-dose loss mix against
  the JAX package, a padded tail batch (mask 0) included.

Tolerances: dp at rtol 1e-5 with an atol of 1e-5 of its largest entry, and
losses at rtol 1e-5 (float32 transforms through torch.fft against DFT
matrix products); gradients at atol 2e-5 of the largest reference entry and
rtol 1e-3 (tests/test_forward.py:356-372); the solver's loss trajectory at
rtol 1e-4, without ortho_pmode, whose eigenvector phases are a free gauge
(tests/test_torch_solver.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.losses import combined_loss as j_combined_loss
from ptyrad_tpu.models import forward as j_forward
from ptyrad_tpu.models import get_measurements as j_get_measurements
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.ops import pallas_multislice as jpm
from ptyrad_tpu_torch.engine.solver import PtyRADSolver, loss_fn
from ptyrad_tpu_torch.models import forward, forward_route, make_model
from ptyrad_tpu_torch.ops import _build
from ptyrad_tpu_torch.ops import fused_multislice as tfm
from torch_port_helpers import CPU, assert_grad_close, cplx_np, np_, toy_init

# demo/scripts/run_parity_midscale.py:252-259 (POISSN_LOSS) plus the tBL
# yml's loss_sparse
LOW_DOSE = {
    "loss_single": {"state": False, "weight": 0.0, "dp_pow": 0.5},
    "loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
    "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2},
    "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1},
}


def close(actual, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=1e-5,
                               atol=1e-5 * float(np.abs(expected).max()))


@pytest.mark.parametrize("nz,pmode,layout", [
    (1, 1, "shared"), (3, 2, "shared"),
    (1, 2, "each"), (3, 1, "each"),
    (1, 1, "each_kspace"), (3, 2, "each_kspace"),
    (3, 2, "shared_kspace"),
    (3, 2, "each_h"),          # per-position H, with its cotangent (need_dh)
])
def test_dp_plain_matches_pallas_interpret(rng, nz, pmode, layout):
    b, n = 4, 16
    kspace = layout.endswith("kspace")
    pb = 1 if layout.startswith("shared") else b
    hb = b if layout == "each_h" else 1
    need_dh = layout == "each_h"
    obja = (1 + 0.05 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    objp = (0.2 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    pr = (rng.standard_normal((pb, pmode, n, n)) / n).astype(np.float32)
    pi = (rng.standard_normal((pb, pmode, n, n)) / n).astype(np.float32)
    h = np.exp(1j * rng.uniform(-np.pi, np.pi, (hb, n, n))).astype(np.complex64)
    g = rng.standard_normal((b, n, n)).astype(np.float32)

    def j_dp(a, p, r, i, hr, hi):
        return jpm.multislice_dp_fused(a, p, r, i, hr, hi, need_dh, kspace)

    jpm.set_interpret(True)
    try:
        j_args = tuple(jnp.asarray(x) for x in (obja, objp, pr, pi, h.real, h.imag))
        j_out, vjp = jax.vjp(j_dp, *j_args)
        j_g = vjp(jnp.asarray(g))
    finally:
        jpm.set_interpret(False)

    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (obja, objp, pr + 1j * pi, h)]
    dp = tfm.multislice_dp_fused(*leaves, need_dh=need_dh, probe_kspace=kspace)
    dp.backward(torch.from_numpy(g))
    assert tuple(dp.shape) == (b, n, n)
    close(np_(dp), j_out)
    assert_grad_close(np_(leaves[0].grad), j_g[0], "obja")
    assert_grad_close(np_(leaves[1].grad), j_g[1], "objp")
    assert_grad_close(np_(leaves[2].grad.real), j_g[2], "probe.re")
    assert_grad_close(np_(leaves[2].grad.imag), j_g[3], "probe.im")
    if need_dh:
        assert_grad_close(np_(leaves[3].grad.real), j_g[4], "h.re")
        assert_grad_close(np_(leaves[3].grad.imag), j_g[5], "h.im")


@pytest.mark.parametrize("omode,shift_probes,blur,occu", [
    (2, True, 0.7, (0.7, 0.3)),
    (1, False, None, (0.8,)),
])
def test_forward_matches_jax_fused(rng, omode, shift_probes, blur, occu):
    """forward() (the fused route, plain version on the CPU) against the JAX
    forward() through its fused kernel in interpret mode: sum(sqrt(dp)) and
    the gradients of every optimized tensor."""
    init = toy_init(rng, n_scans=6, omode=omode, nz=3, pmode=2)
    init["omode_occu"] = np.array(occu, np.float32)
    upd = {}
    if shift_probes:
        init["probe_pos_shifts"] = (0.3 * rng.standard_normal((6, 2))).astype(np.float32)
        upd["probe_pos_shifts"] = {"lr": 1e-4}
    mp = {"update_params": upd, "detector_blur_std": blur}
    jp, jb, jg = j_make_model(init, mp)
    tp, tb, tg = make_model(init, mp, device=CPU)
    idx = np.arange(4)
    assert forward_route(tp, tg, torch.from_numpy(idx)) == "fused"

    def j_loss(p):
        dp, _ = j_forward(p, jb, jg, jnp.asarray(idx))
        return jnp.sum(jnp.sqrt(dp)), dp

    jpm.set_interpret(True)
    try:
        (j_val, j_dp), j_g = jax.value_and_grad(j_loss, has_aux=True)(jp)
    finally:
        jpm.set_interpret(False)

    for _, t in tp.named():
        t.requires_grad_(True)
    dp, _ = forward(tp, tb, tg, torch.from_numpy(idx))
    loss = torch.sqrt(dp).sum()
    loss.backward()
    close(np_(dp), j_dp)
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    assert_grad_close(np_(tp.obja.grad), j_g.obja, "obja")
    assert_grad_close(np_(tp.objp.grad), j_g.objp, "objp")
    assert_grad_close(np_(tp.probe.grad.real), j_g.probe.re, "probe.re")
    assert_grad_close(np_(tp.probe.grad.imag), j_g.probe.im, "probe.im")
    if shift_probes:
        assert_grad_close(np_(tp.probe_pos_shifts.grad), j_g.probe_pos_shifts, "pos")


def test_low_dose_loss_fn_matches_jax(rng):
    """The solver's loss_fn with the low-dose mix (fused_loss_terms declines,
    so forward() + combined_loss) against the JAX forward() +
    combined_loss, with a padded tail sample (mask 0): every term and the
    gradients."""
    init = toy_init(rng, n_scans=6, nz=3, pmode=2)
    init["probe_pos_shifts"] = (0.3 * rng.standard_normal((6, 2))).astype(np.float32)
    mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}}
    jp, jb, jg = j_make_model(init, mp)
    tp, tb, tg = make_model(init, mp, device=CPU)
    idx = np.arange(4)
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

    def j_loss(p):
        dp, (oa, op) = j_forward(p, jb, jg, jnp.asarray(idx))
        meas = j_get_measurements(jb, jg, jnp.asarray(idx))
        return j_combined_loss(dp, meas, oa, op, jb.omode_occu, LOW_DOSE, jnp.asarray(mask))

    (j_total, j_terms), j_g = jax.value_and_grad(j_loss, has_aux=True)(jp)
    for _, t in tp.named():
        t.requires_grad_(True)
    total, terms = loss_fn(tp, tb, tg, torch.from_numpy(idx), torch.from_numpy(mask), LOW_DOSE)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    for k in j_terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(j_terms[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=f"term mismatch: {k}")
    assert float(terms["loss_poissn"].detach()) != 0 and float(terms["loss_pacbed"].detach()) != 0
    assert_grad_close(np_(tp.obja.grad), j_g.obja, "obja")
    assert_grad_close(np_(tp.objp.grad), j_g.objp, "objp")
    assert_grad_close(np_(tp.probe.grad.real), j_g.probe.re, "probe.re")
    assert_grad_close(np_(tp.probe_pos_shifts.grad), j_g.probe_pos_shifts, "pos")


LR = {"obja": 5.0e-4, "objp": 5.0e-4, "probe": 1.0e-4, "probe_pos_shifts": 1.0e-4}


def low_dose_params():
    """tBL's update rates (probe_pos_shifts from iteration 2, so the shifted
    spectrum feeds the chain), the low-dose loss mix, tBL's constraints but
    ortho_pmode; 11 scans in batches of 4, 4 and 3 (a padded tail)."""
    return {
        "model_params": {"optimizer_params": {"name": "Adam"},
                         "update_params": {k: {"start_iter": 2 if k == "probe_pos_shifts" else 1,
                                               "lr": lr} for k, lr in LR.items()}},
        "loss_params": LOW_DOSE,
        "constraint_params": {
            "fix_probe_int": {"freq": 1},
            "obj_rblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5},
            "obj_zblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 1.0},
            "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
            "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
        },
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 3}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


@pytest.fixture(scope="module")
def low_dose_runs():
    """Both solvers from measurements simulated through the port's
    forward() (the fused route), starting from a flat object."""
    rng = np.random.default_rng(11)
    init = toy_init(rng, n_scans=11, npix=16, nz=3, pmode=2, canvas=32)
    params, buffers, geom = make_model(init, None, device=CPU)
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(11))
    init["measurements"] = np_(dp)
    init["obj"] = np.ones_like(init["obj"])
    js = JaxSolver(low_dose_params(), init_variables=copy.deepcopy(init), verbose=False)
    js.run()
    ts = PtyRADSolver(low_dose_params(), init_variables=copy.deepcopy(init), device="cpu",
                      verbose=False)
    ts.run()
    return js, ts


def test_low_dose_solver_trajectory_matches_jax(low_dose_runs):
    js, ts = low_dose_runs
    assert ts.batch_idx.shape == (3, 4) and ts.batch_mask[-1, -1] == 0.0  # padded tail
    np.testing.assert_array_equal(ts.batch_idx, js.batch_idx)
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert len(ours) == len(ref) == 2 and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    for ours_t, ref_t in zip(ts.history.term_iters, js.history.term_iters):
        for k in ("loss_poissn", "loss_pacbed", "loss_sparse"):
            np.testing.assert_allclose(ours_t[k], ref_t[k], rtol=1e-4, err_msg=k)


def test_low_dose_solver_state_matches_jax(low_dose_runs):
    """Final objects, probe and positions within 2.5 lr (a near-zero gradient
    may take opposite signs in the two float32 paths, and Adam then steps
    about lr the other way; tests/test_torch_solver.py)."""
    js, ts = low_dose_runs
    np.testing.assert_allclose(np_(ts.params.objp), np.asarray(js.params.objp),
                               atol=2.5 * LR["objp"])
    np.testing.assert_allclose(np_(ts.params.obja), np.asarray(js.params.obja),
                               atol=2.5 * LR["obja"])
    np.testing.assert_allclose(np_(ts.params.probe), cplx_np(js.params.probe),
                               atol=2.5 * LR["probe"])
    np.testing.assert_allclose(np_(ts.params.probe_pos_shifts),
                               np.asarray(js.params.probe_pos_shifts),
                               atol=2.5 * LR["probe_pos_shifts"])


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """The library's hash covers every file under csrc/, so an edited header
    rebuilds as an edited source does."""
    for name in _build.SOURCES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    base = _build._key()
    (tmp_path / "common.cuh").write_text("// a shared header\n")
    with_header = _build._key()
    (tmp_path / "common.cuh").write_text("// an edited header\n")
    assert len({base, with_header, _build._key()}) == 3
