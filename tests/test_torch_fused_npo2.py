"""The fused chain (B3/B4) at N that is not a power of two, against
ptyrad_tpu on the CPU.

On a CUDA tensor the port runs the mixed-radix pair of csrc/reg_fft.cuh at
these N, and at 124 and 127 (a prime factor above 7) its Bluestein line (the
plans are tests/test_torch_fused_plan.py's); on the CPU the same entry
points run their plain versions, which are held here against the JAX
package's kernels at N = 96, 100, 120, 124 and 127:

- ``multislice_dp_fused`` against ptyrad_tpu's ``multislice_dp_fused`` in
  Pallas interpret mode (as tests/test_forward.py:276 runs it): dp and its
  VJP, dH included, for a shared real-space probe, per-position spectra and
  a per-position H with need_dh;
- ``multislice_loss_sums_fused`` against ptyrad_tpu's
  ``multislice_loss_sums_fused`` in interpret mode: s1, s2 and every
  cotangent, dH included;
- ``forward_route`` takes the fused route at these N, and a 2-iteration
  solver run at N = 120 (64 positions, 3 slices, 2 modes, the fused route's
  plain versions) against the JAX solver's loss trajectory at rtol 1e-4.

Tolerances are those of tests/test_torch_fused_dp.py and
tests/test_torch_fused_loss.py: dp at rtol 1e-5 with an atol of 1e-5 of its
largest entry, s1/s2 at rtol 1e-5, gradients at atol 2e-5 of the largest
reference entry and rtol 1e-3 (float32 transforms through torch.fft against
DFT matrix products).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.ops import pallas_multislice as jpm
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.models import forward_route, make_model
from ptyrad_tpu_torch.ops import fused_multislice as tfm
from torch_port_helpers import CPU, assert_grad_close, np_, toy_init

NS = [96, 100, 120, 124, 127]


def close(actual, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=1e-5,
                               atol=1e-5 * float(np.abs(expected).max()))


def _inputs(rng, n, nz, pmode, layout, b=4):
    """obja, objp, probe (re, im), h and need_dh of a layout: "shared" (a
    real-space probe, one H), "each_kspace" (per-position spectra) or
    "each_h" (per-position real-space probes and H, with dH)."""
    kspace = layout.endswith("kspace")
    pb = 1 if layout == "shared" else b
    hb = b if layout == "each_h" else 1
    obja = (1 + 0.05 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    objp = (0.2 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    pr = (rng.standard_normal((pb, pmode, n, n)) / n).astype(np.float32)
    pi = (rng.standard_normal((pb, pmode, n, n)) / n).astype(np.float32)
    h = np.exp(1j * rng.uniform(-np.pi, np.pi, (hb, n, n))).astype(np.complex64)
    return obja, objp, pr, pi, h, layout == "each_h", kspace


LAYOUTS = [(3, 2, "shared"), (2, 2, "each_kspace"), (3, 2, "each_h")]


@pytest.mark.parametrize("nz,pmode,layout", LAYOUTS)
@pytest.mark.parametrize("n", NS)
def test_dp_matches_pallas_interpret(n, nz, pmode, layout):
    rng = np.random.default_rng(n + nz)
    obja, objp, pr, pi, h, need_dh, kspace = _inputs(rng, n, nz, pmode, layout)
    g = rng.standard_normal((obja.shape[0], n, n)).astype(np.float32)

    def j_dp(a, p, r, i, hr, hi):
        return jpm.multislice_dp_fused(a, p, r, i, hr, hi, need_dh, kspace)

    jpm.set_interpret(True)
    try:
        j_args = tuple(jnp.asarray(x) for x in (obja, objp, pr, pi, h.real, h.imag))
        j_out, vjp = jax.vjp(j_dp, *j_args)
        j_g = vjp(jnp.asarray(g))
    finally:
        jpm.set_interpret(False)

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (obja, objp, pr + 1j * pi)]
    leaves.append(torch.from_numpy(h).requires_grad_(need_dh))
    dp = tfm.multislice_dp_fused(*leaves, probe_kspace=kspace)
    dp.backward(torch.from_numpy(g))
    assert tuple(dp.shape) == (obja.shape[0], n, n)
    close(np_(dp), j_out)
    assert_grad_close(np_(leaves[0].grad), j_g[0], "obja")
    assert_grad_close(np_(leaves[1].grad), j_g[1], "objp")
    assert_grad_close(np_(leaves[2].grad.real), j_g[2], "probe.re")
    assert_grad_close(np_(leaves[2].grad.imag), j_g[3], "probe.im")
    if need_dh:
        assert_grad_close(np_(leaves[3].grad.real), j_g[4], "h.re")
        assert_grad_close(np_(leaves[3].grad.imag), j_g[5], "h.im")


@pytest.mark.parametrize("nz,pmode,layout", LAYOUTS)
@pytest.mark.parametrize("n", NS)
def test_loss_sums_match_pallas_interpret(n, nz, pmode, layout):
    rng = np.random.default_rng(2 * n + nz)
    obja, objp, pr, pi, h, need_dh, kspace = _inputs(rng, n, nz, pmode, layout)
    b = obja.shape[0]
    meas = (np.abs(rng.standard_normal((b, n, n))) * 4.0 / (n * n)).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-1] = 0.0
    mask_pad = jnp.zeros((b, 8, 128), jnp.float32).at[:, 0, 0].set(jnp.asarray(mask))

    def j_s(a, p, r, i, hr, hi):
        return jpm.multislice_loss_sums_fused(a, p, r, i, hr, hi, jnp.asarray(meas), mask_pad,
                                              0.5, 1e-10, need_dh, kspace)

    jpm.set_interpret(True)
    try:
        j_args = tuple(jnp.asarray(x) for x in (obja, objp, pr, pi, h.real, h.imag))
        j_s1, j_s2 = j_s(*j_args)
        j_g = jax.grad(lambda *a: j_s(*a)[0], argnums=tuple(range(6)))(*j_args)
    finally:
        jpm.set_interpret(False)

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (obja, objp, pr + 1j * pi)]
    leaves.append(torch.from_numpy(h).requires_grad_(need_dh))
    s1, s2 = tfm.multislice_loss_sums_fused(*leaves, torch.from_numpy(meas),
                                            torch.from_numpy(mask), 0.5, 1e-10,
                                            probe_kspace=kspace)
    s1.backward()
    np.testing.assert_allclose(float(s1.detach()), float(j_s1), rtol=1e-5)
    np.testing.assert_allclose(float(s2), float(j_s2), rtol=1e-5)
    assert_grad_close(np_(leaves[0].grad), j_g[0], "obja")
    assert_grad_close(np_(leaves[1].grad), j_g[1], "objp")
    assert_grad_close(np_(leaves[2].grad.real), j_g[2], "probe.re")
    assert_grad_close(np_(leaves[2].grad.imag), j_g[3], "probe.im")
    if need_dh:
        assert_grad_close(np_(leaves[3].grad.real), j_g[4], "h.re")
        assert_grad_close(np_(leaves[3].grad.imag), j_g[5], "h.im")


@pytest.mark.parametrize("n", NS)
def test_fused_route_takes_every_n(n):
    """The fused rule takes these N (square, up to 128) on any device: a
    meta model stands for a CUDA one."""
    from ptyrad_tpu_torch.models.state import Geometry, PtychoParams

    meta = torch.empty((2, 8, 8), device="meta")
    params = PtychoParams(meta, meta, meta, meta, meta, meta)
    geom = Geometry(probe_shape=(n, n), obj_shape=(1, 3, 300, 300), n_scan_slow=4,
                    n_scan_fast=1, dx=0.1, lambd=0.02)
    assert forward_route(params, geom, torch.arange(4, device="meta")) == "fused"
    assert tfm.fused_applicable_shapes(4, 1, 3, n, n, 4, 2, 4)


def _solver_params():
    update = {name: {"start_iter": 1, "lr": lr} for name, lr in
              (("obja", 5e-4), ("objp", 5e-4), ("probe", 1e-4))}
    return {
        "model_params": {"optimizer_params": {"name": "Adam"}, "update_params": update},
        "loss_params": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}},
        "constraint_params": {"obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 16}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


def test_solver_at_n120_matches_jax():
    """A 2-iteration run at N = 120 (64 positions in batches of 16, 3 slices,
    2 probe modes): every step through the fused route (B3's plain version
    on the CPU), the loss trajectory against the JAX solver's at rtol 1e-4."""
    init = toy_init(np.random.default_rng(120), n_scans=64, npix=120, nz=3, pmode=2,
                    canvas=136)
    params, _, geom = make_model(init, None, device=CPU)
    assert forward_route(params, geom, torch.arange(16)) == "fused"
    js = JaxSolver(_solver_params(), init_variables=copy.deepcopy(init), verbose=False)
    js.run()
    ts = PtyRADSolver(_solver_params(), init_variables=copy.deepcopy(init), device="cpu",
                      verbose=False)
    ts.run()
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert len(ours) == len(ref) == 2 and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
