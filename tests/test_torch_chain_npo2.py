"""The segmented chain (B5/B6) at N in (128, 512] that is not a power of
two, against ptyrad_tpu on the CPU.

On a CUDA tensor the port runs chain.cu's mixed-radix build at these N
(its plan is tests/test_torch_chain_mixed_plan.py's); on the CPU the same
entry points run their plain versions, which are held here against the JAX
package's chain kernels in Pallas interpret mode (the ``interpret`` fixture
of tests/test_torch_chain.py) at N = 136 (8 x 17: a Bluestein line over
280 points in the port's plan), 135 (odd, 3^3 5), 192 (PSO padded to
192^2) and 254 (2 x 127, PSO padded to 254^2: a Bluestein line over 512
points). The JAX chain's DFT is a dense matrix product at these N (no
radix pass), so both take H in natural order. Small shapes: B = 2, 2 probe
modes, 3 to 5 slices with Sg = 2.

- ``chain_segment`` (last both ways) and ``chain_stack`` (last_mega both
  ways) with every cotangent and dH, on a shared and a per-position H;
- ``chain_segment`` with the far-field exit, and its cotangents and dH;
- ``multislice_dp_chain`` with the exit off and on, with dH: B6 over 4
  slices and B5 over a 1-slice tail. The JAX chain takes every case here
  (``pch.chain_applicable_shapes``); a case it declined would be held
  against the JAX package's XLA ``multislice_dp`` instead (``_jax_dp``);
- ``forward_route`` gives "chain" at 136, 192, 240, 254, 384 and 509, and a
  2-iteration solver run at N = 192 (64 positions, 3 slices, 2 modes: the
  chain route's plain versions) matches the JAX solver's loss trajectory
  (its XLA route on the CPU) at rtol 1e-4.

Tolerances: those of tests/test_torch_chain.py at N = 16 (values rtol
1e-4 / atol 1e-6, cotangents of psi, a and phi atol 3e-6 of the largest
reference entry), each atol taken of the largest entry (as
tests/test_torch_far_field.py holds the spectrum) and grown by sqrt(N / 16),
as the float32 rounding of the JAX chain's dense N-point DFT grows. Against
float64 on the CPU at N = 192 the JAX chain's 3-slice exit is off by 4.8e-6 (its
largest entry 5.0) and the objp gradient of multislice_dp_chain's loss by
5.7e-6 of its largest entry, the port's plain versions by 1.6e-6 and
1.8e-6; at N = 16 the two are 1.2e-6 and 1.1e-6. dH as
tests/test_torch_dh.py holds it (atol 2e-5 of its largest entry, rtol
1e-3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.models.forward import multislice_dp as jax_multislice_dp
from ptyrad_tpu.ops import pallas_chain as pch
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.models import forward_route, make_model
from ptyrad_tpu_torch.models.state import Geometry, PtychoParams
from ptyrad_tpu_torch.ops import chain as C
from torch_port_helpers import CPU, assert_grad_close, np_, toy_init

B, PMODE = 2, 2


@pytest.fixture()
def interpret():
    pch.set_interpret(True)
    try:
        yield
    finally:
        pch.set_interpret(False)


@pytest.fixture()
def exit_on(interpret):
    """The far-field exit on in both packages (and the JAX chain
    interpreted)."""
    pch.set_far_field(True, silent=True)
    C.set_far_field(True)
    try:
        yield
    finally:
        pch.set_far_field(False, silent=True)
        C.set_far_field(False)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _growth(expected) -> float:
    """sqrt(N / 16): the growth of the dense DFT's float32 rounding."""
    return float(np.sqrt(np.shape(expected)[-1] / 16))


def _close_values(actual, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(actual, expected, rtol=1e-4,
                               atol=1e-6 * _growth(expected) * float(np.abs(expected).max()))


def _close_grad(actual, expected, name):
    expected = np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-6)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=3e-6 * _growth(expected) * scale,
                               err_msg=f"gradient mismatch: {name}")


def _inputs(rng, n, nz, h_b):
    psi = _cplx(rng, (B, PMODE, n, n))
    a = rng.uniform(0.9, 1.0, (B, nz, n, n)).astype(np.float32)
    p = rng.uniform(-0.3, 0.3, (B, nz, n, n)).astype(np.float32)
    h = np.exp(1j * rng.uniform(0, 6, (h_b, n, n))).astype(np.complex64)
    return psi, a, p, h, _cplx(rng, (B, PMODE, n, n))


def _compare_vjp(j_fn, t_fn, psi, a, p, h, g):
    """The exit and the cotangents of (psi, a, phi, h) of a JAX chain
    function of (psi_r, psi_i, a, p, h_r, h_i) and the port's of (psi, a,
    p, h)."""
    j_args = [jnp.asarray(x) for x in (psi.real, psi.imag, a, p, h.real, h.imag)]
    (out_r, out_i), vjp = jax.vjp(j_fn, *j_args)
    dr, di, da, dp, dhr, dhi = vjp((jnp.asarray(g.real), jnp.asarray(g.imag)))

    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (psi, a, p, h)]
    out = t_fn(*leaves)
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    _close_values(np_(out), np.asarray(out_r) + 1j * np.asarray(out_i))
    _close_grad(np_(grads[0]).real, dr, "psi.re")
    _close_grad(np_(grads[0]).imag, di, "psi.im")
    _close_grad(np_(grads[1]), da, "a")
    _close_grad(np_(grads[2]), dp, "phi")
    assert_grad_close(np_(grads[3]).real, dhr, "dH.re")
    assert_grad_close(np_(grads[3]).imag, dhi, "dH.im")


@pytest.mark.parametrize("n,last,h_b", [(136, True, 1), (135, False, B), (192, True, B),
                                         (192, False, 1), (254, True, B)])
def test_chain_segment_matches_jax(interpret, n, last, h_b):
    """B5 over a 3-slice segment: the exit and every cotangent, dH included."""
    psi, a, p, h, g = _inputs(np.random.default_rng(n), n, 3, h_b)
    _compare_vjp(lambda *x: pch.chain_segment(*x, last, True),
                 lambda *x: C.chain_segment(*x, last), psi, a, p, h, g)


@pytest.mark.parametrize("n,last_mega,h_b", [(136, False, B), (135, True, 1), (192, False, 1),
                                              (254, False, 1)])
def test_chain_stack_matches_jax(interpret, n, last_mega, h_b):
    """B6 over S = 2 segments of Sg = 2 slices: the propagation across the
    segment boundary and, with last_mega False, the exit's own propagation
    carry dH too."""
    psi, a, p, h, g = _inputs(np.random.default_rng(n + 1), n, 4, h_b)
    _compare_vjp(lambda *x: pch.chain_stack(*x, 2, last_mega, True),
                 lambda *x: C.chain_stack(*x, 2, last_mega), psi, a, p, h, g)


@pytest.mark.parametrize("n,h_b", [(136, 1), (135, B), (192, B), (254, 1)])
def test_chain_segment_far_field_matches_jax(exit_on, n, h_b):
    """B5 with the exit (fftshift(fft2(.)) of the final slice, unnormalised:
    at odd N the roll by N // 2): the spectrum and every cotangent, dH
    included."""
    psi, a, p, h, g = _inputs(np.random.default_rng(n + 2), n, 3, h_b)
    _compare_vjp(lambda *x: pch.chain_segment(*x, True, True, True),
                 lambda *x: C.chain_segment(*x, True, far_field=True), psi, a, p, h, g)


def _jax_dp(obja, objp, probe, h, occu, seg, need_dh):
    """The JAX package's dp of a chain case: its chain where it takes the
    shapes, else its XLA multislice_dp."""
    b, omode, nz, n, _ = obja.shape
    pr = Cplx(probe[0], probe[1])
    if pch.chain_applicable_shapes(b, omode, nz, n, n, PMODE, h[0].shape[0], need_dh):
        return pch.multislice_dp_chain(obja, objp, pr, Cplx(*h), occu, 1e-10, need_dh=need_dh,
                                       seg_override=seg)
    return jax_multislice_dp(obja, objp, pr, Cplx(*h), occu, 1e-10)


@pytest.mark.parametrize("n,far_field", [(136, False), (135, True), (192, False), (192, True),
                                         (254, True)])
def test_multislice_dp_chain_matches_jax(interpret, n, far_field):
    """multislice_dp_chain with dH (B6 over 4 slices, B5 over a 1-slice
    tail; with the exit, B5 ends in the detector transform): dp and the
    gradients of a weighted sqrt(dp) loss, H's included."""
    rng = np.random.default_rng(n + 3)
    nz, seg = 5, 2
    obja = rng.uniform(0.9, 1.0, (B, 1, nz, n, n)).astype(np.float32)
    objp = rng.uniform(-0.3, 0.3, (B, 1, nz, n, n)).astype(np.float32)
    probe = _cplx(rng, (1, PMODE, n, n))
    h = np.exp(1j * rng.uniform(0, 6, (1, n, n))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, (B, n, n)).astype(np.float32)
    occu = np.ones(1, np.float32)
    assert pch.chain_applicable_shapes(B, 1, nz, n, n, PMODE, 1, True)
    pch.set_far_field(far_field, silent=True)
    C.set_far_field(far_field)
    try:
        def loss(oa, op, pr, pi, hr, hi):
            dp = _jax_dp(oa, op, (pr, pi), (hr, hi), jnp.asarray(occu), seg, True)
            return jnp.sum(jnp.asarray(w) * jnp.sqrt(dp)), dp

        args = [jnp.asarray(x) for x in (obja, objp, probe.real, probe.imag, h.real, h.imag)]
        (_, dp_ref), g_ref = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)

        leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (obja, objp, probe, h)]
        dp = C.multislice_dp_chain(*leaves[:3], leaves[3], torch.from_numpy(occu), 1e-10,
                                   seg_override=seg)
        (torch.from_numpy(w) * torch.sqrt(dp)).sum().backward()
    finally:
        pch.set_far_field(False, silent=True)
        C.set_far_field(False)
    _close_values(np_(dp), dp_ref)
    _close_grad(np_(leaves[0].grad), g_ref[0], "obja")
    _close_grad(np_(leaves[1].grad), g_ref[1], "objp")
    _close_grad(np_(leaves[2].grad).real, g_ref[2], "probe.re")
    _close_grad(np_(leaves[2].grad).imag, g_ref[3], "probe.im")
    assert_grad_close(np_(leaves[3].grad).real, g_ref[4], "dH.re")
    assert_grad_close(np_(leaves[3].grad).imag, g_ref[5], "dH.im")


@pytest.mark.parametrize("n", [136, 192, 240, 254, 384, 509])
def test_chain_route_takes_every_n(n):
    """forward_route gives the chain at these N on any device (a meta model
    stands for a CUDA one): square, above 128 and up to 512."""
    meta = torch.empty((2, 8, 8), device="meta")
    params = PtychoParams(meta, meta, meta, meta, meta, meta)
    geom = Geometry(probe_shape=(n, n), obj_shape=(1, 21, 700, 700), n_scan_slow=4,
                    n_scan_fast=1, dx=0.1, lambd=0.02)
    assert forward_route(params, geom, torch.arange(4, device="meta")) == "chain"
    assert C.chain_applicable_shapes(4, 1, 21, n, n, 4, 4)


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


def test_solver_at_n192_matches_jax():
    """A 2-iteration run at N = 192 (64 positions in batches of 16, 3
    slices, 2 probe modes): every step through the chain route
    (multislice_dp_chain's plain versions on the CPU), the loss trajectory
    against the JAX solver's at rtol 1e-4."""
    init = toy_init(np.random.default_rng(192), n_scans=64, npix=192, nz=3, pmode=2,
                    canvas=208)
    params, _, geom = make_model(init, None, device=CPU)
    assert forward_route(params, geom, torch.arange(16)) == "chain"
    js = JaxSolver(_solver_params(), init_variables=copy.deepcopy(init), verbose=False)
    js.run()
    ts = PtyRADSolver(_solver_params(), init_variables=copy.deepcopy(init), device="cpu",
                      verbose=False)
    ts.run()
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert len(ours) == len(ref) == 2 and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
