"""ptyrad_tpu_torch.ops.chain (the segmented chain, kernels B5/B6) against
ptyrad_tpu.ops.pallas_chain.

The JAX chain runs its Pallas kernels in interpret mode, as
tests/test_forward.py::TestPallasChainPath does; at N = 16 no radix
permutation applies, so both take H in natural order. The port runs its
plain versions (torch.fft under autograd) on the CPU. Complex wavefields are
handed to JAX as (re, im) pairs; torch's complex gradient re + i im is the
pair of JAX cotangents.

Tolerances, those of TestPallasChainPath: values rtol 1e-4 / atol 1e-6,
gradients atol 3e-6 of the largest reference entry (float32 chains through
dense DFT matrices against torch.fft).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.ops import pallas_chain as pch
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu_torch.ops import chain as C
from ptyrad_tpu_torch.ops.fused_multislice import fused_applicable_shapes

B, PMODE, N = 2, 2, 16


@pytest.fixture()
def interpret():
    pch.set_interpret(True)
    try:
        yield
    finally:
        pch.set_interpret(False)


def _close_values(actual, expected):
    np.testing.assert_allclose(actual, expected, rtol=1e-4, atol=1e-6)


def _close_grad(actual, expected, name):
    scale = max(float(np.abs(expected).max()), 1e-6)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=3e-6 * scale,
                               err_msg=f"gradient mismatch: {name}")


def _inputs(rng, nz, h_b=1, b=B, pmode=PMODE):
    psi = (rng.standard_normal((b, pmode, N, N))
           + 1j * rng.standard_normal((b, pmode, N, N))).astype(np.complex64)
    a = rng.uniform(0.9, 1.0, (b, nz, N, N)).astype(np.float32)
    p = rng.uniform(-0.3, 0.3, (b, nz, N, N)).astype(np.float32)
    h = np.exp(1j * rng.uniform(0, 6, (h_b, N, N))).astype(np.complex64)
    g = (rng.standard_normal((b, pmode, N, N))
         + 1j * rng.standard_normal((b, pmode, N, N))).astype(np.complex64)
    return psi, a, p, h, g


def _jax_vjp(fn, psi, a, p, h, g):
    """(exit wavefield, (d psi, d a, d p)) of a JAX chain function of
    (psi_r, psi_i, a, p, h_r, h_i), with complex results."""
    args = [jnp.asarray(x) for x in (psi.real, psi.imag, a, p)]
    hr, hi = jnp.asarray(h.real), jnp.asarray(h.imag)
    (out_r, out_i), vjp = jax.vjp(lambda *x: fn(*x, hr, hi), *args)
    dr, di, da, dp = vjp((jnp.asarray(g.real), jnp.asarray(g.imag)))
    return (np.asarray(out_r) + 1j * np.asarray(out_i),
            (np.asarray(dr) + 1j * np.asarray(di), np.asarray(da), np.asarray(dp)))


def _torch_vjp(fn, psi, a, p, h, g):
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (psi, a, p)]
    out = fn(*leaves, torch.from_numpy(h))
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    return out.detach().numpy(), tuple(t.numpy() for t in grads)


def _compare(ours, ref):
    (out, grads), (out_ref, grads_ref) = ours, ref
    _close_values(out, out_ref)
    for name, x, y in zip(("psi", "a", "phi"), grads, grads_ref):
        _close_grad(x, y, name)


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("h_b", [1, B])
def test_chain_segment_plain_matches_jax(interpret, last, h_b):
    psi, a, p, h, g = _inputs(np.random.default_rng(1), nz=2, h_b=h_b)
    ref = _jax_vjp(lambda *x: pch.chain_segment(*x, last, False), psi, a, p, h, g)
    ours = _torch_vjp(lambda *x: C.chain_segment_plain(*x, last), psi, a, p, h, g)
    _compare(ours, ref)


@pytest.mark.parametrize("last_mega", [True, False])
def test_chain_stack_plain_matches_jax(interpret, last_mega):
    """S = 2 segments of sg = 2 slices: JAX's mega kernels (B6) under its VJP."""
    psi, a, p, h, g = _inputs(np.random.default_rng(2), nz=4)
    ref = _jax_vjp(lambda *x: pch.chain_stack(*x, 2, last_mega, False), psi, a, p, h, g)
    ours = _torch_vjp(lambda *x: C.chain_stack_plain(*x, 2, last_mega), psi, a, p, h, g)
    _compare(ours, ref)


@pytest.mark.parametrize("omode,nz,seg", [
    (1, 5, 2),     # chain_stack over 4 slices (last_mega False), a 1-slice tail
    (1, 4, 2),     # chain_stack over all 4 (last_mega True), no tail
    (2, 3, 2),     # two object modes weighted by omode_occu; one segment and a tail
    (1, 1, None),  # one slice: best_sg gives 1, a single chain_segment
])
def test_multislice_dp_chain_matches_jax(interpret, omode, nz, seg):
    rng = np.random.default_rng(3)
    obja = rng.uniform(0.9, 1.0, (B, omode, nz, N, N)).astype(np.float32)
    objp = rng.uniform(-0.3, 0.3, (B, omode, nz, N, N)).astype(np.float32)
    probe = (rng.standard_normal((1, PMODE, N, N))
             + 1j * rng.standard_normal((1, PMODE, N, N))).astype(np.complex64)
    h = np.exp(1j * rng.uniform(0, 6, (1, N, N))).astype(np.complex64)
    occu = (np.linspace(1.0, 0.5, omode) / np.linspace(1.0, 0.5, omode).sum()).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, N, N)).astype(np.float32)

    def j_loss(oa, op, pr, pi):
        dp = pch.multislice_dp_chain(oa, op, Cplx(pr, pi), Cplx(jnp.asarray(h.real),
                                     jnp.asarray(h.imag)), jnp.asarray(occu), 1e-10,
                                     seg_override=seg)
        return jnp.sum(jnp.asarray(w) * jnp.sqrt(dp)), dp

    j_args = [jnp.asarray(x) for x in (obja, objp, probe.real, probe.imag)]
    (_, dp_ref), g_ref = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(*j_args)

    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (obja, objp, probe)]
    dp = C.multislice_dp_chain(*leaves, torch.from_numpy(h), torch.from_numpy(occu), 1e-10,
                               seg_override=seg)
    (torch.from_numpy(w) * torch.sqrt(dp)).sum().backward()
    _close_values(dp.detach().numpy(), np.asarray(dp_ref))
    _close_grad(leaves[0].grad.numpy(), g_ref[0], "obja")
    _close_grad(leaves[1].grad.numpy(), g_ref[1], "objp")
    _close_grad(leaves[2].grad.real.numpy(), g_ref[2], "probe.re")
    _close_grad(leaves[2].grad.imag.numpy(), g_ref[3], "probe.im")


@pytest.mark.parametrize("nz,seg", [(5, 2), (4, 2), (21, None)])
def test_grad_off_route_gives_the_same_dp(nz, seg):
    """chain_stack with no gradient wanted runs chain_segment segment by
    segment (no stack): the same dp as the route under autograd."""
    rng = np.random.default_rng(4)
    obja = torch.from_numpy(rng.uniform(0.9, 1.0, (B, 1, nz, N, N)).astype(np.float32))
    objp = torch.from_numpy(rng.uniform(-0.3, 0.3, (B, 1, nz, N, N)).astype(np.float32))
    probe = torch.from_numpy((rng.standard_normal((B, PMODE, N, N))
                              + 1j * rng.standard_normal((B, PMODE, N, N))).astype(np.complex64))
    h = torch.exp(1j * torch.from_numpy(rng.uniform(0, 6, (1, N, N)))).to(torch.complex64)
    occu = torch.ones(1)
    with torch.no_grad():
        dp_off = C.multislice_dp_chain(obja, objp, probe, h, occu, 1e-10, seg_override=seg)
    dp_on = C.multislice_dp_chain(obja.requires_grad_(True), objp, probe, h, occu, 1e-10,
                                  seg_override=seg)
    assert dp_on.requires_grad
    torch.testing.assert_close(dp_off, dp_on.detach(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("nz,sg", [(1, 1), (4, 4), (8, 8), (21, 8), (40, 8)])
def test_best_sg(nz, sg):
    assert C.best_sg(nz) == sg


@pytest.mark.parametrize("n,probe_b,h_b,fused,chain", [
    (128, 1, 1, True, True),    # tBL: the fused kernels take it first
    (128, 4, 4, True, True),    # per-position probe and H
    (2, 1, 1, True, True),
    (256, 4, 1, False, True),   # PSO: only the chain
    (512, 1, 4, False, True),
    (1024, 1, 1, False, False),
    (96, 1, 1, True, False),    # not a power of two: the fused kernels' mixed-radix pair
    (192, 1, 1, False, True),   # not a power of two above 128: the chain's mixed-radix build
    (128, 2, 1, False, True),   # probe batch neither 1 nor B
    (256, 4, 2, False, False),  # H batch neither 1 nor B
])
def test_applicable_shapes(n, probe_b, h_b, fused, chain):
    b, omode, nz, pmode = 4, 1, 21, 4
    assert fused_applicable_shapes(b, omode, nz, n, n, probe_b, pmode, h_b) is fused
    assert C.chain_applicable_shapes(b, omode, nz, n, n, pmode, h_b) is chain


def test_applicable_shapes_need_square():
    assert not fused_applicable_shapes(4, 1, 6, 64, 32, 1, 2, 1)
    assert not C.chain_applicable_shapes(4, 1, 6, 256, 128, 2, 1)
