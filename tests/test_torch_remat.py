"""model_params.fwd_remat in ptyrad_tpu_torch, on the CPU.

- ``multislice_dp(remat=True)`` checkpoints each of the Nz - 1 slice steps
  (torch.utils.checkpoint, non-reentrant). Against the JAX package's
  ``multislice_dp(remat=True)`` (jax.checkpoint) on the same seeded inputs:
  dp at rtol 1e-5 and the gradients in obja, objp, the probes and H at the
  tolerance of tests/test_forward.py:356-372 (torch_port_helpers).
- Against the port without remat, dp and every gradient are equal bit for
  bit, under the float32 and both bfloat16 policies, with probes of batch 1
  and of batch B: the recompute repeats the same operations in the same
  order.
- With H requiring a gradient (optimizable dz or tilts), the bytes packed
  for the backward (counted with saved_tensors_hooks) fall to at most half.
- The key reaches Geometry.fwd_remat with no warning and changes no route:
  the fused and chain routes ignore it, as in the JAX package.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.models import multislice_dp as j_multislice_dp
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu_torch.models import forward, forward_route, make_model, multislice_dp
from ptyrad_tpu_torch.models.state import Geometry, PtychoParams
from torch_port_helpers import CPU, assert_grad_close, np_, toy_init

B, MODES, NZ = 3, 2, 6


def chain_inputs(rng, n, probe_b=B, h_b=B):
    """Seeded numpy inputs of multislice_dp: patches (B, 2, 6, n, n), probes
    (probe_b, 2, n, n), H (h_b, n, n) and the object-mode weights."""
    obja = (1 + 0.05 * rng.standard_normal((B, MODES, NZ, n, n))).astype(np.float32)
    objp = (0.1 * rng.standard_normal((B, MODES, NZ, n, n))).astype(np.float32)
    probes = (rng.standard_normal((probe_b, MODES, n, n))
              + 1j * rng.standard_normal((probe_b, MODES, n, n))).astype(np.complex64)
    h = np.exp(1j * rng.uniform(-1, 1, (h_b, n, n))).astype(np.complex64)
    occu = np.array([0.7, 0.3], np.float32)
    return obja, objp, probes, h, occu


def port_run(inputs, remat, compute_dtype="float32", bf16_operands=False, w=None):
    """dp and the gradients of sum(w * sqrt(dp)) in obja, objp, probes, H."""
    obja, objp, probes, h, occu = (torch.from_numpy(x) for x in inputs)
    leaves = [t.requires_grad_(True) for t in (obja, objp, probes, h)]
    dp = multislice_dp(obja, objp, probes, h, occu, compute_dtype=compute_dtype,
                       bf16_operands=bf16_operands, remat=remat)
    weight = torch.ones_like(dp) if w is None else torch.from_numpy(w)
    (weight * torch.sqrt(dp)).sum().backward()
    return dp.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("n,probe_b", [(16, B), (32, 1)])
def test_remat_matches_jax_remat(rng, n, probe_b):
    inputs = chain_inputs(rng, n, probe_b=probe_b)
    obja, objp, probes, h, occu = inputs

    def j_loss(a, p, pr, hh):
        return jnp.sum(jnp.sqrt(j_multislice_dp(a, p, pr, hh, jnp.asarray(occu), remat=True)))

    j_args = (jnp.asarray(obja), jnp.asarray(objp),
              Cplx(jnp.asarray(probes.real), jnp.asarray(probes.imag)),
              Cplx(jnp.asarray(h.real), jnp.asarray(h.imag)))
    j_dp = j_multislice_dp(*j_args, jnp.asarray(occu), remat=True)
    j_g = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*j_args)

    dp, (g_a, g_p, g_pr, g_h) = port_run(inputs, remat=True)
    expected = np.asarray(j_dp)
    np.testing.assert_allclose(np_(dp), expected, rtol=1e-5,
                               atol=1e-5 * float(np.abs(expected).max()))
    assert_grad_close(np_(g_a), j_g[0], "obja")
    assert_grad_close(np_(g_p), j_g[1], "objp")
    assert_grad_close(np_(g_pr.real), j_g[2].re, "probes.re")
    assert_grad_close(np_(g_pr.imag), j_g[2].im, "probes.im")
    assert_grad_close(np_(g_h.real), j_g[3].re, "H.re")
    assert_grad_close(np_(g_h.imag), j_g[3].im, "H.im")


@pytest.mark.parametrize("policy", ["float32", "bfloat16", "bf16_operands"])
@pytest.mark.parametrize("probe_b", [1, B])
def test_remat_equals_no_remat_bit_for_bit(rng, policy, probe_b):
    inputs = chain_inputs(rng, 16, probe_b=probe_b)
    w = rng.uniform(0.5, 1.5, (B, 16, 16)).astype(np.float32)
    kw = {"compute_dtype": "bfloat16" if policy == "bfloat16" else "float32",
          "bf16_operands": policy == "bf16_operands", "w": w}
    dp0, g0 = port_run(inputs, remat=False, **kw)
    dp1, g1 = port_run(inputs, remat=True, **kw)
    assert torch.equal(dp0, dp1)
    for name, a, b in zip(("obja", "objp", "probes", "H"), g0, g1):
        assert torch.equal(a, b), name


def packed_bytes(inputs, remat):
    """Bytes of the tensors saved for the backward outside any checkpoint,
    with every input, H included, requiring a gradient."""
    count = [0]

    def pack(t):
        count[0] += t.numel() * t.element_size()
        return t

    obja, objp, probes, h, occu = (torch.from_numpy(x) for x in inputs)
    for t in (obja, objp, probes, h):
        t.requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        dp = multislice_dp(obja, objp, probes, h, occu, remat=remat)
    torch.sqrt(dp).sum().backward()
    return count[0]


@pytest.mark.parametrize("h_b", [1, B])
def test_remat_at_most_halves_the_saved_bytes(rng, h_b):
    inputs = chain_inputs(rng, 24, h_b=h_b)
    stored, kept = packed_bytes(inputs, False), packed_bytes(inputs, True)
    assert 0 < kept <= stored / 2, (kept, stored)


def test_model_params_key_reaches_geometry_without_a_warning(rng):
    init = toy_init(rng)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, _, on = make_model(init, {"fwd_remat": True}, device=CPU)
        _, _, off = make_model(init, {"fwd_remat": False}, device=CPU)
        _, _, default = make_model(init, None, device=CPU)
    assert on.fwd_remat and not off.fwd_remat and not default.fwd_remat


@pytest.mark.parametrize("n,route", [(8, "fused"), (120, "fused"), (256, "chain"),
                                     (192, "chain"), (640, "plain")])
def test_remat_leaves_the_route_off_the_cpu(n, route):
    """A meta model stands for a CUDA one: fwd_remat changes no route."""
    meta = torch.empty((2, 8, 8), device="meta")
    params = PtychoParams(meta, meta, meta, meta, meta, meta)
    idx = torch.arange(3, device="meta")
    for remat in (False, True):
        geom = Geometry(probe_shape=(n, n), obj_shape=(1, 2, 700, 700), n_scan_slow=3,
                        n_scan_fast=1, dx=0.1, lambd=0.02, fwd_remat=remat)
        assert forward_route(params, geom, idx) == route


@pytest.mark.parametrize("npix,route", [(16, "fused"), (136, "chain")])
def test_forward_ignores_remat_on_the_kernel_routes(rng, npix, route):
    """forward() with fwd_remat on a fused-shaped and a chain-shaped model:
    the same route, no plain-route call, no warning, the same dp."""
    init = toy_init(rng, npix=npix, canvas=npix + 8, nz=2, n_scans=2)
    idx = torch.arange(2)
    dps = []
    for remat in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            params, buffers, geom = make_model(init, {"fwd_remat": remat}, device=CPU)
            assert forward_route(params, geom, idx) == route
            before = forward.launches_plain
            dp, _ = forward(params, buffers, geom, idx)
        assert forward.launches_plain == before
        dps.append(dp)
    assert torch.equal(dps[0], dps[1])


def test_forward_passes_remat_on_the_plain_route(rng):
    """fwd_fused: false with fwd_remat: the plain route, whose dp and
    gradients equal those of the run without remat."""
    init = toy_init(rng, n_scans=4, nz=4)
    idx = torch.arange(4)
    runs = []
    for remat in (False, True):
        mp = {"fwd_fused": False, "fwd_remat": remat,
              "update_params": {"slice_thickness": {"lr": 1e-3}}}
        params, buffers, geom = make_model(init, mp, device=CPU)
        assert forward_route(params, geom, idx) == "plain" and geom.fwd_remat == remat
        for _, t in params.named():
            t.requires_grad_(True)
        dp, _ = forward(params, buffers, geom, idx)
        torch.sqrt(dp).sum().backward()
        runs.append([dp.detach()] + [t.grad for _, t in params.named()])
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)
