"""The far-field exit of the segmented chain's tail (set_far_field): the
port's plain versions against ptyrad_tpu.ops.pallas_chain with its exit on.

The JAX kernels run in Pallas interpret mode with ``set_far_field(True,
silent=True)``, as tests/test_forward.py::TestPallasChainPath does; both
switches are reset in a ``finally``. At N = 16 no radix permutation applies,
so both packages take H in natural order. The port runs on the CPU, where
``chain_segment(..., far_field=True)`` is its plain version: torch.fft.fft2
and fftshift under autograd.

Tolerances, those of TestPallasChainPath: values rtol 1e-4 / atol 1e-6 (the
unnormalised spectrum against its largest entry, which is what atol means
for a field N^2 times the wavefield), every gradient atol 3e-6 of its
largest reference entry (float32 chains through dense shift-folded DFT
matrices against torch.fft).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.ops import pallas_chain as pch
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu_torch.ops import chain as C

B, PMODE, N = 4, 2, 16


@pytest.fixture()
def jax_exit_on():
    """The JAX chain in interpret mode with its far-field exit on."""
    pch.set_interpret(True)
    pch.set_far_field(True, silent=True)
    try:
        yield
    finally:
        pch.set_far_field(False, silent=True)
        pch.set_interpret(False)


@pytest.fixture()
def port_exit_on():
    C.set_far_field(True)
    try:
        yield
    finally:
        C.set_far_field(False)


def _close_grad(actual, expected, name):
    expected = np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=0, atol=3e-6 * scale,
                               err_msg=f"gradient mismatch: {name}")


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _dp_inputs(rng, omode, nz, h_b=1):
    obja = rng.uniform(0.9, 1.0, (B, omode, nz, N, N)).astype(np.float32)
    objp = rng.uniform(-0.3, 0.3, (B, omode, nz, N, N)).astype(np.float32)
    probe = _cplx(rng, (1, PMODE, N, N))
    h = ((1 + 0.1 * rng.standard_normal((h_b, N, N)))
         + 0.1j * rng.standard_normal((h_b, N, N))).astype(np.complex64)
    occu = (np.linspace(1.0, 0.5, omode) / np.linspace(1.0, 0.5, omode).sum()).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, N, N)).astype(np.float32)
    return obja, objp, probe, h, occu, w


def _jax_dp_and_grads(obja, objp, probe, h, occu, w, seg, need_dh):
    def loss(oa, op, pr, pi, hr, hi):
        dp = pch.multislice_dp_chain(oa, op, Cplx(pr, pi), Cplx(hr, hi), jnp.asarray(occu),
                                     1e-10, need_dh=need_dh, seg_override=seg)
        return jnp.sum(jnp.asarray(w) * jnp.sqrt(dp)), dp

    args = [jnp.asarray(x) for x in (obja, objp, probe.real, probe.imag, h.real, h.imag)]
    (_, dp), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return np.asarray(dp), [np.asarray(g) for g in grads]


def _torch_dp_and_grads(obja, objp, probe, h, occu, w, seg, need_dh):
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (obja, objp, probe)]
    th = torch.from_numpy(h.copy()).requires_grad_(need_dh)
    dp = C.multislice_dp_chain(*leaves, th, torch.from_numpy(occu), 1e-10, seg_override=seg)
    (torch.from_numpy(w) * torch.sqrt(dp)).sum().backward()
    grads = [leaves[0].grad.numpy(), leaves[1].grad.numpy(), leaves[2].grad.real.numpy(),
             leaves[2].grad.imag.numpy()]
    if need_dh:
        dh = th.grad if th.grad is not None else torch.zeros_like(th)  # nz = 1 never propagates
        grads += [dh.real.numpy(), dh.imag.numpy()]
    return dp.detach().numpy(), grads


def _compare_dp(inputs, seg, need_dh):
    dp_ref, g_ref = _jax_dp_and_grads(*inputs, seg, need_dh)
    dp, grads = _torch_dp_and_grads(*inputs, seg, need_dh)
    np.testing.assert_allclose(dp, dp_ref, rtol=1e-4, atol=1e-6)
    names = ("obja", "objp", "probe.re", "probe.im", "H.re", "H.im")
    for name, x, y in zip(names, grads, g_ref):  # zip stops before H without need_dh
        _close_grad(x, y, name)


# -- B5 with the exit -------------------------------------------------------------

@pytest.mark.parametrize("need_dh", [False, True])
@pytest.mark.parametrize("h_b", [1, B])
def test_chain_segment_far_field_matches_jax(jax_exit_on, need_dh, h_b):
    """One 3-slice segment, last and far_field: the exit and the cotangents
    of psi, a, phi (and H under need_dh)."""
    rng = np.random.default_rng(21)
    psi, g = _cplx(rng, (B, PMODE, N, N)), _cplx(rng, (B, PMODE, N, N))
    a = rng.uniform(0.9, 1.0, (B, 3, N, N)).astype(np.float32)
    p = rng.uniform(-0.3, 0.3, (B, 3, N, N)).astype(np.float32)
    h = np.exp(1j * rng.uniform(0, 6, (h_b, N, N))).astype(np.complex64)

    j_args = [jnp.asarray(x) for x in (psi.real, psi.imag, a, p, h.real, h.imag)]
    (out_r, out_i), vjp = jax.vjp(lambda *x: pch.chain_segment(*x, True, need_dh, True), *j_args)
    j_grads = vjp((jnp.asarray(g.real), jnp.asarray(g.imag)))

    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (psi, a, p, h)]
    out = C.chain_segment(*leaves, True, far_field=True)
    t_grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))

    ref = np.asarray(out_r) + 1j * np.asarray(out_i)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-6 * float(np.abs(ref).max()))
    dpsi, da, dp, dh = (t.numpy() for t in t_grads)
    _close_grad(dpsi.real, j_grads[0], "psi.re")
    _close_grad(dpsi.imag, j_grads[1], "psi.im")
    _close_grad(da, j_grads[2], "a")
    _close_grad(dp, j_grads[3], "phi")
    if need_dh:
        _close_grad(dh.real, j_grads[4], "H.re")
        _close_grad(dh.imag, j_grads[5], "H.im")


def test_far_field_exit_is_the_centred_spectrum():
    """What the exit is, stated without the JAX package: fftshift(fft2(chi))
    of the segment's unpropagated exit, unnormalised."""
    rng = np.random.default_rng(22)
    psi = torch.from_numpy(_cplx(rng, (B, PMODE, N, N)))
    a = torch.from_numpy(rng.uniform(0.9, 1.0, (B, 2, N, N)).astype(np.float32))
    p = torch.from_numpy(rng.uniform(-0.3, 0.3, (B, 2, N, N)).astype(np.float32))
    h = torch.from_numpy(np.exp(1j * rng.uniform(0, 6, (1, N, N))).astype(np.complex64))
    chi = C.chain_segment_plain(psi, a, p, h, True)
    y = C.chain_segment_plain(psi, a, p, h, True, far_field=True)
    expected = torch.fft.fftshift(torch.fft.fft2(chi), dim=(-2, -1))
    torch.testing.assert_close(y, expected, rtol=0, atol=0)
    # Parseval: sum |Y|^2 = N^2 sum |chi|^2, so the caller's 1 / N^2 is the only scale
    torch.testing.assert_close((y.abs() ** 2).sum(), N * N * (chi.abs() ** 2).sum(), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("fn", [C.chain_segment, C.chain_segment_plain, C.segment_fwd_cuda],
                         ids=lambda f: f.__name__)
def test_far_field_without_last_raises(fn):
    z = torch.zeros((1, 1, N, N), dtype=torch.complex64)
    r = torch.zeros((1, 1, N, N))
    with pytest.raises(ValueError, match="far_field requires last"):
        fn(z, r, r, z[0], False, far_field=True)


def test_segment_bwd_far_field_without_last_raises():
    z = torch.zeros((1, 1, N, N), dtype=torch.complex64)
    r = torch.zeros((1, 1, N, N))
    with pytest.raises(ValueError, match="far_field requires last"):
        C.segment_bwd_cuda(z, z, r, r, z[0], False, far_field=True)


def test_far_field_is_off_by_default_and_silent_is_accepted():
    assert C._FAR_FIELD is False
    try:
        C.set_far_field(True, silent=True)
        assert C._FAR_FIELD is True
        C.set_far_field(False)
        assert C._FAR_FIELD is False
    finally:
        C.set_far_field(False)


# -- multislice_dp_chain with the exit ---------------------------------------------

@pytest.mark.parametrize("need_dh", [False, True])
def test_multislice_dp_chain_far_field_matches_jax(jax_exit_on, port_exit_on, need_dh):
    """nz = 5, sg = 2: B6 over 4 slices, then a 1-slice B5 tail that takes
    the exit."""
    _compare_dp(_dp_inputs(np.random.default_rng(23), 1, 5), 2, need_dh)


@pytest.mark.parametrize("nz", [4, 6])
def test_far_field_carve_matches_jax(jax_exit_on, port_exit_on, nz, monkeypatch):
    """nz a multiple of sg = 2: a full tail segment is carved off chain_stack
    for the exit, which is left with S = 1 (nz 4) or S = 2 (nz 6) segments;
    need_dh, as tests/test_forward.py:759 runs it."""
    stacks, segments = [], []
    orig_stack, orig_segment = C.chain_stack, C.chain_segment

    def stack(psi0, a_main, *rest):
        stacks.append(a_main.shape[1])
        return orig_stack(psi0, a_main, *rest)

    def segment(psi, a_seg, p_seg, h, last, far_field=False, bf16_operands=False):
        segments.append((a_seg.shape[1], last, far_field))
        return orig_segment(psi, a_seg, p_seg, h, last, far_field, bf16_operands)

    monkeypatch.setattr(C, "chain_stack", stack)
    monkeypatch.setattr(C, "chain_segment", segment)
    _compare_dp(_dp_inputs(np.random.default_rng(24), 1, nz), 2, True)
    assert stacks == [nz - 2]
    assert segments == [(2, True, True)]


def test_far_field_two_object_modes_match_jax(jax_exit_on, port_exit_on):
    """Two object modes weighted by omode_occu, a per-position H."""
    _compare_dp(_dp_inputs(np.random.default_rng(25), 2, 3, h_b=B), 2, True)


@pytest.mark.parametrize("omode,nz,seg", [(1, 5, 2), (1, 4, 2), (2, 6, 2), (1, 21, None),
                                          (1, 1, None)])
def test_exit_on_equals_exit_off_in_the_port(omode, nz, seg):
    """The switch changes where the detector transform runs, not the
    result: the same dp and the same gradients, H's included."""
    inputs = _dp_inputs(np.random.default_rng(26), omode, nz)
    dp_off, g_off = _torch_dp_and_grads(*inputs, seg, True)
    C.set_far_field(True)
    try:
        dp_on, g_on = _torch_dp_and_grads(*inputs, seg, True)
    finally:
        C.set_far_field(False)
    np.testing.assert_allclose(dp_on, dp_off, rtol=1e-5, atol=1e-7)
    for name, x, y in zip(("obja", "objp", "probe.re", "probe.im", "H.re", "H.im"), g_on, g_off):
        _close_grad(x, y, name)


def test_exit_on_without_gradients_gives_the_same_dp(port_exit_on):
    """Under no_grad chain_stack runs B5 segment by segment; the tail still
    takes the exit."""
    obja, objp, probe, h, occu, _ = _dp_inputs(np.random.default_rng(27), 1, 5)
    args = [torch.from_numpy(x) for x in (obja, objp, probe, h, occu)]
    with torch.no_grad():
        dp_ng = C.multislice_dp_chain(*args, 1e-10, seg_override=2)
    dp = C.multislice_dp_chain(args[0].requires_grad_(True), *args[1:], 1e-10, seg_override=2)
    torch.testing.assert_close(dp_ng, dp.detach(), rtol=1e-6, atol=0)
