"""The bfloat16 compute policy (model_params compute_dtype / matmul_dtype
'bfloat16', ``--mixed_precision``) in ptyrad_tpu_torch against ptyrad_tpu.

The JAX side runs under ``set_matmul_dtype('bfloat16', silent=True)``, its
Pallas kernels in interpret mode, and both are restored afterwards; the
port runs its plain versions (what every wrapper runs on a CPU tensor) with
``bf16_operands``. The port rounds the operand of each DFT pass to bfloat16
and transforms it in float32; the JAX package also rounds its DFT matrices,
so the two differ by a rounding noise of the policy's own size, never bit
for bit.

The rule for every comparison, with e_J = |JAX bf16 - JAX f32| / |JAX f32|
(L2 norms over the whole array) the JAX package's own bfloat16 error:
  (a) |port bf16 - JAX bf16| / |JAX f32| <= 2 e_J, and
  (b) |port bf16 - port f32| / |port f32| >= 0.25 e_J, so that a port that
      does not round at all fails.
It holds for forward values and every gradient, and (a) for the losses.
A loss is a sum over pixels whose rounding errors largely cancel, and the
JAX package's rounded DFT matrices, which are not unitary, add a bias to
the intensity that the port's exact twiddles do not: the port's loss moves
less than a tenth of the JAX loss's move, so (b) is held on the fields
that the loss is computed from (dp) and on the gradients instead. The e_J
measured on these inputs is written in each test's docstring.

Bfloat16 rounding amplifies float32 differences: two float32 transforms of
the same operand differ in the last bits, and where such a difference
crosses a rounding boundary it becomes a whole bfloat16 step, which the
next pass spreads over its line. After a few passes two correct
implementations of the policy differ by the policy's own error
(test_rounding_amplifies_float32_differences), so the rule compares
errors, not bits.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.models import multislice_dp as j_multislice_dp
from ptyrad_tpu.ops import fourier as jf
from ptyrad_tpu.ops import pallas_chain as pch
from ptyrad_tpu.ops import pallas_multislice as jpm
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu_torch.engine.solver import PtyRADSolver, loss_fn
from ptyrad_tpu_torch.losses import combined_loss
from ptyrad_tpu_torch.models import forward, forward_route, make_model, multislice_dp
from ptyrad_tpu_torch.models.state import resolve_compute_policy
from ptyrad_tpu_torch.ops import chain as C
from ptyrad_tpu_torch.ops import fourier as F
from ptyrad_tpu_torch.ops import fused_multislice as M
from torch_port_helpers import CPU, cplx_np, np_, toy_init

B, PMODE = 2, 2


class JaxBf16:
    """The JAX package under its bfloat16 switch (and, for the kernels, in
    Pallas interpret mode) for the duration of a with block."""

    def __init__(self, *interpret_modules, on=True):
        self.modules, self.on = interpret_modules, on

    def __enter__(self):
        jf.set_matmul_dtype("bfloat16" if self.on else "float32", silent=True)
        for m in self.modules:
            m.set_interpret(True)

    def __exit__(self, *exc):
        jf.set_matmul_dtype("float32", silent=True)
        for m in self.modules:
            m.set_interpret(False)


def _flat(x):
    return np.asarray(x).astype(np.complex128).ravel()


def rule(port16, port32, jax16, jax32, what: str, rounds: bool = True) -> float:
    """(a) and (b) of the module docstring, (a) alone without ``rounds``
    (a loss); returns e_J."""
    p16, p32, j16, j32 = (_flat(x) for x in (port16, port32, jax16, jax32))
    norm = np.linalg.norm
    e_j = norm(j16 - j32) / norm(j32)
    e_p = norm(p16 - p32) / norm(p32)
    d = norm(p16 - j16) / norm(j32)
    assert e_j > 1e-5, f"{what}: the JAX package did not round (e_J = {e_j})"
    assert d <= 2 * e_j, f"{what}: |port - JAX| / |JAX| = {d} > 2 e_J = {2 * e_j}"
    assert not rounds or e_p >= 0.25 * e_j, \
        f"{what}: the port's own error {e_p} < 0.25 e_J = {e_j / 4}"
    return e_j


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _jc(z):
    return Cplx(jnp.asarray(z.real), jnp.asarray(z.imag))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


# -- 1. the transforms ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fft2", "fft2_ortho", "ifft2", "fftn3", "ifftn3"])
def test_bf16_transform_follows_the_jax_switch(rng, kind):
    """Each transform with bfloat16 operands against the JAX one on float32
    input under the switch, values and the VJP of a random cotangent; the
    output stays complex64 (float32), as the JAX transform of float32 input
    stays float32 (test_forward.py test_bf16_dft_follows_input_dtype).
    e_J: 4.5e-3 (fft2, ifft2 values), 4.9e-3 (their VJPs), 5.1e-3 and 5.7e-3
    (fftn3)."""
    shape = (3, 4, 32, 32) if kind.endswith("n3") else (4, 32, 32)
    x = _cplx(rng, shape)
    cot = _cplx(rng, shape)
    norm = "ortho" if kind == "fft2_ortho" else None

    def port(z, bf16):
        if kind.startswith("fft2"):
            return F.fft2(z, norm=norm, bf16_operands=bf16)
        if kind == "ifft2":
            return F.ifft2(z, bf16_operands=bf16)
        return F.fftn3(z, inverse=kind == "ifftn3", bf16_operands=bf16)

    def j_fn(re, im):
        z = Cplx(re, im)
        if kind.startswith("fft2"):
            out = jf.fft2(z, norm=norm)
        elif kind == "ifft2":
            out = jf.ifft2(z)
        else:
            out = jf.fftn3(z, inverse=kind == "ifftn3")
        return out.re, out.im

    results = {}
    for bf16 in (True, False):
        with JaxBf16(on=bf16):
            (jr, ji), vjp = jax.vjp(j_fn, jnp.asarray(x.real), jnp.asarray(x.imag))
            gr, gi = vjp((jnp.asarray(cot.real), jnp.asarray(cot.imag)))
        assert jr.dtype == jnp.float32
        leaf = _t(x, grad=True)
        out = port(leaf, bf16)
        assert out.dtype == torch.complex64
        (g,) = torch.autograd.grad(out, leaf, grad_outputs=torch.from_numpy(cot))
        results[bf16] = (np_(out), np.asarray(jr) + 1j * np.asarray(ji), np_(g),
                         np.asarray(gr) + 1j * np.asarray(gi))
    (p16, j16, pg16, jg16), (p32, j32, pg32, jg32) = results[True], results[False]
    rule(p16, p32, j16, j32, f"{kind} values")
    rule(pg16, pg32, jg16, jg32, f"{kind} VJP")


def test_rounding_amplifies_float32_differences():
    """Why the rule compares errors: the same policy run by two float32
    transforms (torch.fft and a dense DFT matrix, as the JAX package
    computes it) agrees to a few percent of the policy's error after one
    2-D transform and drifts to the whole error after a few propagations,
    while without rounding the two agree to float32 precision."""
    n = 64
    g = torch.Generator().manual_seed(0)
    x0 = torch.complex(torch.randn(8, n, n, generator=g), torch.randn(8, n, n, generator=g))
    h = torch.polar(torch.ones(n, n), 6.0 * torch.rand(n, n, generator=g))
    j = torch.arange(n, dtype=torch.float64)
    dft = torch.exp(-2j * np.pi * torch.outer(j, j) / n).to(torch.complex64)

    def pass_(x, dim, inverse, dense, bf16):
        if bf16:
            x = F.round_bf16_values(x)
        if not dense:
            return (torch.fft.ifft if inverse else torch.fft.fft)(x, dim=dim)
        m = dft.conj() / n if inverse else dft
        return x @ m.T if dim == -1 else m @ x

    def chain(n_prop, dense, bf16):
        x = x0
        for _ in range(n_prop):
            x = pass_(pass_(x, -1, False, dense, bf16), -2, False, dense, bf16) * h
            x = pass_(pass_(x, -2, True, dense, bf16), -1, True, dense, bf16)
        return pass_(pass_(x, -1, False, dense, bf16), -2, False, dense, bf16)

    def ratio(n_prop):
        a, b, f32 = chain(n_prop, False, True), chain(n_prop, True, True), chain(n_prop, False,
                                                                                  False)
        return float((a - b).norm() / (a - f32).norm()), float((chain(n_prop, True, False)
                                                                - f32).norm() / f32.norm())

    shallow, f32_shallow = ratio(0)   # the far field alone: 2 passes
    deep, _ = ratio(4)                # 4 propagations and the far field: 18 passes
    assert shallow < 0.1 and deep > 0.3, (shallow, deep)
    assert f32_shallow < 1e-5


# -- 2. the plain route with compute_dtype bfloat16 ---------------------------------

def test_plain_route_compute_dtype_matches_jax(rng):
    """multislice_dp(compute_dtype='bfloat16') against the JAX
    multislice_dp(compute_dtype=bfloat16) under the switch: dp and the
    gradients in the object patches and the probes of a weighted sum of dp.
    e_J: dp 1.3e-2, d obja 1.1e-2, d objp 3.5e-2, d probe 1.4e-2."""
    n, nz, b = 32, 3, 3
    obja = (1 + 0.05 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    objp = (0.2 * rng.standard_normal((b, 1, nz, n, n))).astype(np.float32)
    probe = _cplx(rng, (1, PMODE, n, n), 1.0 / n)
    h = np.exp(1j * rng.uniform(-np.pi, np.pi, (1, n, n))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, (b, n, n)).astype(np.float32)
    occu = np.ones(1, np.float32)

    def j_loss(oa, op, pr, pi, low):
        dp = j_multislice_dp(oa, op, Cplx(pr, pi), _jc(h), jnp.asarray(occu),
                             compute_dtype=jnp.bfloat16 if low else jnp.float32)
        return jnp.sum(jnp.asarray(w) * jnp.sqrt(dp)), dp

    out = {}
    for low in (True, False):
        with JaxBf16(on=low):
            (_, j_dp), j_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
                jnp.asarray(obja), jnp.asarray(objp), jnp.asarray(probe.real),
                jnp.asarray(probe.imag), low)
        assert j_dp.dtype == jnp.float32
        leaves = [_t(x, grad=True) for x in (obja, objp, probe)]
        dp = multislice_dp(*leaves, torch.from_numpy(h), torch.from_numpy(occu),
                           compute_dtype="bfloat16" if low else "float32", bf16_operands=low)
        assert dp.dtype == torch.float32
        (torch.from_numpy(w) * torch.sqrt(dp)).sum().backward()
        out[low] = ([np_(dp)] + [np_(t.grad) for t in leaves],
                    [np.asarray(j_dp), j_g[0], j_g[1],
                     np.asarray(j_g[2]) + 1j * np.asarray(j_g[3])])
    for i, what in enumerate(("dp", "d obja", "d objp", "d probe")):
        rule(out[True][0][i], out[False][0][i], out[True][1][i], out[False][1][i], what)


# -- 3. and 4. the fused chain: B3's and B4's plain versions ----------------------

def _fused_inputs(rng, n=32, nz=3, h_b=1):
    obja = (1 + 0.05 * rng.standard_normal((B, 1, nz, n, n))).astype(np.float32)
    objp = (0.2 * rng.standard_normal((B, 1, nz, n, n))).astype(np.float32)
    h = np.exp(1j * rng.uniform(-np.pi, np.pi, (h_b, n, n))).astype(np.complex64)
    meas = np.abs(rng.standard_normal((B, n, n))).astype(np.float32) * 4.0 / (n * n)
    return obja, objp, h, meas


@pytest.mark.parametrize("kspace,h_b", [(True, 1), (False, 1), (True, B)],
                         ids=["spectrum", "shared_probe", "spectrum_h_each"])
def test_loss_sums_twin_matches_pallas_interpret(rng, kspace, h_b):
    """loss_sums_plain (B3's plain version) with bf16_operands against
    multislice_loss_sums_fused interpreted under the switch, need_dh: s1
    and the cotangents of obja, objp, the probe (a per-position spectrum or
    a shared real-space probe) and H. e_J: s1 2.8e-4 to 7.5e-3, d obja
    1.1e-2 to 2.1e-2, d objp 2.3e-2 to 2.9e-2, d probe 1.9e-2 to 2.2e-2,
    dH 8.4e-3 to 1.8e-2."""
    n = 32
    obja, objp, h, meas = _fused_inputs(rng, n, h_b=h_b)
    probe = _cplx(rng, (B if kspace else 1, PMODE, n, n), 1.0 / n)
    mask = np.array([1.0, 0.5], np.float32)
    mask_pad = jnp.zeros((B, 8, 128), jnp.float32).at[:, 0, 0].set(jnp.asarray(mask))

    def j_s1(oa, op, pr, pi, hr, hi):
        return jpm.multislice_loss_sums_fused(oa, op, pr, pi, hr, hi, jnp.asarray(meas),
                                              mask_pad, 0.5, 1e-10, True, kspace)[0]

    out = {}
    for bf16 in (True, False):
        with JaxBf16(jpm, on=bf16):
            j_v, j_g = jax.value_and_grad(j_s1, argnums=tuple(range(6)))(
                *(jnp.asarray(v) for v in (obja, objp, probe.real, probe.imag, h.real,
                                           h.imag)))
        leaves = [_t(x, grad=True) for x in (obja, objp, probe, h)]
        s1, _ = M.loss_sums_plain(*leaves, torch.from_numpy(meas), torch.from_numpy(mask), 0.5,
                                  1e-10, kspace, bf16_operands=bf16)
        s1.backward()
        out[bf16] = ([np_(s1)] + [np_(t.grad) for t in leaves],
                     [np.asarray(j_v), j_g[0], j_g[1], np.asarray(j_g[2]) + 1j * np.asarray(j_g[3]),
                      np.asarray(j_g[4]) + 1j * np.asarray(j_g[5])])
    for i, what in enumerate(("s1", "d obja", "d objp", "d probe", "dH")):
        rule(out[True][0][i], out[False][0][i], out[True][1][i], out[False][1][i], what,
             rounds=i > 0)


@pytest.mark.parametrize("kspace", [True, False], ids=["spectrum", "shared_probe"])
def test_dp_twin_matches_pallas_interpret(rng, kspace):
    """multislice_dp_plain (B4's plain version) with bf16_operands against
    multislice_dp_fused interpreted under the switch, need_dh: dp and the
    cotangents of obja, objp, the probe and H for a random dp cotangent.
    e_J: dp 1.2e-2 to 1.4e-2, d obja 1.6e-2 to 1.8e-2, d objp 1.7e-2 to
    1.8e-2, d probe 1.6e-2 to 1.8e-2, dH 1.2e-2 to 1.5e-2."""
    n = 32
    obja, objp, h, _ = _fused_inputs(rng, n)
    probe = _cplx(rng, (B if kspace else 1, PMODE, n, n), 1.0 / n)
    g = rng.standard_normal((B, n, n)).astype(np.float32)

    def j_dp(oa, op, pr, pi, hr, hi):
        return jpm.multislice_dp_fused(oa, op, pr, pi, hr, hi, True, kspace)

    out = {}
    for bf16 in (True, False):
        with JaxBf16(jpm, on=bf16):
            j_v, vjp = jax.vjp(j_dp, *(jnp.asarray(v) for v in (obja, objp, probe.real,
                                                               probe.imag, h.real, h.imag)))
            j_g = vjp(jnp.asarray(g))
        leaves = [_t(x, grad=True) for x in (obja, objp, probe, h)]
        dp = M.multislice_dp_fused(*leaves, probe_kspace=kspace, bf16_operands=bf16)
        assert dp.dtype == torch.float32
        dp.backward(torch.from_numpy(g))
        out[bf16] = ([np_(dp)] + [np_(t.grad) for t in leaves],
                     [np.asarray(j_v), j_g[0], j_g[1], np.asarray(j_g[2]) + 1j * np.asarray(j_g[3]),
                      np.asarray(j_g[4]) + 1j * np.asarray(j_g[5])])
    for i, what in enumerate(("dp", "d obja", "d objp", "d probe", "dH")):
        rule(out[True][0][i], out[False][0][i], out[True][1][i], out[False][1][i], what)


# -- 5. the segmented chain: B5's and B6's plain versions -------------------------

N_CHAIN = 16  # the interpret tests' N (tests/test_torch_chain.py)


def _chain_vjp_both(j_fn, t_fn, rng, nz, modules=(pch,)):
    """Values and (psi, a, phi, H) cotangents of a JAX chain function of
    (psi_r, psi_i, a, p, h_r, h_i) and the port's of (psi, a, p, h, bf16),
    under the switch and without it; the rule on each."""
    n = N_CHAIN
    psi = _cplx(rng, (B, PMODE, n, n))
    a = rng.uniform(0.9, 1.0, (B, nz, n, n)).astype(np.float32)
    p = rng.uniform(-0.3, 0.3, (B, nz, n, n)).astype(np.float32)
    h = np.exp(1j * rng.uniform(0, 6, (1, n, n))).astype(np.complex64)
    g = _cplx(rng, (B, PMODE, n, n))
    out = {}
    for bf16 in (True, False):
        with JaxBf16(*modules, on=bf16):
            (o_r, o_i), vjp = jax.vjp(j_fn, *(jnp.asarray(v) for v in (
                psi.real, psi.imag, a, p, h.real, h.imag)))
            dr, di, da, dp, dhr, dhi = vjp((jnp.asarray(g.real), jnp.asarray(g.imag)))
        leaves = [_t(x, grad=True) for x in (psi, a, p, h)]
        o = t_fn(*leaves, bf16)
        grads = torch.autograd.grad(o, leaves, grad_outputs=torch.from_numpy(g))
        out[bf16] = ([np_(o)] + [np_(x) for x in grads],
                     [np.asarray(o_r) + 1j * np.asarray(o_i), np.asarray(dr) + 1j * np.asarray(di),
                      da, dp, np.asarray(dhr) + 1j * np.asarray(dhi)])
    for i, what in enumerate(("exit", "d psi", "d a", "d phi", "dH")):
        rule(out[True][0][i], out[False][0][i], out[True][1][i], out[False][1][i], what)


@pytest.mark.parametrize("last,far_field", [(True, False), (False, False), (True, True)],
                         ids=["last", "not_last", "far_field"])
def test_chain_segment_twin_matches_pallas_interpret(rng, last, far_field):
    """chain_segment_plain (B5's plain version) with bf16_operands against
    chain_segment interpreted under the switch, need_dh, with and without
    the far-field exit. e_J: exit 7.8e-3 to 9.6e-3, d psi, d a and d phi
    7.7e-3 to 9.8e-3, dH 6.7e-3 to 8.0e-3."""
    _chain_vjp_both(lambda *x: pch.chain_segment(*x, last, True, far_field),
                    lambda psi, a, p, h, bf16: C.chain_segment_plain(
                        psi, a, p, h, last, far_field, bf16_operands=bf16), rng, 3)


@pytest.mark.parametrize("last_mega", [True, False])
def test_chain_stack_twin_matches_pallas_interpret(rng, last_mega):
    """chain_stack_plain (B6's plain version) with bf16_operands, S = 2
    segments of sg = 2, against chain_stack interpreted under the switch,
    need_dh. e_J: exit 9.7e-3 to 1.1e-2, d psi, d a and d phi 9.3e-3 to
    1.1e-2, dH 7.9e-3 to 9.2e-3."""
    _chain_vjp_both(lambda *x: pch.chain_stack(*x, 2, last_mega, True),
                    lambda psi, a, p, h, bf16: C.chain_stack_plain(
                        psi, a, p, h, 2, last_mega, bf16_operands=bf16), rng, 4)


def test_multislice_dp_chain_matches_jax(rng):
    """multislice_dp_chain with bf16_operands (B6 over 4 slices, B5 over a
    1-slice tail, the far field through the rounded torch.fft passes)
    against the JAX one interpreted under the switch: dp and the gradients
    of a weighted sum of sqrt(dp). e_J: dp 1.2e-2, d obja 9.6e-3, d objp
    3.7e-2, d probe 1.5e-2."""
    n, nz = N_CHAIN, 5
    obja = rng.uniform(0.9, 1.0, (B, 1, nz, n, n)).astype(np.float32)
    objp = rng.uniform(-0.3, 0.3, (B, 1, nz, n, n)).astype(np.float32)
    probe = _cplx(rng, (1, PMODE, n, n))
    h = np.exp(1j * rng.uniform(0, 6, (1, n, n))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, (B, n, n)).astype(np.float32)
    occu = np.ones(1, np.float32)

    def j_loss(oa, op, pr, pi):
        dp = pch.multislice_dp_chain(oa, op, Cplx(pr, pi), _jc(h), jnp.asarray(occu), 1e-10,
                                     seg_override=2)
        return jnp.sum(jnp.asarray(w) * jnp.sqrt(dp)), dp

    out = {}
    for bf16 in (True, False):
        with JaxBf16(pch, on=bf16):
            (_, j_dp), j_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
                *(jnp.asarray(v) for v in (obja, objp, probe.real, probe.imag)))
        leaves = [_t(x, grad=True) for x in (obja, objp, probe)]
        dp = C.multislice_dp_chain(*leaves, torch.from_numpy(h), torch.from_numpy(occu), 1e-10,
                                   seg_override=2, bf16_operands=bf16)
        (torch.from_numpy(w) * torch.sqrt(dp)).sum().backward()
        out[bf16] = ([np_(dp)] + [np_(t.grad) for t in leaves],
                     [np.asarray(j_dp), j_g[0], j_g[1],
                      np.asarray(j_g[2]) + 1j * np.asarray(j_g[3])])
    for i, what in enumerate(("dp", "d obja", "d objp", "d probe")):
        rule(out[True][0][i], out[False][0][i], out[True][1][i], out[False][1][i], what)


# -- the constraints whose transforms follow the policy ------------------------------

@pytest.mark.parametrize("which", ["kz_amplitude", "kz_phase", "kr"])
def test_transform_constraints_follow_the_jax_switch(which):
    """kz_filter and kr_filter with bfloat16 operands against the JAX ones
    under the switch (ptyrad_tpu/constraints.py:103, :122-123), by the rule.
    Rounding an amplitude near 1 to bfloat16 (steps of 2^-7) moves its
    deviation from 1, the signal, by 18% through kz_filter in both
    packages (|bf16 - f32| / |f32 - 1|: 0.1846 for the port, 0.1848 for
    the JAX package here), while a phase moves by 0.4-0.6%: the policy, not
    the port, quantizes the amplitude there. e_J: 2.0e-3 (kz, amplitude),
    5.6e-3 (kz, phase), 1.2e-3 (kr)."""
    from ptyrad_tpu import constraints as JC
    from ptyrad_tpu_torch import constraints as TC

    rng = np.random.default_rng(0)
    shape = (1, 21, 64, 64) if which.startswith("kz") else (2, 3, 48, 40)
    amplitude = which != "kz_phase"
    x = ((1.0 + 0.02 * rng.standard_normal(shape)) if amplitude
         else 0.05 * rng.standard_normal(shape)).astype(np.float32)

    def j_fn(z):
        if which == "kr":
            return JC.kr_filter_fn(z, 0.15, 0.05)
        return JC.kz_filter_fn(z, 1.0, 1.0, "amplitude" if amplitude else "phase")

    def t_fn(z, bf16):
        if which == "kr":
            return TC.kr_filter_fn(z, 0.15, 0.05, bf16)
        return TC.kz_filter_fn(z, 1.0, 1.0, "amplitude" if amplitude else "phase", bf16)

    out = {}
    for bf16 in (True, False):
        with JaxBf16(on=bf16):
            j = np.asarray(j_fn(jnp.asarray(x)))
        out[bf16] = (np_(t_fn(torch.from_numpy(x), bf16)), j)
    rule(out[True][0], out[False][0], out[True][1], out[False][1], which)
    if which == "kz_amplitude":
        signal = np.linalg.norm(out[False][0] - 1.0)
        for i in (0, 1):
            moved = np.linalg.norm(out[True][i] - out[False][i]) / signal
            assert 0.1 < moved < 0.3, moved


def test_probe_mask_k_follows_the_jax_switch(rng):
    """probe_mask_k with bfloat16 operands (the scheduler binds them from
    the geometry) against the JAX constraint under the switch
    (ptyrad_tpu/constraints.py:174-175), by the rule. e_J: 6.2e-3."""
    from ptyrad_tpu import constraints as JC
    from ptyrad_tpu_torch.constraints import ConstraintScheduler

    init = toy_init(rng, n_scans=4, npix=32, pmode=3, canvas=48)
    cfg = {"probe_mask_k": {"freq": 1, "radius": 0.22, "width": 0.05, "power_thresh": 0.95}}
    out = {}
    for dtype in ("bfloat16", "float32"):
        params, buffers, geom = make_model(init, {"compute_dtype": dtype}, device=CPU)
        ConstraintScheduler(cfg, geom)(params, buffers, 1)
        jp, jb, _ = j_make_model(init, {"compute_dtype": dtype})
        with JaxBf16(on=dtype == "bfloat16"):
            jp = JC.probe_mask_k(jp, jb, {**cfg["probe_mask_k"]})
        out[dtype] = (np_(params.probe), cplx_np(jp.probe))
    rule(out["bfloat16"][0], out["float32"][0], out["bfloat16"][1], out["float32"][1],
         "probe_mask_k")


# -- 6. the dtype policy on every route --------------------------------------------

ROUTE_SHAPES = {"fused": dict(npix=16, nz=3), "chain": dict(npix=16, nz=3),
                "plain": dict(npix=12, nz=3)}


@pytest.mark.parametrize("route", sorted(ROUTE_SHAPES))
@pytest.mark.parametrize("loss", ["single", "low_dose"])
def test_bf16_policy_keeps_float32_state(rng, route, loss, monkeypatch):
    """Under compute_dtype 'bfloat16' the parameters, their gradients, dp and
    the loss stay float32 on every route (test_forward.py
    test_bf16_forward_returns_f32_dp), and the loss moves off the float32
    one by the policy's rounding. The chain route is taken at N = 16 by
    declining the fused rule, as the card does above N = 128, and the plain
    route at N = 12 the same way (the fused rule takes every N up to 128;
    the chain rule no N that is not a power of two)."""
    if route != "fused":
        monkeypatch.setattr(importlib.import_module("ptyrad_tpu_torch.models.forward"),
                            "fused_applicable_shapes", lambda *a: False)
    shape = ROUTE_SHAPES[route]
    init = toy_init(rng, n_scans=6, canvas=2 * shape["npix"] + 8, **shape)
    loss_params = ({"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}}
                   if loss == "single" else
                   {"loss_single": {"state": False}, "loss_poissn": {"state": True,
                                                                     "weight": 1.0}})
    idx, mask = torch.arange(4), torch.ones(4)
    totals = {}
    for dtype in ("bfloat16", "float32"):
        params, buffers, geom = make_model(init, {"compute_dtype": dtype}, device=CPU)
        assert forward_route(params, geom, idx) == route
        assert geom.compute_dtype == dtype and geom.bf16_operands == (dtype == "bfloat16")
        for _, t in params.named():
            t.requires_grad_(True)
        dp, _ = forward(params, buffers, geom, idx)
        total, _ = loss_fn(params, buffers, geom, idx, mask, loss_params)
        total.backward()
        assert dp.dtype == torch.float32 and total.dtype == torch.float32
        for name, t in params.named():
            assert t.dtype == (torch.complex64 if name == "probe" else torch.float32), name
            if t.grad is not None:
                assert t.grad.dtype == t.dtype and bool(torch.isfinite(t.grad).all()), name
        totals[dtype] = float(total.detach())
    rel = abs(totals["bfloat16"] - totals["float32"]) / abs(totals["float32"])
    assert 0 < rel < 5e-2, totals


# -- 7. resolving the policy ---------------------------------------------------------

@pytest.mark.parametrize("compute", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("matmul", [None, "float32", "bfloat16"])
def test_policy_resolves_as_the_jax_solver(rng, compute, matmul):
    """compute_dtype and matmul_dtype into Geometry as
    ptyrad_tpu/engine/solver.py:437-449 resolves them (an explicit
    matmul_dtype wins, else compute_dtype decides), beside the JAX
    Geometry's compute_dtype and the JAX switch a JAX solver sets."""
    mp = {k: v for k, v in (("compute_dtype", compute), ("matmul_dtype", matmul)) if v}
    init = toy_init(rng, n_scans=4)
    _, _, geom = make_model(init, mp, device=CPU)
    want = (matmul or compute or "float32") == "bfloat16"
    assert resolve_compute_policy(mp) == (compute or "float32", want)
    assert geom.bf16_operands == want and geom.compute_dtype == (compute or "float32")
    jg = j_make_model(init, mp)[2]
    assert jg.compute_dtype == geom.compute_dtype
    try:
        JaxSolver({"model_params": mp, "recon_params": {"NITER": 1}},
                  init_variables=copy.deepcopy(init), verbose=False)
        assert (jf.get_matmul_dtype() == "bfloat16") == want
    finally:
        jf.set_matmul_dtype("float32", silent=True)


def test_unknown_dtype_raises(rng):
    with pytest.raises(ValueError, match="matmul_dtype"):
        make_model(toy_init(rng, n_scans=4), {"matmul_dtype": "float16"}, device=CPU)


# -- 9. a short trajectory of both solvers ------------------------------------------

def _solver_params(compute_dtype, fwd_fused, niter=2):
    update = {name: {"start_iter": 1, "lr": lr} for name, lr in
              (("obja", 5e-4), ("objp", 5e-4), ("probe", 1e-4))}
    return {
        "model_params": {"optimizer_params": {"name": "Adam"}, "update_params": update,
                         "compute_dtype": compute_dtype, "fwd_fused": fwd_fused},
        "loss_params": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
                        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}},
        "constraint_params": {"kr_filter": {"freq": 1, "obj_type": "both", "radius": 0.3,
                                            "width": 0.05},
                              "probe_mask_k": {"freq": 1}},
        "recon_params": {"NITER": niter, "BATCH_SIZE": {"size": 4}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


@pytest.fixture(scope="module")
def solver_data():
    rng = np.random.default_rng(5)
    init = toy_init(rng, n_scans=8, npix=16, nz=3, pmode=2, canvas=32)
    params, buffers, geom = make_model(init, None, device=CPU)
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(8))
    init["measurements"] = np_(dp)
    init["obj"] = np.ones_like(init["obj"])
    return init


def test_two_iterations_track_the_jax_solver(solver_data):
    """Two Adam iterations of both solvers under the policy (fwd_fused
    false: the plain route with a bfloat16 wavefield in both packages;
    probe_mask_k and kr_filter with bfloat16 operands), from the helpers'
    simulated data: each iteration's loss, and the final objp and probe,
    held by the rule against the JAX package's own bfloat16-vs-float32
    differences (objp starts at zero, so its relative move is large). e_J:
    losses 7.6e-4, objp 2.2e-1, probe 7.6e-3."""
    runs = {}
    for dtype in ("bfloat16", "float32"):
        params = _solver_params(dtype, False)
        try:
            js = JaxSolver(params, init_variables=copy.deepcopy(solver_data), verbose=False)
            js.run()
        finally:
            jf.set_matmul_dtype("float32", silent=True)
        ts = PtyRADSolver(params, init_variables=copy.deepcopy(solver_data), device="cpu",
                          verbose=False)
        ts.run()
        np.testing.assert_array_equal(ts.batch_idx, js.batch_idx)
        runs[dtype] = (
            [np.array([v for _, v in ts.history.loss_iters]), np_(ts.params.objp),
             np_(ts.params.probe)],
            [np.array([v for _, v in js.history.loss_iters]), np.asarray(js.params.objp),
             cplx_np(js.params.probe)])
    for i, what in enumerate(("losses", "objp", "probe")):
        rule(runs["bfloat16"][0][i], runs["float32"][0][i], runs["bfloat16"][1][i],
             runs["float32"][1][i], what, rounds=i > 0)


# -- 10. the convergence gate of the JAX package, for the port ----------------------

def _poisson_synthetic():
    """test_engine.make_synthetic's problem with Poisson noise at 1e5 counts
    a pattern, as test_bf16_policy_converges_like_f32 makes it."""
    from test_engine import make_synthetic

    init, true_phase = make_synthetic(np.random.default_rng(0))
    counts = 1e5
    m = np.asarray(init["measurements"], np.float64)
    init["measurements"] = (np.random.default_rng(7).poisson(m * counts) / counts
                            ).astype(np.float32)
    return init, true_phase


@pytest.mark.parametrize("fwd_fused", [False, True], ids=["plain", "kernel_twins"])
def test_bf16_policy_converges_like_f32(fwd_fused):
    """The convergence gate of tests/test_engine.py (TestComputeDtypePolicy
    test_bf16_policy_converges_like_f32) for the port: 60 Adam iterations on
    the Poisson-noised synthetic demo with the policy and without it, both
    final states evaluated with the same float32 forward and loss: the loss
    within 2% of the float32 run's, and the phase correlation with the
    truth at least 0.98 and within 0.005 of the float32 run's. On the plain
    route (fwd_fused false) and on the kernel route's plain versions (the
    B3 twin with bfloat16 operands)."""
    init, true_phase = _poisson_synthetic()
    upd = {"obja": {"lr": 5e-3, "start_iter": 1}, "objp": {"lr": 5e-3, "start_iter": 1},
           "probe": {"lr": 1e-4, "start_iter": 1}}
    loss_params = {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}}
    n = init["measurements"].shape[0]
    idx, mask = torch.arange(n), torch.ones(n)
    results = {}
    for dtype in ("float32", "bfloat16"):
        params, buffers, geom = make_model(
            init, {"update_params": upd, "compute_dtype": dtype, "fwd_fused": fwd_fused},
            device=CPU)
        assert forward_route(params, geom, idx) == ("fused" if fwd_fused else "plain")
        for k in upd:
            getattr(params, k).requires_grad_(True)
        opt = torch.optim.Adam([{"params": [t], "lr": upd[k]["lr"]} for k, t in params.named()
                                if k in upd])
        for _ in range(60):
            opt.zero_grad()
            loss_fn(params, buffers, geom, idx, mask, loss_params)[0].backward()
            opt.step()
        results[dtype] = params

    _, bufs32, geom32 = make_model(init, {"update_params": upd, "fwd_fused": False}, device=CPU)

    def eval_f32(params):
        with torch.no_grad():
            dp, (oa, op) = forward(params, bufs32, geom32, idx)
            return float(combined_loss(dp, bufs32.measurements, oa, op, bufs32.omode_occu,
                                       loss_params, None)[0])

    e32, e16 = eval_f32(results["float32"]), eval_f32(results["bfloat16"])
    assert np.isfinite(e16) and abs(e16 - e32) / e32 < 0.02, (e16, e32)
    w = slice(16, 16 + 5 * 3)
    truth = true_phase[w, w].ravel()

    def corr(params):
        o = np_(params.objp).sum(1)[0][w, w].ravel()
        return float(np.corrcoef(o, truth)[0, 1])

    c32, c16 = corr(results["float32"]), corr(results["bfloat16"])
    assert c16 >= 0.98 and c16 >= c32 - 0.005, (c16, c32)
