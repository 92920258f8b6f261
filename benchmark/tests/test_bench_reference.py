"""The reference's plain chain against a direct NumPy DFT at small N, and
its gather, shift, propagator and Adam against hand computations."""

import numpy as np
import pytest
import torch

from benchmark.reference import model, physics


def dft(n):
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)


def fft2_direct(x):
    f = dft(x.shape[-1])
    return f @ x @ f.T


def ifft2_direct(x):
    f = dft(x.shape[-1]).conj() / x.shape[-1]
    return f @ x @ f.T


@pytest.mark.parametrize("n,nz,pmode", [(8, 3, 2), (6, 2, 1), (5, 4, 3)])
def test_far_field_against_a_direct_dft(n, nz, pmode):
    rng = np.random.default_rng(n * 10 + nz)
    b = 2
    a = 1 + 0.1 * rng.standard_normal((b, 1, nz, n, n))
    phi = 0.3 * rng.standard_normal((b, 1, nz, n, n))
    probes = rng.standard_normal((b, pmode, n, n)) + 1j * rng.standard_normal((b, pmode, n, n))
    h = np.exp(1j * rng.uniform(0, 2 * np.pi, (n, n)))
    want = np.zeros((b, n, n))
    for i in range(b):
        for m in range(pmode):
            psi = probes[i, m]
            for z in range(nz):
                psi = psi * a[i, 0, z] * np.exp(1j * phi[i, 0, z])
                if z < nz - 1:
                    psi = ifft2_direct(h * fft2_direct(psi))
            psi_k = np.fft.fftshift(fft2_direct(psi) / n)
            want[i] += np.abs(psi_k) ** 2
    got = model.far_field(torch.tensor(a), torch.tensor(phi), torch.tensor(probes),
                          torch.tensor(h), torch.ones(1, dtype=torch.float64), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_gather_clamps_and_crops():
    canvas = torch.arange(2 * 3 * 10 * 12, dtype=torch.float32).reshape(2, 3, 10, 12)
    corners = torch.tensor([[0, 0], [6, 8], [9, -3]])
    got = model.gather(canvas, corners, 4)
    assert got.shape == (3, 2, 3, 4, 4)
    assert torch.equal(got[1], canvas[:, :, 6:10, 8:12])
    assert torch.equal(got[2], canvas[:, :, 6:10, 0:4])


def test_integer_shift_is_a_roll():
    rng = np.random.default_rng(0)
    probe = torch.tensor(rng.standard_normal((2, 8, 8)) + 1j * rng.standard_normal((2, 8, 8)))
    got = model.shifted_probes(probe, torch.tensor([[1.0, -2.0]], dtype=torch.float64))
    np.testing.assert_allclose(got[0].numpy(), np.roll(probe.numpy(), (1, -2), axis=(-2, -1)),
                               atol=1e-12)


def test_propagator_by_hand():
    n, dx, dz, lam = 6, 0.2, 3.0, physics.wavelength(300.0)
    h = physics.propagator(n, dx, dz, lam)
    f = (np.arange(-3, 3) + 0.5) / n
    k = np.fft.ifftshift(2 * np.pi * f / dx)
    kz = np.sqrt((2 * np.pi / lam) ** 2 - k[:, None] ** 2 - k[None, :] ** 2)
    np.testing.assert_allclose(h, np.exp(1j * dz * kz), rtol=1e-6)
    assert abs(physics.wavelength(300.0) - 0.019687) < 1e-6


def test_mixed_probe_modes_are_orthogonal_with_their_powers():
    probe = physics.stem_probe(300.0, 21.4, 32, 0.3, -100.0)
    modes = physics.mixed_probe(probe, 4, [0.02]).astype(np.complex128)
    gram = modes.reshape(4, -1) @ modes.reshape(4, -1).conj().T
    np.testing.assert_allclose(np.diag(gram).real, [0.94, 0.02, 0.02, 0.02], atol=1e-5)
    assert np.abs(gram - np.diag(np.diag(gram))).max() < 1e-5


def test_adam_first_step_is_lr_times_sign():
    ref = model.Reference.__new__(model.Reference)
    ref.betas, ref.adam_eps = (0.9, 0.999), 1e-8
    ref.update = {"obja": {"lr": 0.5, "start_iter": 1}}
    p = {"obja": torch.zeros(4, dtype=torch.float64)}
    g = torch.tensor([2.0, -3.0, 1e-3, 0.0], dtype=torch.float64)
    ref.adam(p, {"obja": g}, {}, 1)
    want = -0.5 * g / (g.abs() + 1e-8)
    torch.testing.assert_close(p["obja"], want)


def test_probe_readings_ignore_a_mixing_of_the_modes():
    """The probe's compared reading, its intensity map, and its modes'
    powers after ortho_pmode, do not move when a unitary matrix mixes the
    modes: the free gauge that ortho_pmode leaves where powers are equal."""
    gen = torch.Generator().manual_seed(3)
    probe = torch.complex(torch.randn(4, 16, 16, generator=gen, dtype=torch.float64),
                          torch.randn(4, 16, 16, generator=gen, dtype=torch.float64))
    q, _ = torch.linalg.qr(torch.complex(torch.randn(4, 4, generator=gen, dtype=torch.float64),
                                         torch.randn(4, 4, generator=gen, dtype=torch.float64)))
    mixed = (q @ probe.reshape(4, -1)).reshape(probe.shape)
    a, b = model.probe_readings(probe), model.probe_readings(mixed)
    assert torch.allclose(a["intensity"], b["intensity"], rtol=1e-12, atol=1e-12)
    ref = model.Reference.__new__(model.Reference)
    p, m = {"probe": probe.clone()}, {"probe": mixed.clone()}
    ref.c_ortho_pmode(p, {})
    ref.c_ortho_pmode(m, {})
    pa, pb = model.probe_readings(p["probe"]), model.probe_readings(m["probe"])
    assert torch.allclose(pa["powers"], pb["powers"], rtol=1e-10)
    assert not torch.allclose(a["powers"], b["powers"], rtol=1e-3)
