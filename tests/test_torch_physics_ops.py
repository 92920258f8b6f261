"""ptyrad_tpu_torch physics and leaf ops against ptyrad_tpu.

Physics is host-side NumPy in both packages and must agree bit for bit. The
transforms, shifts and blurs run in float32 through different algorithms
(torch.fft vs the JAX package's DFT matrix products; conv1d vs
lax.conv_general_dilated), so they agree at rtol 1e-5 with an atol of 1e-5
of the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.ops import blur as jblur
from ptyrad_tpu.ops import fourier as jfourier
from ptyrad_tpu.ops import shift as jshift
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu.physics import constants as jconst
from ptyrad_tpu.physics import probe as jprobe
from ptyrad_tpu.physics import propagator as jprop
from ptyrad_tpu_torch.ops import blur as tblur
from ptyrad_tpu_torch.ops import fourier as tfourier
from ptyrad_tpu_torch.ops import shift as tshift
from ptyrad_tpu_torch.physics import constants as tconst
from ptyrad_tpu_torch.physics import probe as tprobe
from ptyrad_tpu_torch.physics import propagator as tprop
from torch_port_helpers import cplx_np, np_


def close(actual, expected, rtol=1e-5):
    expected = np.asarray(expected)
    atol = 1e-5 * max(float(np.abs(expected).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=rtol, atol=atol)


@pytest.mark.parametrize("kv", [80.0, 200.0, 300.0])
def test_electron_wavelength_bit_exact(kv):
    assert tconst.electron_wavelength(kv) == jconst.electron_wavelength(kv)


@pytest.mark.parametrize("shape,dx,dz,lam", [((16, 16), 0.15, 2.0, 0.0417),
                                             ((15, 12), 0.1494, 10.0, 0.0197)])
def test_propagator_bit_exact(shape, dx, dz, lam):
    for a, b in zip(tprop.propagator_kgrid(shape, dx), jprop.propagator_kgrid(shape, dx)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tprop.near_field_evolution(shape, dx, dz, lam),
                                  jprop.near_field_evolution(shape, dx, dz, lam))


@pytest.mark.parametrize("pmodes", [1, 4, 6])
def test_probes_bit_exact(pmodes):
    pp = {"kv": 80.0, "conv_angle": 24.9, "Npix": 32, "dx": 0.1494, "df": 20.0, "c3": 1e4,
          "f_a2": 5.0, "theta_a2": 0.3, "shifts": [0.5, -0.25]}
    tp, jp = tprobe.make_stem_probe(pp), jprobe.make_stem_probe(pp)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tprobe.make_mixed_probe(tp, pmodes, [0.02]),
                                  jprobe.make_mixed_probe(jp, pmodes, [0.02]))


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_fft2_ifft2(rng, norm):
    x = (rng.standard_normal((3, 16, 12)) + 1j * rng.standard_normal((3, 16, 12))).astype(np.complex64)
    xc = Cplx(jnp.asarray(x.real), jnp.asarray(x.imag))
    xt = torch.from_numpy(x)
    close(np_(tfourier.fft2(xt, norm=norm)), cplx_np(jfourier.fft2(xc, norm=norm)))
    close(np_(tfourier.ifft2(xt, norm=norm)), cplx_np(jfourier.ifft2(xc, norm=norm)))


@pytest.mark.parametrize("shape", [(4, 16, 16), (2, 15, 9)])
def test_fftshifts_exact(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(np_(tfourier.fftshift2(torch.from_numpy(x))),
                                  np.asarray(jfourier.fftshift2(jnp.asarray(x))))
    np.testing.assert_array_equal(np_(tfourier.ifftshift2(torch.from_numpy(x))),
                                  np.asarray(jfourier.ifftshift2(jnp.asarray(x))))


def test_shift_grid(rng):
    np.testing.assert_allclose(np_(tshift.shift_grid(16, 10)),
                               np.asarray(jshift.shift_grid(16, 10)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("scale", [None, 0.8])
def test_fourier_shift_kspace_and_shift(rng, scale):
    img = (rng.standard_normal((2, 16, 16)) + 1j * rng.standard_normal((2, 16, 16))).astype(np.complex64)
    shifts = (2.0 * rng.standard_normal((5, 2))).astype(np.float32)
    jimg = Cplx(jnp.asarray(img.real), jnp.asarray(img.imag))
    timg = torch.from_numpy(img)
    tsc = None if scale is None else torch.tensor(scale, dtype=torch.float32)
    jsc = None if scale is None else jnp.float32(scale)
    close(np_(tshift.fourier_shift_kspace(timg, torch.from_numpy(shifts), scale=tsc)),
          cplx_np(jshift.fourier_shift_kspace(jimg, jnp.asarray(shifts), scale=jsc)))
    close(np_(tshift.fourier_shift(timg, torch.from_numpy(shifts))),
          cplx_np(jshift.fourier_shift(jimg, jnp.asarray(shifts))))


def test_integer_shift_is_a_roll(rng):
    img = rng.standard_normal((8, 8)).astype(np.float32)
    out = tshift.fourier_shift(torch.from_numpy(img), torch.tensor([[2.0, -3.0]]))
    np.testing.assert_allclose(np_(out.real)[0], np.roll(img, (2, -3), axis=(0, 1)), atol=1e-5)


@pytest.mark.parametrize("size,sigma", [(5, 0.5), (5, 1.0), (7, 2.0)])
def test_blurs(rng, size, sigma):
    x = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    close(np_(tblur.gaussian_blur_2d(torch.from_numpy(x), size, sigma)),
          jblur.gaussian_blur_2d(jnp.asarray(x), size, sigma))
    close(np_(tblur.gaussian_blur_1d(torch.from_numpy(x), size, sigma)),
          jblur.gaussian_blur_1d(jnp.asarray(x), size, sigma))
    np.testing.assert_array_equal(tblur._kernel_np(size, sigma), jblur._kernel_np(size, sigma))
