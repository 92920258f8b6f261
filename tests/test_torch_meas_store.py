"""The measurement side of a training step: ops/resize.py, the meas_dtype
store, the on-the-fly resample and get_measurements, ptyrad_tpu_torch against
ptyrad_tpu on the CPU.

Both packages get the same numpy init_variables (including
on_the_fly_meas_scale_factors) and the same model_params.meas_dtype.
Tolerances: the resamplers atol 1e-5 on unit-normal data (the JAX module's
separable float32 matrix products against F.interpolate's gather, its own
stated parity); a bfloat16 or float16 store is bit-equal after the upcast
(both round to nearest even); the solver's losses rtol 1e-4 as in
tests/test_torch_solver.py.
"""

import copy
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.initialization import Initializer
from ptyrad_tpu.models import get_measurements as j_get_measurements
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.ops import resize as JR
from ptyrad_tpu_torch import losses
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.initialization import meas_pad_on_the_fly, meas_resample_on_the_fly
from ptyrad_tpu_torch.models import forward, get_measurements, make_model
from ptyrad_tpu_torch.models.state import MEAS_DTYPES
from ptyrad_tpu_torch.ops import resize as TR
from test_torch_solver import TBL_CONSTRAINTS, tbl_params
from torch_port_helpers import CPU, np_, toy_init

SCALES = [(0.5, 0.5), (2.0, 2.0), (1.5, 1.5), (0.75, 1.25)]


# -- ops/resize.py ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 2, 13, 10)], ids=["16x16", "13x10"])
@pytest.mark.parametrize("scale", SCALES, ids=str)
def test_bilinear_resize_matches_jax_and_interpolate(scale, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ours = TR.bilinear_resize(torch.from_numpy(x), scale)
    ref = np.asarray(JR.bilinear_resize(jnp.asarray(x), scale))
    assert tuple(ours.shape) == ref.shape == (*shape[:-2], int(shape[-2] * scale[0]),
                                              int(shape[-1] * scale[1]))
    np.testing.assert_allclose(np_(ours), ref, rtol=0, atol=1e-5)
    direct = F.interpolate(torch.from_numpy(x).reshape(-1, 1, *shape[-2:]), scale_factor=scale,
                           mode="bilinear", align_corners=False)
    torch.testing.assert_close(ours.reshape(direct.shape), direct, rtol=0, atol=0)


@pytest.mark.parametrize("scale", SCALES, ids=str)
def test_bilinear_resize_conserve_matches_jax(scale):
    x = np.abs(np.random.default_rng(1).standard_normal((4, 12, 12))).astype(np.float32)
    ours = np_(TR.bilinear_resize_conserve(torch.from_numpy(x), scale))
    ref = np.asarray(JR.bilinear_resize_conserve(jnp.asarray(x), scale))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    if scale[0] == scale[1] == 2.0:  # upsampling a smooth-edged sum keeps the intensity
        np.testing.assert_allclose(ours.sum(), x.sum(), rtol=0.05)


def test_bilinear_resize_identity_returns_its_input():
    x = torch.ones(2, 5, 5)
    assert TR.bilinear_resize(x, (1.0, 1.0)) is x


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 2, 13, 10)], ids=["16x16", "13x10"])
@pytest.mark.parametrize("scale", [(0.5, 0.5), (0.3, 0.7), (1.0, 0.5)], ids=str)
def test_area_downsample_matches_jax_and_interpolate(scale, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ours = TR.area_downsample(torch.from_numpy(x), scale)
    ref = np.asarray(JR.area_downsample(jnp.asarray(x), scale))
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(np_(ours), ref, rtol=0, atol=1e-5)
    direct = F.interpolate(torch.from_numpy(x).reshape(-1, 1, *shape[-2:]), scale_factor=scale,
                           mode="area")
    torch.testing.assert_close(ours.reshape(direct.shape), direct, rtol=0, atol=1e-7)


def test_loss_simlar_uses_the_area_downsample():
    assert losses.area_downsample is TR.area_downsample and not hasattr(losses,
                                                                        "_area_downsample")


# -- initialization.meas_resample_on_the_fly ---------------------------------------------

@pytest.mark.parametrize("scale,padded", [((2, 2), False), ((1.5, 2.0), False), ((0.5, 0.5), True),
                                          ((1.3, 1.3), True)])
def test_meas_resample_on_the_fly_matches_initializer(scale, padded):
    meas = np.ones((3, 10, 10), np.float32)
    template = np.ones((24, 24), np.float32) if padded else None
    stub = types.SimpleNamespace(init_variables={"on_the_fly_meas_padded": template},
                                 init_params={})
    out = Initializer._meas_resample(stub, meas, {"mode": "on_the_fly", "scale_factors": scale})
    assert out is meas
    factors, npix = meas_resample_on_the_fly(meas, scale, template)
    assert factors == list(stub.init_variables["on_the_fly_meas_scale_factors"])
    assert npix == stub.init_params["meas_Npix"]


def test_meas_resample_needs_two_factors():
    with pytest.raises(ValueError, match="two entries"):
        meas_resample_on_the_fly(np.ones((1, 4, 4), np.float32), (2, 2, 2))


# -- the store and get_measurements ------------------------------------------------------

def _binned_init(rng, n_scans=6, pad=False):
    """16^2 probe; the stored patterns are 8^2 (resampled by 2) or, with
    ``pad``, 6^2 padded on the fly to 8^2 first."""
    init = toy_init(rng, n_scans=n_scans, npix=16)
    k = 6 if pad else 8
    meas = (np.abs(rng.standard_normal((n_scans, k, k))) * 3.0 + 0.01).astype(np.float32)
    init["measurements"] = meas
    template = None
    if pad:
        template, idx = meas_pad_on_the_fly(meas, "constant", 8, value=0.1)
        init.update(on_the_fly_meas_padded=template, on_the_fly_meas_padded_idx=idx)
    factors, npix = meas_resample_on_the_fly(meas, (2, 2), template)
    assert npix == 16
    init["on_the_fly_meas_scale_factors"] = factors
    return init


@pytest.mark.parametrize("pad", [False, True], ids=["resample", "pad+resample"])
@pytest.mark.parametrize("meas_dtype", sorted(MEAS_DTYPES))
def test_get_measurements_matches_jax(meas_dtype, pad):
    init = _binned_init(np.random.default_rng(3), pad=pad)
    mp = {"meas_dtype": meas_dtype}
    _, jb, jg = j_make_model(init, mp)
    _, tb, tg = make_model(init, mp, device=CPU)
    assert tb.measurements.dtype == MEAS_DTYPES[meas_dtype]
    assert tb.measurements.element_size() == (4 if meas_dtype == "float32" else 2)
    assert str(jb.measurements.dtype) == meas_dtype
    # the stores agree bit for bit after the upcast
    np.testing.assert_array_equal(np_(tb.measurements.float()),
                                  np.asarray(jb.measurements.astype(jnp.float32)))
    assert tg.meas_scale_factors == jg.meas_scale_factors == (2.0, 2.0)
    idx = np.array([5, 0, 3])
    ours = get_measurements(tb, tg, torch.from_numpy(idx))
    ref = np.asarray(j_get_measurements(jb, jg, jnp.asarray(idx)))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape == (3, 16, 16)
    np.testing.assert_allclose(np_(ours), ref, rtol=0, atol=1e-5)


def test_float16_store_clips_and_warns():
    init = toy_init(np.random.default_rng(4))
    init["measurements"] = init["measurements"].copy()
    init["measurements"][0, 0, 0] = 1.0e5
    with pytest.warns(UserWarning, match="exceeds float16 range"):
        _, tb, _ = make_model(init, {"meas_dtype": "float16"}, device=CPU)
    with pytest.warns(UserWarning, match="exceeds float16 range"):
        _, jb, _ = j_make_model(init, {"meas_dtype": "float16"})
    assert float(tb.measurements[0, 0, 0]) == 65504.0 and bool(torch.isfinite(
        tb.measurements.float()).all())
    np.testing.assert_array_equal(np_(tb.measurements.float()),
                                  np.asarray(jb.measurements.astype(jnp.float32)))
    with warnings.catch_warnings():  # bfloat16 has float32's range: no clip, no warning
        warnings.simplefilter("error")
        _, tb16, _ = make_model(init, {"meas_dtype": "bfloat16"}, device=CPU)
    assert float(tb16.measurements[0, 0, 0]) > 65504.0


@pytest.mark.parametrize("meas_dtype", sorted(MEAS_DTYPES))
def test_store_from_a_tensor_matches_the_store_from_numpy(meas_dtype):
    """A tensor already on the device (e.g. simulated there) is converted
    there; the store is the same as from the numpy array."""
    init = toy_init(np.random.default_rng(5))
    _, from_np, _ = make_model(init, {"meas_dtype": meas_dtype}, device=CPU)
    as_tensor = torch.from_numpy(init["measurements"].copy())
    _, from_t, _ = make_model({**init, "measurements": as_tensor}, {"meas_dtype": meas_dtype},
                              device=CPU)
    assert from_t.measurements.dtype == MEAS_DTYPES[meas_dtype]
    torch.testing.assert_close(from_t.measurements, from_np.measurements, rtol=0, atol=0)
    # a float32 tensor is kept as it is, a numpy array is copied
    assert (from_t.measurements.data_ptr() == as_tensor.data_ptr()) == (meas_dtype == "float32")
    assert from_np.measurements.data_ptr() != init["measurements"].ctypes.data


def test_unknown_meas_dtype_raises():
    with pytest.raises(ValueError, match="meas_dtype"):
        make_model(toy_init(np.random.default_rng(6)), {"meas_dtype": "float64"}, device=CPU)


def test_resampled_shape_must_match_the_probe():
    init = toy_init(np.random.default_rng(7))  # 16^2 patterns and probe
    init["on_the_fly_meas_scale_factors"] = (0.5, 0.5)
    _, tb, tg = make_model(init, None, device=CPU)
    with pytest.raises(ValueError, match="the probe is"):
        get_measurements(tb, tg, torch.arange(2))


# -- the slice as a whole -----------------------------------------------------------------

@pytest.fixture(scope="module")
def binned_dataset():
    """Patterns simulated at 16^2 from a weak phase object, binned 2 x 2 on
    the host to 8^2; the reconstruction resamples them back by (2, 2) and
    starts from a flat object."""
    rng = np.random.default_rng(8)
    init = toy_init(rng, n_scans=11, npix=16, nz=3, pmode=2, canvas=32)
    params, buffers, geom = make_model(init, None, device=CPU)
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(11))
    binned = np_(dp).reshape(11, 8, 2, 8, 2).sum(axis=(2, 4)).astype(np.float32)
    factors, _ = meas_resample_on_the_fly(binned, (2, 2))
    init.update(measurements=binned, on_the_fly_meas_scale_factors=factors,
                obj=np.ones_like(init["obj"]))
    return init


@pytest.mark.parametrize("meas_dtype", ["bfloat16", "float16"])
def test_solver_with_a_reduced_store_and_resample_matches_jax(binned_dataset, meas_dtype):
    """2 iterations through the loss-folded chain from a 2-byte store with the
    (2, 2) on-the-fly resample: losses at rtol 1e-4 against the JAX solver."""
    constraints = {k: v for k, v in TBL_CONSTRAINTS.items() if k != "ortho_pmode"}
    params = tbl_params(constraints)
    params["model_params"]["meas_dtype"] = meas_dtype
    params["recon_params"]["NITER"] = 2
    js = JaxSolver(copy.deepcopy(params), init_variables=copy.deepcopy(binned_dataset),
                   verbose=False)
    js.run()
    ts = PtyRADSolver(copy.deepcopy(params), init_variables=copy.deepcopy(binned_dataset),
                      device="cpu", verbose=False)
    ts.run()
    assert ts.buffers.measurements.dtype == MEAS_DTYPES[meas_dtype]
    assert tuple(ts.buffers.measurements.shape) == (11, 8, 8)
    ours = np.array([v for _, v in ts.history.loss_iters])
    ref = np.array([v for _, v in js.history.loss_iters])
    assert len(ours) == len(ref) == 2 and ours[1] < ours[0]
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
