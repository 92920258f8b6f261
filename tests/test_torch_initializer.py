"""The Initializer and its array loaders: ptyrad_tpu_torch against ptyrad_tpu
on the CPU, at small sizes (16 scans of 32^2, 2 slices, 2 probe modes).

Both packages' Initializers run on the same params and the same files,
written to tmp_path from seeded data, and must give init_variables equal
bit for bit, key by key (same dtype, shape and values), and the same
working init_params. The JAX Initializer draws from NumPy's global state
after ``np.random.seed(s)``, the port's from ``np.random.RandomState(s)``.
Covered: every measurement source (custom, npy, raw through the C reader
and through NumPy, hdf5, mat v5, tif), each _meas_* step, the calibration
modes, simulated electron and X-ray probes and loaded ones (a PtyRAD
checkpoint written by the JAX package, a PtyShv .mat, a py4DSTEM file),
positions (flipT, affine, seeded jitter, loaded), objects, object-mode
occupancy, tilts (all, each, custom, file, PtyRAD), the shared-file cache,
the on-the-fly pad and resample, staged re-runs and init_check's raises.
Then PtyRADSolver(params) with no init_variables, from a .raw, 2 iterations
against the JAX package's at rtol 1e-4 (tests/test_torch_solver.py's
tolerance).
"""

import copy
import json

import numpy as np
import pytest
import scipy.io as sio
import torch

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.initialization import Initializer as JInitializer
from ptyrad_tpu.load import load_params as j_load_params
from ptyrad_tpu.load import load_raw as j_load_raw
from ptyrad_tpu.save import imwrite_tif, save_dict_to_hdf5
from ptyrad_tpu_torch import load as L
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.initialization import Initializer
from ptyrad_tpu_torch.load import load_params

SIDE, NPIX, SEED = 4, 32, 5
N_SCANS = SIDE * SIDE


def synth_meas(seed=0, n=N_SCANS, npix=NPIX):
    """A bright central disk with 5% noise and a weak background, like a
    CBED stack (tests/test_init_io.py's synth_meas)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:npix, :npix] - npix // 2
    disk = (np.hypot(y, x) < npix // 5).astype(np.float32)
    meas = disk[None] * (1 + 0.05 * rng.standard_normal((n, npix, npix)).astype(np.float32))
    return np.clip(meas, 0, None) + 1e-4


def base_params(meas=None, **over):
    p = {
        "probe_illum_type": "electron", "probe_kv": 80.0, "probe_conv_angle": 24.9,
        "meas_Npix": NPIX, "pos_N_scans": N_SCANS, "pos_N_scan_slow": SIDE,
        "pos_N_scan_fast": SIDE, "pos_scan_step_size": 0.43,
        "meas_calibration": {"mode": "dx", "value": 0.15},
        "probe_pmode_max": 2, "probe_pmode_init_pows": [0.05],
        "obj_omode_max": 1, "obj_omode_init_occu": {"occu_type": "uniform"},
        "obj_Nlayer": 2, "obj_slice_thickness": 2.0,
        "meas_source": "custom", "meas_params": synth_meas() if meas is None else meas,
        "probe_source": "simu", "probe_params": None,
        "pos_source": "simu", "pos_params": None,
        "obj_source": "simu", "obj_params": None,
        "tilt_source": "simu", "tilt_params": {"tilt_type": "all", "init_tilts": [[0, 0]]},
        "pos_scan_rand_std": None,
    }
    p.update(over)
    return p


def assert_same(a, b, path="init_variables"):
    """Bit-for-bit equality of nested values: arrays by dtype, shape and
    every value (NaN equal to NaN), scalars by type and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (path, type(b))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype, a.shape, b.dtype, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path, strict=True)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b and np.asarray(a).dtype == np.asarray(b).dtype, (path, a, b)


def run_both(params, verbose=False, seed=SEED):
    np.random.seed(seed)
    j = JInitializer(copy.deepcopy(params) if not _has_array(params) else params,
                     verbose=verbose).init_all()
    t = Initializer(params, verbose=verbose, rng=np.random.RandomState(seed)).init_all()
    assert_same(j.init_variables, t.init_variables)
    assert_same(j.init_params, t.init_params, "init_params")
    return j, t


def _has_array(d):
    return any(isinstance(v, np.ndarray) for v in d.values())


# -- measurement sources -----------------------------------------------------

def write_raw(path, meas, offset=0, gap=1024, head=b"\xab"):
    with open(path, "wb") as f:
        f.write(head * offset)
        for frame in meas:
            f.write(frame.tobytes())
            f.write(b"\x00" * gap)


def meas_source(tmp_path, kind, meas):
    """(meas_source, meas_params) for ``meas`` stored as ``kind``."""
    if kind == "custom":
        return "custom", meas
    if kind == "npy":
        np.save(tmp_path / "m.npy", meas)
        return "file", {"path": str(tmp_path / "m.npy")}
    if kind in ("raw", "raw_numpy"):
        write_raw(tmp_path / "m.raw", meas)
        return "file", {"path": str(tmp_path / "m.raw")}
    if kind == "hdf5":
        import h5py

        with h5py.File(tmp_path / "m.hdf5", "w") as f:
            f.create_dataset("dp", data=meas)
            f.create_dataset("other", data=np.zeros(3))
        return "file", {"path": str(tmp_path / "m.hdf5"), "key": "dp"}
    if kind == "mat":
        sio.savemat(tmp_path / "m.mat", {"dp": meas, "note": np.zeros((2, 2))})
        return "file", {"path": str(tmp_path / "m.mat")}
    if kind == "tif":
        imwrite_tif(str(tmp_path / "m.tif"), meas)
        return "file", {"path": str(tmp_path / "m.tif")}
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["custom", "npy", "raw", "raw_numpy", "hdf5", "mat", "tif"])
def test_measurement_sources(tmp_path, monkeypatch, kind):
    if kind == "raw_numpy":
        monkeypatch.setattr("ptyrad_tpu.native.load_fastraw", lambda: None)
        monkeypatch.setattr("ptyrad_tpu_torch.native.load_fastraw", lambda: None)
    meas = synth_meas()
    source, mp = meas_source(tmp_path, kind, meas)
    L.LAST_RAW_READ.clear()
    _, t = run_both(base_params(meas_source=source, meas_params=mp,
                                meas_normalization={"mode": "max_at_one"}))
    if kind.startswith("raw"):
        assert L.LAST_RAW_READ["reader"] == ("native" if kind == "raw" else "numpy")
        assert L.LAST_RAW_READ["bytes"] == meas.nbytes
    else:
        assert not L.LAST_RAW_READ
    np.testing.assert_allclose(t.init_variables["meas_raw_avg"], meas.mean(0), rtol=1e-5)


@pytest.mark.parametrize("offset,gap", [(0, 1024), (128, 0), (7, 33)])
def test_raw_reader_matches_the_jax_loader(tmp_path, offset, gap):
    data = np.random.default_rng(offset + gap).standard_normal((5, 16, 16)).astype(np.float32)
    path = str(tmp_path / "t.raw")
    write_raw(path, data, offset, gap)
    ours = L.load_raw(path, (5, 16, 16), offset=offset, gap=gap)
    assert L.LAST_RAW_READ["reader"] == "native"
    assert ours.flags.writeable
    np.testing.assert_array_equal(ours, j_load_raw(path, (5, 16, 16), offset=offset, gap=gap))
    np.testing.assert_array_equal(ours, data)


def test_raw_reader_refuses_short_files(tmp_path):
    """The C reader checks the file's size itself (a wrong geometry raises
    instead of reading past the mapping); a last frame without its gap is
    legal; load_raw checks the size before either reader."""
    from ptyrad_tpu_torch.native import load_fastraw

    fastraw = load_fastraw()
    assert fastraw is not None
    data = np.random.default_rng(1).standard_normal((4, 8, 8)).astype(np.float32)
    path = tmp_path / "trunc.raw"
    path.write_bytes(data.tobytes())
    with pytest.raises(ValueError, match="too small"):
        fastraw.read_frames(str(path), 8, 8, 8, 4, 0, 0, 2)
    with pytest.raises(FileNotFoundError):
        fastraw.read_frames(str(tmp_path / "missing.raw"), 4, 8, 8, 4, 0, 0, 2)
    nogap = tmp_path / "nogap.raw"
    nogap.write_bytes(b"".join(f.tobytes() + (b"\x00" * 16 if i < 3 else b"")
                               for i, f in enumerate(data)))
    out = fastraw.read_frames(str(nogap), 4, 8, 8, 4, 0, 16, 2)
    np.testing.assert_array_equal(np.frombuffer(out, np.float32).reshape(4, 8, 8), data)
    with pytest.raises(ValueError, match="size mismatch"):
        L.load_raw(str(path), (4, 8, 8), gap=16)


def test_hdf5_without_h5py_names_the_package(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        L.load_hdf5(str(tmp_path / "x.h5"))


# -- the _meas_* steps --------------------------------------------------------

def _neg(meas):
    return meas - 0.2


MEAS_STEPS = {
    "permute": ({"meas_permute": [2, 0, 1]}, lambda m: np.ascontiguousarray(m.transpose(1, 2, 0))),
    "reshape": ({"meas_reshape": [N_SCANS, NPIX, NPIX]}, lambda m: m.reshape(SIDE, SIDE, NPIX, NPIX)),
    "flipT_ud": ({"meas_flipT": [1, 0, 0]}, None),
    "flipT_lr_T": ({"meas_flipT": [0, 1, 1]}, None),
    "crop": ({"meas_crop": [[0, 2], [1, 4], [4, 28], [4, 28]]}, None),
    "crop_scan_only": ({"meas_crop": [[1, 3], None, None, None]}, None),
    "remove_neg_clip_neg": ({"meas_remove_neg_values": {"mode": "clip_neg"}}, _neg),
    "remove_neg_subtract_min": ({"meas_remove_neg_values": {"mode": "subtract_min",
                                                            "force": True}}, None),
    "remove_neg_clip_value": ({"meas_remove_neg_values": {"mode": "clip_value", "value": 0.5}},
                              _neg),
    "remove_neg_subtract_value": ({"meas_remove_neg_values": {"mode": "subtract_value",
                                                              "value": 0.1}}, _neg),
    "normalize_max_at_one": ({"meas_normalization": {"mode": "max_at_one"}}, None),
    "normalize_mean_at_one": ({"meas_normalization": {"mode": "mean_at_one"}}, None),
    "normalize_sum_to_one": ({"meas_normalization": {"mode": "sum_to_one"}}, None),
    "normalize_divide_const": ({"meas_normalization": {"mode": "divide_const", "value": 2.0}},
                               None),
    **{f"pad_precompute_{kind}": ({"meas_pad": {"mode": "precompute", "padding_type": kind,
                                                "target_Npix": 40, "value": 0.01,
                                                "threshold": 70}}, None)
       for kind in ("constant", "edge", "linear_ramp", "exp", "power")},
    "pad_on_the_fly": ({"meas_pad": {"mode": "on_the_fly", "padding_type": "power",
                                     "target_Npix": 48, "threshold": 70}}, None),
    "resample_precompute": ({"meas_resample": {"mode": "precompute",
                                               "scale_factors": [0.5, 0.5]}}, None),
    "resample_unequal": ({"meas_resample": {"mode": "precompute",
                                            "scale_factors": [1.5, 1.25]}}, None),
    "resample_on_the_fly": ({"meas_resample": {"mode": "on_the_fly",
                                               "scale_factors": [2, 2]}}, None),
    "pad_and_resample_on_the_fly": ({
        "meas_pad": {"mode": "on_the_fly", "padding_type": "edge", "target_Npix": 40},
        "meas_resample": {"mode": "precompute", "scale_factors": [1.5, 1.5]}}, None),
    "source_size": ({"meas_add_source_size": 0.5}, None),
    "detector_blur": ({"meas_add_detector_blur": 1.0}, None),
    "poisson_per_pattern": ({"meas_add_poisson_noise": {"unit": "total_e_per_pattern",
                                                        "value": 1e4}}, None),
    "poisson_per_area": ({"meas_add_poisson_noise": {"unit": "e_per_Ang2", "value": 1e3}},
                         None),
}


@pytest.mark.parametrize("step", sorted(MEAS_STEPS))
def test_measurement_steps(tmp_path, step):
    over, shape = MEAS_STEPS[step]
    meas = synth_meas()
    if shape is not None:
        meas = shape(meas)
    if step.startswith(("crop", "resample_on", "pad_and")):
        # a file source: the .raw of a staged re-run is read at its on-disk
        # geometry (init_params_original), not the cropped working copy
        np.save(tmp_path / "m.npy", meas)
        over = {**over, "meas_source": "file", "meas_params": {"path": str(tmp_path / "m.npy")}}
    else:
        over = {**over, "meas_params": meas}
    _, t = run_both(base_params(**over))
    assert np.isfinite(t.init_variables["measurements"]).all()


def test_staged_rerun_reads_the_raw_at_its_disk_geometry(tmp_path):
    """After a crop and an on-the-fly resample the working init_params hold
    the new sizes; re-running init_measurements reads the .raw at its
    on-disk shape and does not apply the scale twice, in both packages."""
    write_raw(tmp_path / "m.raw", synth_meas())
    p = base_params(meas_source="file", meas_params={"path": str(tmp_path / "m.raw")},
                    meas_crop=[[0, 2], [0, 2], None, None],
                    meas_resample={"mode": "on_the_fly", "scale_factors": [2, 2]})
    j, t = JInitializer(p, verbose=False), Initializer(p, verbose=False)
    for init in (j, t):
        init.init_measurements()
        first = copy.deepcopy(init.init_variables)
        init.init_measurements()
        assert_same(first, init.init_variables)
        assert init.init_params["meas_Npix"] == 2 * NPIX
    assert_same(j.init_variables, t.init_variables)
    assert_same(j.init_params, t.init_params, "init_params")


def test_custom_measurements_are_not_copied():
    meas = synth_meas()
    t = Initializer(base_params(meas_params=meas), verbose=False)
    assert t.init_params["meas_params"] is meas
    assert t.init_params_original["meas_params"] is meas


def test_measurement_export(tmp_path):
    """meas_export writes the processed measurements through save_array; both
    packages write the same file."""
    written = {}
    for name, cls in (("jax", JInitializer), ("port", Initializer)):
        p = base_params(meas_export={"file_dir": str(tmp_path / name), "file_name": "meas",
                                     "file_format": "npy", "append_shape": True})
        init = cls(p, verbose=False)
        init.init_measurements()
        written[name] = np.load(tmp_path / name / f"meas_{N_SCANS}_{NPIX}_{NPIX}.npy")
    assert_same(written["jax"], written["port"])


# -- calibration --------------------------------------------------------------

CALIBRATIONS = {
    "dx": {"mode": "dx", "value": 0.15},
    "dk": {"mode": "dk", "value": 1 / (NPIX * 0.15)},
    "kMax": {"mode": "kMax", "value": 1 / (2 * 0.15)},
    "da": {"mode": "da", "value": 2.0},
    "angleMax": {"mode": "angleMax", "value": 140.0},
    "n_alpha": {"mode": "n_alpha", "value": 5.0},
    "RBF": {"mode": "RBF", "value": 6.4},
    "fitRBF": {"mode": "fitRBF"},
    "fitRBF_thresh": {"mode": "fitRBF", "thresh": 0.3},
}


@pytest.mark.parametrize("mode", sorted(CALIBRATIONS))
def test_calibration_modes(mode):
    _, t = run_both(base_params(meas_calibration=CALIBRATIONS[mode]))
    assert t.init_variables["dx"] > 0


def test_fit_rbf_with_the_cbed_fit():
    """verbose runs fit_cbed_pattern on the mean pattern, as the tBL yml's
    fitRBF does; both fits give the same numbers."""
    from ptyrad_tpu.utils.image_proc import fit_cbed_pattern as j_fit
    from ptyrad_tpu_torch.utils.image_proc import fit_cbed_pattern

    run_both(base_params(meas_calibration={"mode": "fitRBF"}, meas_flipT=[1, 0, 0],
                         pos_scan_rand_std=0.15), verbose=True)
    avg = synth_meas().mean(0)
    ours, theirs = fit_cbed_pattern(avg), j_fit(avg)
    assert_same({k: np.asarray(v) for k, v in ours.items()},
                {k: np.asarray(v) for k, v in theirs.items()}, "fit_cbed_pattern")
    assert abs(ours["radius"] - NPIX // 5) < 1.0


@pytest.mark.parametrize("crop_pad", ["crop", "pad"])
def test_calibration_follows_crop_and_pad(tmp_path, crop_pad):
    np.save(tmp_path / "m.npy", synth_meas())
    over = ({"meas_crop": [None, None, [8, 24], [8, 24]]} if crop_pad == "crop" else
            {"meas_pad": {"mode": "precompute", "padding_type": "constant", "target_Npix": 64,
                          "value": 0.0}})
    _, t = run_both(base_params(meas_source="file", meas_params={"path": str(tmp_path / "m.npy")},
                                meas_calibration={"mode": "fitRBF"}, **over))
    assert t.init_variables["Npix"] == (16 if crop_pad == "crop" else 64)


# -- probes ---------------------------------------------------------------------

XRAY = {"probe_illum_type": "xray", "beam_kev": 8.8, "probe_Ls": 0.05, "probe_Rn": 90e-6,
        "probe_dRn": 50e-9, "probe_D_FZP": 180e-6, "probe_D_H": 60e-6,
        "meas_calibration": {"mode": "dx", "value": 2e-8}, "pos_scan_step_size": 6e-8,
        "obj_slice_thickness": 1e-6}


def checkpoint(tmp_path, t):
    """A PtyRAD checkpoint written by the JAX package's writer from an
    initialized run."""
    v = t.init_variables
    obj = v["obj"]
    path = str(tmp_path / "model.hdf5")
    save_dict_to_hdf5({
        "optimizable_tensors": {
            "obja": np.abs(obj).astype(np.float32), "objp": np.angle(obj).astype(np.float32),
            "probe": v["probe"] * 1.5, "probe_pos_shifts": v["probe_pos_shifts"] + 0.25,
            "obj_tilts": np.full((N_SCANS, 2), 0.5, np.float32),
        },
        "model_attributes": {"crop_pos": v["crop_pos"], "dx": v["dx"]},
        "params": {"note": None},
    }, path)
    return path


def ptyshv_mat(tmp_path, t, ndim_obj=3):
    """A PtyShv reconstruction (.mat v5): probe (Ny, Nx, pmode), object
    (Ny, Nx[, Nz]) and outputs.probe_positions (x, y)."""
    v = t.init_variables
    obj = v["obj"][0].transpose(1, 2, 0) if ndim_obj == 3 else v["obj"][0, 0]
    path = str(tmp_path / "ptyshv.mat")
    pos = v["crop_pos"] + v["probe_pos_shifts"]
    pos = (pos - pos.mean(0))[:, ::-1]  # about the object's centre, (x, y)
    sio.savemat(path, {"probe": v["probe"].transpose(1, 2, 0), "object": obj,
                       "outputs": {"probe_positions": pos}})
    return path


def py4dstem_h5(tmp_path, t):
    import h5py

    v = t.init_variables
    path = str(tmp_path / "py4dstem.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("probe", data=v["probe"][0])
        f.create_dataset("object", data=v["obj"][0])
        f.create_dataset("positions_px", data=(v["crop_pos"] + 16.0).astype(np.float64))
    return path


@pytest.fixture()
def initialized():
    return Initializer(base_params(), verbose=False, rng=np.random.RandomState(0)).init_all()


def _probe_over(name, tmp_path, t):
    if name == "simu_default":
        return {}
    if name == "simu_aberrated":
        return {"probe_params": {"kv": 80.0, "conv_angle": 24.9, "Npix": NPIX, "dx": 0.15,
                                 "pmodes": 3, "pmode_init_pows": [0.02, 0.01], "df": 50.0,
                                 "c3": 1e4, "f_a2": 5.0, "theta_a2": 0.3,
                                 "shifts": [0.5, -0.25]},
                "probe_pmode_max": 3}
    if name == "simu_xray":
        return dict(XRAY)
    if name == "simu_xray_single_mode":
        return {**XRAY, "probe_pmode_max": 1}
    if name == "PtyRAD":
        return {"probe_source": "PtyRAD", "probe_params": checkpoint(tmp_path, t)}
    if name == "PtyShv":
        return {"probe_source": "PtyShv", "probe_params": ptyshv_mat(tmp_path, t)}
    if name == "py4DSTEM":
        return {"probe_source": "py4DSTEM", "probe_params": py4dstem_h5(tmp_path, t)}
    if name == "custom_permuted":
        return {"probe_source": "custom", "probe_params": t.init_variables["probe"].transpose(1, 2, 0),
                "probe_permute": [2, 0, 1]}
    raise ValueError(name)


@pytest.mark.parametrize("name", ["simu_default", "simu_aberrated", "simu_xray",
                                  "simu_xray_single_mode", "PtyRAD", "PtyShv", "py4DSTEM",
                                  "custom_permuted"])
def test_probes(tmp_path, initialized, name):
    _, t = run_both(base_params(**_probe_over(name, tmp_path, initialized)))
    probe = t.init_variables["probe"]
    assert probe.dtype == np.complex64 and np.isfinite(probe).all()


# -- positions, objects, occupancy, tilts -------------------------------------

def _pos_over(name, tmp_path, t):
    v = t.init_variables
    if name in ("flipT_slow", "flipT_both"):
        return {"pos_scan_flipT": [1, 0, 0] if name == "flipT_slow" else [1, 1, 0]}
    if name == "affine":
        return {"pos_scan_affine": [1.1, 0.05, 3.0, 2.0]}
    if name == "jitter":
        return {"pos_scan_rand_std": 0.15}
    if name == "flipT_affine_jitter":
        return {"pos_scan_flipT": [0, 1, 0], "pos_scan_affine": [0.9, -0.1, -5.0, 1.0],
                "pos_scan_rand_std": 0.3}
    if name == "simu_params":
        return {"pos_params": {"scan_step_size": 0.5, "dx": 0.15}}
    if name == "custom":
        return {"pos_source": "custom", "pos_params": v["crop_pos"] + v["probe_pos_shifts"] + 0.3}
    if name == "PtyRAD":
        return {"pos_source": "PtyRAD", "pos_params": checkpoint(tmp_path, t)}
    if name == "PtyShv":
        return {"pos_source": "PtyShv", "pos_params": ptyshv_mat(tmp_path, t)}
    if name == "py4DSTEM":
        return {"pos_source": "py4DSTEM", "pos_params": py4dstem_h5(tmp_path, t)}
    if name == "foldslice_hdf5":
        import h5py

        path = str(tmp_path / "fold.hdf5")
        ys, xs = np.meshgrid(np.arange(SIDE) * 0.43, np.arange(SIDE) * 0.43, indexing="ij")
        with h5py.File(path, "w") as f:
            f.create_dataset("ppY", data=ys.ravel())
            f.create_dataset("ppX", data=xs.ravel())
        return {"pos_source": "foldslice_hdf5", "pos_params": path}
    raise ValueError(name)


@pytest.mark.parametrize("name", ["flipT_slow", "flipT_both", "affine", "jitter",
                                  "flipT_affine_jitter", "simu_params", "custom", "PtyRAD",
                                  "PtyShv", "py4DSTEM", "foldslice_hdf5"])
def test_positions(tmp_path, initialized, name):
    _, t = run_both(base_params(**_pos_over(name, tmp_path, initialized)))
    assert t.init_variables["crop_pos"].dtype == np.int32


def _obj_over(name, tmp_path, t):
    v = t.init_variables
    if name == "simu_shape":
        return {"obj_params": [1, 2, 90, 100]}
    if name == "custom":
        return {"obj_source": "custom", "obj_params": v["obj"] * np.exp(0.1j)}
    if name == "PtyRAD":
        return {"obj_source": "PtyRAD", "obj_params": checkpoint(tmp_path, t)}
    if name == "PtyShv_3d":
        return {"obj_source": "PtyShv", "obj_params": ptyshv_mat(tmp_path, t)}
    if name == "PtyShv_2d":
        return {"obj_source": "PtyShv", "obj_params": ptyshv_mat(tmp_path, t, 2),
                "obj_Nlayer": 1}
    if name == "py4DSTEM":
        return {"obj_source": "py4DSTEM", "obj_params": py4dstem_h5(tmp_path, t)}
    if name == "two_modes_custom_occu":
        return {"obj_omode_max": 2, "obj_omode_init_occu": {"occu_type": "custom",
                                                           "init_occu": [0.7, 0.3]}}
    if name == "two_modes_uniform":
        return {"obj_omode_max": 2}
    raise ValueError(name)


@pytest.mark.parametrize("name", ["simu_shape", "custom", "PtyRAD", "PtyShv_3d", "PtyShv_2d",
                                  "py4DSTEM", "two_modes_custom_occu", "two_modes_uniform"])
def test_objects(tmp_path, initialized, name):
    _, t = run_both(base_params(**_obj_over(name, tmp_path, initialized)))
    assert t.init_variables["obj"].dtype == np.complex64


def _tilt_over(name, tmp_path, t):
    if name == "all":
        return {"tilt_params": {"tilt_type": "all", "init_tilts": [[1.0, -0.5]]}}
    if name == "each":
        return {"tilt_params": {"tilt_type": "each", "init_tilts": [[1.0, -0.5]]}}
    if name == "default":
        return {"tilt_params": {}}
    if name == "custom":
        return {"tilt_source": "custom", "tilt_params": [[0.5, 0.25]] * N_SCANS}
    if name == "file":
        np.save(tmp_path / "tilts.npy", np.linspace(-1, 1, 2 * N_SCANS).reshape(N_SCANS, 2))
        return {"tilt_source": "file", "tilt_params": {"path": str(tmp_path / "tilts.npy")}}
    if name == "PtyRAD":
        return {"tilt_source": "PtyRAD", "tilt_params": checkpoint(tmp_path, t)}
    raise ValueError(name)


@pytest.mark.parametrize("name", ["all", "each", "default", "custom", "file", "PtyRAD"])
def test_tilts(tmp_path, initialized, name):
    _, t = run_both(base_params(**_tilt_over(name, tmp_path, initialized)))
    assert t.init_variables["obj_tilts"].dtype == np.float32


@pytest.mark.parametrize("source", ["PtyRAD", "PtyShv"])
def test_shared_file_cache(tmp_path, initialized, source):
    """obj, probe and pos from one file: it is read once and all three
    stages take it from the cache, in both packages."""
    path = (checkpoint(tmp_path, initialized) if source == "PtyRAD"
            else ptyshv_mat(tmp_path, initialized))
    over = {f"{f}_source": source for f in ("obj", "probe", "pos")}
    over.update({f"{f}_params": path for f in ("obj", "probe", "pos")})
    j, t = run_both(base_params(**over))
    flags = [(i.use_cached_obj, i.use_cached_probe, i.use_cached_pos, i.cache_source)
             for i in (j, t)]
    assert flags[0] == flags[1] == (True, True, True, source)


# -- init_check ----------------------------------------------------------------

def _bad(name, t):
    v = t.init_variables
    if name == "nlayer":
        return {"obj_source": "custom", "obj_params": np.ones((1, 5, 100, 100), np.complex64)}
    if name == "negative_pos":
        return {"pos_source": "custom", "pos_params": v["crop_pos"] - 200.0}
    if name == "pos_off_canvas":
        return {"pos_source": "custom", "pos_params": v["crop_pos"] + 500.0}
    if name == "tilt_count":
        return {"tilt_source": "custom", "tilt_params": [[0.0, 0.0]] * 3}
    if name == "probe_shape":
        return {"probe_source": "custom", "probe_params": np.ones((1, 30, NPIX), np.complex64)}
    if name == "omode_occu":
        return {"obj_omode_init_occu": {"occu_type": "custom", "init_occu": [0.5, 0.5]}}
    if name == "meas_shape":
        return {"meas_params": synth_meas(n=N_SCANS - 1)}
    raise ValueError(name)


@pytest.mark.parametrize("name", ["nlayer", "negative_pos", "pos_off_canvas", "tilt_count",
                                  "probe_shape", "omode_occu", "meas_shape"])
def test_init_check_raises_alike(initialized, name):
    p = base_params(**_bad(name, initialized))
    with pytest.raises(ValueError) as theirs:
        JInitializer(p, verbose=False).init_all()
    with pytest.raises(ValueError) as ours:
        Initializer(p, verbose=False).init_all()
    assert str(ours.value) == str(theirs.value)


def test_unseeded_rng_is_fresh():
    """Without rng the draws are unseeded, as the reference's are: two
    Initializers jitter the positions differently."""
    p = base_params(pos_scan_rand_std=0.15)
    a, b = (Initializer(p, verbose=False).init_all() for _ in range(2))
    assert not np.array_equal(a.init_variables["probe_pos_shifts"],
                              b.init_variables["probe_pos_shifts"])


# -- the slice as a whole: PtyRADSolver(params) from a .raw ---------------------

def solver_params(raw_path):
    """The tBL yml's init_params at 4 x 4 scans of 32^2 (2 probe modes,
    2 slices) on a .raw, and its other sections with batch 4 and 2
    iterations. The probe is defocused by 200 Ang (the PSO yml defocuses
    by -200) so that it lights the whole 32^2 window: a focused probe
    leaves most of each window's object pixels with gradients of float32
    rounding size, whose sign Adam turns into a step of lr either way, and
    the two packages' iteration-2 losses then part by up to 1e-3 (1e-5
    here)."""
    return {
        "init_params": {
            "probe_kv": 80.0, "probe_conv_angle": 24.9, "meas_Npix": NPIX, "probe_defocus": 200.0,
            "pos_N_scans": N_SCANS, "pos_N_scan_slow": SIDE, "pos_N_scan_fast": SIDE,
            "pos_scan_step_size": 0.43, "meas_calibration": {"mode": "fitRBF"},
            "probe_pmode_max": 2, "probe_pmode_init_pows": [0.02], "obj_omode_max": 1,
            "obj_Nlayer": 2, "obj_slice_thickness": 2.0, "meas_flipT": [1, 0, 0],
            "meas_normalization": {"mode": "max_at_one"}, "pos_scan_rand_std": 0.15,
            "meas_source": "file", "meas_params": {"path": raw_path},
            "probe_source": "simu", "pos_source": "simu", "obj_source": "simu",
            "tilt_source": "simu", "tilt_params": {"tilt_type": "all", "init_tilts": [[0, 0]]},
        },
        "model_params": {"optimizer_params": {"name": "Adam"}, "update_params": {
            "obja": {"start_iter": 1, "lr": 5.0e-4}, "objp": {"start_iter": 1, "lr": 5.0e-4},
            "probe": {"start_iter": 1, "lr": 1.0e-4},
            "probe_pos_shifts": {"start_iter": 10, "lr": 1.0e-4},
            "obj_tilts": {"start_iter": None, "lr": 0},
            "slice_thickness": {"start_iter": None, "lr": 0}}},
        "loss_params": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
                        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}},
        "constraint_params": {
            "ortho_pmode": {"freq": 1}, "fix_probe_int": {"freq": 1},
            "obj_rblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5},
            "obj_zblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 1.0},
            "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
            "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 4}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


def simulated_patterns():
    """Patterns simulated through the port's forward() from a weak phase
    object, with the probe and raster that the params describe at dx 0.3 Ang
    (the Initializer's own, on placeholder measurements)."""
    from ptyrad_tpu_torch.models import forward, make_model

    ip = {**solver_params("")["init_params"], "meas_source": "custom",
          "meas_params": synth_meas(), "meas_calibration": {"mode": "dx", "value": 0.3},
          "pos_scan_rand_std": None, "meas_flipT": None, "probe_params": None,
          "pos_params": None, "obj_params": None}
    iv = Initializer(ip, verbose=False, rng=np.random.RandomState(0)).init_all().init_variables
    rng = np.random.default_rng(11)
    phase = 0.3 * rng.random(iv["obj"].shape)
    iv["obj"] = np.exp(1j * phase).astype(np.complex64)
    params, buffers, geom = make_model(iv, None, device="cpu")
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(N_SCANS))
    return dp.numpy()


@pytest.mark.parametrize("ortho_pmode", [False, True], ids=["without_ortho_pmode", "tbl"])
def test_solver_from_params_file_matches_jax(tmp_path, ortho_pmode):
    """load_params -> PtyRADSolver(params) (no init_variables) -> run(), on
    the CPU, against the JAX package's PtyRADSolver(params) with the same
    seed, on patterns simulated from a known object and stored as the yml's
    flipped .raw: equal init_variables, then the losses at rtol 1e-4.

    With the yml's ortho_pmode each package's eigh picks its own gauge for
    each probe mode, and Adam's elementwise steps part the trajectories
    after the first constraint pass (tests/test_torch_solver.py::
    test_with_ortho_pmode_gauge_invariant): there iteration 1 is held at
    rtol 1e-4 and iteration 2 at that test's 1e-2."""
    meas = simulated_patterns()
    write_raw(tmp_path / "m.raw", np.ascontiguousarray(np.flip(meas, axis=1)))
    path = tmp_path / "params.json"
    d = solver_params(str(tmp_path / "m.raw"))
    if not ortho_pmode:
        d["constraint_params"]["ortho_pmode"] = {"freq": None}  # validation's default is 1
    path.write_text(json.dumps(d))
    params = load_params(str(path))
    ours = PtyRADSolver(params, device="cpu", verbose=False, init_rng=np.random.RandomState(SEED))
    # validation leaves meas_params.path a pathlib.Path, which the JAX
    # package's C reader refuses (it takes a str); the port takes either
    j_params = j_load_params(str(path))
    assert j_params["init_params"]["meas_params"]["path"] == params["init_params"]["meas_params"][
        "path"]
    j_params["init_params"]["meas_params"]["path"] = str(tmp_path / "m.raw")
    np.random.seed(SEED)
    theirs = JaxSolver(j_params, verbose=False)
    assert_same(theirs.init_variables, ours.init_variables)
    ours.run()
    theirs.run()
    np.testing.assert_array_equal(ours.batch_idx, theirs.batch_idx)
    np.testing.assert_array_equal(ours.init_variables["measurements"],
                                  meas / meas.mean(0).max())
    losses = [[v for _, v in s.history.loss_iters] for s in (ours, theirs)]
    assert len(losses[0]) == 2 and np.isfinite(losses[0]).all() and losses[0][1] < losses[0][0]
    np.testing.assert_allclose(losses[0][0], losses[1][0], rtol=1e-4)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-2 if ortho_pmode else 1e-4)
