"""Saving: ptyrad_tpu_torch's save.py against ptyrad_tpu's, on the CPU at a
small size.

The HDF5 writer on one dict (the sentinel, every list rule, nested dicts),
the checkpoint of one 2-iteration run (tests/test_torch_initializer.py's
solver run, without ortho_pmode) written by each package (equal key sets,
shapes and dtypes, the loss trajectory and every value that training does
not move at rtol 1e-4), and the JAX run's state written by both packages
(every value at rtol 1e-4; the optimizer state, which the port writes in
upstream PtyRAD's torch layout, through the JAX package's own reader of
that layout), output folder names for every preset
and custom affixes, the result files of save_results for each (omode, Nz)
case and result mode with probe_prop, the workflow's save schedule, and
overlong names.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import ptyrad_tpu_torch.engine.workflow as wf
from ptyrad_tpu.models.forward import propagated_probe as j_propagated_probe
from ptyrad_tpu.models.state import make_model as j_make_model
from ptyrad_tpu.optim import convert_torch_optim_state
from ptyrad_tpu.save import make_output_folder as j_make_output_folder
from ptyrad_tpu.save import save_dict_to_hdf5 as j_save_dict_to_hdf5
from ptyrad_tpu.save import save_results as j_save_results
from ptyrad_tpu_torch import save as S
from ptyrad_tpu_torch.engine.solver import ReconHistory
from ptyrad_tpu_torch.load import load_params
from ptyrad_tpu_torch.models import make_model, propagated_probe
from ptyrad_tpu_torch.optim import load_opt_state_values
from torch_port_helpers import (CPU, cplx_np, jax_params_numpy, jax_solver, np_,
                                recon_params_file, toy_init, torch_solver)


def h5_tree(path):
    """{'a/b': (dtype, shape, value)} of every dataset in an HDF5 file."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, (v.dtype, v.shape, v[()]))
                     if isinstance(v, h5py.Dataset) else None)
    return out


DICT_CASES = {
    "none": None,
    "int_keys": {1: np.arange(3), 2: {"x": 1.5}},
    "numbers": [1, 2.5, np.float32(3), True],
    "strings": ["a", "bc"],
    "tuples": [(1, 2), (3, 4)],
    "ragged": [[1, 2], [3]],
    "dicts": [{"a": 1, "b": None}, {"a": 2, "b": "x"}],
    "arrays": [np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)],
    "ragged_arrays": [np.ones(2), np.ones(3)],
    "mixed": [1, "a"],
    "scalars": {"i": 3, "f": 0.25, "s": "text", "b": False, "n": np.int16(7)},
    "complex": np.arange(4).astype(np.complex64) * (1 + 2j),
    "object": {"path": __import__("pathlib").Path("/x/y.raw")},
}


@pytest.mark.parametrize("case", sorted(DICT_CASES))
def test_save_dict_to_hdf5_matches_jax(tmp_path, case):
    """Each value kind written by both packages' writers: equal datasets
    (names, dtypes, shapes, values); the port takes torch tensors too."""
    value = DICT_CASES[case]
    d = {"v": value, "nested": {"v": value}}
    j_save_dict_to_hdf5(d, str(tmp_path / "j.hdf5"))
    t = {"v": torch.as_tensor(value) if isinstance(value, np.ndarray) else value,
         "nested": {"v": value}}
    S.save_dict_to_hdf5(t, str(tmp_path / "t.hdf5"))
    a, b = h5_tree(tmp_path / "j.hdf5"), h5_tree(tmp_path / "t.hdf5")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k][:2] == b[k][:2], (k, a[k][:2], b[k][:2])
        np.testing.assert_array_equal(a[k][2], b[k][2], err_msg=k)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """model_iter0002.hdf5 and every image of the same 2-iteration run: by
    the JAX package ('jax'), by the port ('torch'), and by the port from the
    JAX run's state ('torch_of_jax': its parameters, optimizer state and
    histories moved into the port's solver before the save)."""
    tmp = tmp_path_factory.mktemp("save")
    path = recon_params_file(tmp, "p.json", NITER=2,
                             save_result=["model", "optim_state", "objp", "obja", "probe",
                                          "probe_prop"])
    j, j_params = jax_solver(path)
    j.run()
    j_save_results(str(tmp / "jax"), j.params, j.buffers, j.geom, j_params, j.opt_state,
                   j.history, 2, j.indices, lr_dict=j.lr_dict, start_dict=j.start_dict)
    for name in ("torch", "torch_of_jax"):
        t = torch_solver(path)
        if name == "torch":
            t.run()
        else:
            t.prepare()
            t._build()
            with torch.no_grad():
                for key, value in jax_params_numpy(j.params).items():
                    getattr(t.params, key).copy_(torch.tensor(value).reshape(
                        getattr(t.params, key).shape))
            flat, _ = jax.tree_util.tree_flatten_with_path(j.opt_state)
            load_opt_state_values(t.optimizer, {jax.tree_util.keystr(k): np.asarray(v)
                                                for k, v in flat if hasattr(v, "shape")})
            t.history = ReconHistory(**{f: copy.deepcopy(getattr(j.history, f)) for f in (
                "loss_iters", "iter_times", "dz_iters", "term_iters", "batch_terms")})
        S.save_results(str(tmp / name), t.params, t.buffers, t.geom, t.params_dict,
                       t.optimizer, t.history, 2, t.indices, lr_dict=t.lr_dict,
                       start_dict=t.start_dict)
    return tmp, j_params


# written by the clock, or naming the package and the folder
UNEQUAL = ("iter_times", "avg_iter_t", "ptyrad_version", "output_path")
# moved by training: where a gradient is of float32 rounding size, Adam
# steps by lr with its sign, so two float32 implementations part there
# (tests/test_torch_initializer.py's solver test); the loss trajectory
# (loss_iters) is held instead
TRAINED = ("optimizable_tensors/", "batch_losses/", "avg_losses/", "optim_state_dict/")
OPT = "optim_state_dict/"


def compare_trees(a, b, skip=()):
    """Equal keys outside the optimizer state, equal dtypes and shapes, and
    values: floating ones at rtol 1e-4 (with atol 1e-6 of the array's
    largest entry for entries near 0), the rest equal."""
    assert sorted(k for k in a if not k.startswith(OPT)) == \
        sorted(k for k in b if not k.startswith(OPT))
    for k in a:
        if k.startswith(OPT) or k in UNEQUAL:
            continue
        (da, sa, va), (db, sb, vb) = a[k], b[k]
        assert (da, sa) == (db, sb), (k, da, sa, db, sb)
        if k.startswith(skip):
            continue
        if da.kind in "fc":
            scale = float(np.abs(va).max()) if np.size(va) else 0.0
            np.testing.assert_allclose(vb, va, rtol=1e-4, atol=1e-6 * scale, err_msg=k)
        else:
            np.testing.assert_array_equal(vb, va, err_msg=k)


def optimizer_states(tmp, side, j_params):
    """A checkpoint's optimizer state in the JAX package's keystr layout, read
    by the JAX package's own reader (the port's file through its converter
    of upstream's torch layout)."""
    from ptyrad_tpu.load import load_hdf5

    values = load_hdf5(str(tmp / side / "model_iter0002.hdf5"), key="optim_state_dict")
    if side == "jax":
        return values
    return convert_torch_optim_state(values, j_params["model_params"]["update_params"])


def test_model_hdf5_matches_jax(checkpoints):
    """Each package's checkpoint of its own 2-iteration run: equal key sets,
    shapes and dtypes (the optimizer state: equal keys and shapes once read
    by the JAX package), every value that training does not move equal at
    rtol 1e-4, and the loss trajectory at rtol 1e-4."""
    tmp, j_params = checkpoints
    a = h5_tree(tmp / "jax" / "model_iter0002.hdf5")
    b = h5_tree(tmp / "torch" / "model_iter0002.hdf5")
    compare_trees(a, b, skip=TRAINED)
    theirs, ours = (optimizer_states(tmp, side, j_params) for side in ("jax", "torch"))
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert np.shape(ours[k]) == np.shape(v), k


def test_model_hdf5_of_one_state_matches_jax(checkpoints):
    """The JAX run's state written by both packages: every value equal at
    rtol 1e-4, the optimizer state too."""
    tmp, j_params = checkpoints
    compare_trees(h5_tree(tmp / "jax" / "model_iter0002.hdf5"),
                  h5_tree(tmp / "torch_of_jax" / "model_iter0002.hdf5"))
    theirs, ours = (optimizer_states(tmp, side, j_params) for side in ("jax", "torch_of_jax"))
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(np.asarray(ours[k], np.float64), np.asarray(v, np.float64),
                                   rtol=1e-4, err_msg=k)


def test_result_files_match_jax(checkpoints):
    """The same file names from each package's run; from one state, each
    image at the same shape and dtype, its values at 1e-4 of its range
    (8-bit and 16-bit images within one level)."""
    tmp, _ = checkpoints
    names = sorted(os.listdir(tmp / "jax"))
    assert names == sorted(os.listdir(tmp / "torch")) == sorted(os.listdir(tmp / "torch_of_jax"))
    assert "probe_prop_amp_08bit_iter0002.tif" in names
    for name in (n for n in names if n.endswith(".tif")):
        a, b = (np.asarray(Image.open(tmp / side / name)) for side in ("jax", "torch_of_jax"))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        atol = 1 if a.dtype.kind == "u" else 1e-4 * max(float(np.ptp(a)), 1e-6)
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), atol=atol,
                                   err_msg=name)


def models(omode=1, nz=3, tilts=False, affine=None):
    """The toy model in both packages (same init_variables)."""
    iv = toy_init(np.random.default_rng(7), omode=omode, nz=nz)
    if tilts:
        iv["obj_tilts"] = np.array([[1.25, -0.5]], np.float32)
    iv["scan_affine"] = affine
    mp = {"update_params": {"obja": {"start_iter": 1, "lr": 1e-3},
                            "objp": {"start_iter": 3, "lr": 2e-3},
                            "probe_pos_shifts": {"start_iter": 10, "lr": 1e-4}},
          "obj_preblur_std": 0.5, "detector_blur_std": 1.0}
    return iv, mp, j_make_model(iv, mp), make_model(iv, mp, device=CPU)


AFFIXES = {"minimal": ["minimal"], "default": ["default"], "all": ["all"],
           "custom": ["meas", "lr", "start_iter", "optimizer", "dx", "illumination"],
           "none_given": None}


@pytest.mark.parametrize("affixes", sorted(AFFIXES))
def test_output_folder_names_match_jax(tmp_path, affixes):
    iv, mp, (jp, _, jg), (tp, _, tg) = models(tilts=True, affine=(1.02, 0.0, -1.5, 0.25))
    params_dict = {
        "init_params": {"meas_flipT": [1, 0, 0], "probe_illum_type": "electron"},
        "model_params": {**mp, "optimizer_params": {"name": "Adam"}},
        "constraint_params": {"ortho_pmode": {"freq": 1}, "kz_filter": {"freq": None},
                              "obj_rblur": {"freq": 2}},
        "loss_params": {"loss_single": {"state": True}, "loss_pacbed": {"state": False},
                        "loss_sparse": {"state": True}},
        "recon_params": {"INDICES_MODE": {"mode": "sub"}, "GROUP_MODE": "sparse",
                         "BATCH_SIZE": {"size": 16, "grad_accumulation": 2},
                         "prefix_time": "date", "prefix": "pre", "postfix": "post",
                         "recon_dir_affixes": ["minimal"]},
    }
    indices = np.arange(7)
    a = j_make_output_folder(str(tmp_path), indices, params_dict, jp, jg,
                             recon_dir_affixes=AFFIXES[affixes], make_dir=False)
    b = S.make_output_folder(str(tmp_path), indices, params_dict, tp, tg,
                             recon_dir_affixes=AFFIXES[affixes], make_dir=False)
    assert a == b and not os.path.exists(b)
    assert S.make_output_folder(str(tmp_path), indices, params_dict, tp, tg,
                                recon_dir_affixes=AFFIXES[affixes]) == b and os.path.isdir(b)


MODES = {"obj_dim": [2, 3, 4], "FOV": ["crop", "full"], "bit": ["8", "16", "32", "raw"]}


@pytest.mark.parametrize("omode, nz", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_save_results_file_names_match_jax(tmp_path, omode, nz):
    """Every object reduction of its (omode, Nz) case, with the probe, the
    propagated probe and the checkpoint, at every bit depth and both fields
    of view: the same file names from both packages, the images equal at
    the same tolerance as above."""
    iv, mp, (jp, jb, jg), (tp, tb, tg) = models(omode=omode, nz=nz)
    params_dict = {"model_params": mp, "recon_params": {
        "save_result": ["model", "objp", "obja", "probe", "probe_prop"], "result_modes": MODES}}
    history = ReconHistory(loss_iters=[(1, 0.5)], iter_times=[0.1], dz_iters=[(1, 2.0)],
                           term_iters=[{"loss_single": 0.5}])
    indices = np.arange(iv["crop_pos"].shape[0])
    j_save_results(str(tmp_path / "jax"), jp, jb, jg, params_dict, None, history, 1, indices,
                   collate_str="_c")
    S.save_results(str(tmp_path / "torch"), tp, tb, tg, params_dict, None, history, 1, indices,
                   collate_str="_c")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    expect = {(1, 1): "objp_c_iter0001.tif", (1, 3): "obja_zprod_crop_16bit_c_iter0001.tif",
              (2, 1): "objp_ostd_32bit_c_iter0001.tif", (2, 3): "obja_4D_crop_c_iter0001.tif"}
    assert expect[omode, nz] in names and "model_c_iter0001.hdf5" in names
    for name in (n for n in names if n.endswith(".tif")):
        a, b = (np.asarray(Image.open(tmp_path / side / name)) for side in ("jax", "torch"))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        atol = 1 if a.dtype.kind == "u" else 1e-4 * max(float(np.ptp(a)), 1e-6)
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), atol=atol,
                                   err_msg=name)


def test_propagated_probe_matches_jax():
    iv, mp, (jp, jb, jg), (tp, tb, tg) = models(nz=4)
    idx = np.array([5])
    a = cplx_np(j_propagated_probe(jp, jb, jg, idx))
    b = np_(propagated_probe(tp, tb, tg, torch.as_tensor(idx)))
    assert b.shape == (4, 2, 16, 16) == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * float(np.abs(a).max()))


def test_make_save_dict_copies_and_leaves_the_model_alone():
    """The dict holds host copies: changing them changes no parameter, and
    the model's tensors are unchanged by the save."""
    iv, mp, _, (tp, tb, tg) = models()
    before = {k: np_(v).copy() for k, v in tp.named()}
    d = S.make_save_dict("", tp, tb, tg, {"model_params": mp}, None, ReconHistory(), 0,
                         np.arange(3))
    for k, v in d["optimizable_tensors"].items():
        assert isinstance(v, np.ndarray), k
        v[...] = 0
    for k, v in tp.named():
        np.testing.assert_array_equal(np_(v), before[k], err_msg=k)
    assert d["ptyrad_version"].startswith("ptyrad_tpu_torch-")
    assert d["model_attributes"]["dk"] == pytest.approx(1 / (0.15 * 16))
    assert d["model_attributes"]["scan_affine"] is None and d["optim_state_dict"] is None


@pytest.mark.parametrize("niter, save_iters, saved", [(4, 2, [2, 4]), (3, 2, [2, 3]),
                                                      (2, None, [2])])
def test_final_save_skipped_when_aligned(tmp_path, monkeypatch, niter, save_iters, saved):
    """The callback saves every SAVE_ITERS; the final save follows unless
    the last iteration was just saved."""
    calls = []
    orig = wf.save_results

    def counting(*a, **k):
        calls.append(a[7])  # niter
        return orig(*a, **k)

    monkeypatch.setattr(wf, "save_results", counting)
    path = recon_params_file(tmp_path, "p.json", NITER=niter, SAVE_ITERS=save_iters,
                             save_result=["objp"])
    solver = wf.run_reconstruction(load_params(str(path)), device="cpu", verbose=False,
                                   init_rng=np.random.RandomState(0))
    assert calls == saved
    assert sorted(n for n in os.listdir(solver.output_path) if n.startswith("objp_zsum")) == \
        [f"objp_zsum_crop_08bit_iter{n:04d}.tif" for n in saved]


def test_overlong_names_are_survived(tmp_path):
    """Every writer truncates a basename past 255 bytes, keeping its
    extension."""
    S.save_array(np.zeros((4, 8, 8), np.float32), str(tmp_path), file_name="meas_" + "x" * 300,
                 file_format="npy")
    S.save_dict_to_hdf5({"a": 1}, str(tmp_path / ("model_" + "y" * 300 + ".hdf5")))
    iv, mp, _, (tp, tb, tg) = models()
    S.save_results(str(tmp_path), tp, tb, tg, {"recon_params": {
        "save_result": ["model", "objp"], "result_modes": {"obj_dim": [2], "FOV": ["full"],
                                                          "bit": ["raw"]}}},
        None, ReconHistory(), 1, np.arange(4), collate_str="_" + "z" * 300)
    names = os.listdir(tmp_path)
    assert len(names) == 4 and all(len(n) <= 255 for n in names)
    assert sorted(os.path.splitext(n)[1] for n in names) == [".hdf5", ".hdf5", ".npy", ".tif"]


def test_h5py_is_named_when_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        S.save_dict_to_hdf5({"a": 1}, str(tmp_path / "m.hdf5"))
