"""The params files: ptyrad_tpu_torch.load.load_params and its schema
(ptyrad_tpu_torch/params/schema.py) against ptyrad_tpu's, on the CPU.

Both loaders read the same files and must return equal dicts, validated or
not: the five demo files of demo/params/, and a .toml, a .json and a .py
(with imports and a helper function) written to tmp_path. The invalid cases
of tests/test_init_io.py (TestParamsSchema, TestLoaderReviewFixesR5) raise
in both, with the same fields named. chip_smoke.py's params file is a fixed
point of the port's validation, so the card runs what validation would have
given even where pydantic is missing.
"""

import importlib.util
import json
import pathlib
import sys
from pathlib import Path

import numpy as np
import pydantic
import pytest

from ptyrad_tpu.load import load_params as j_load_params
from ptyrad_tpu.params import PtyRADParams as JParams
from ptyrad_tpu_torch.load import load_params
from ptyrad_tpu_torch.params import PtyRADParams

ROOT = Path(__file__).resolve().parent.parent
DEMO_PARAMS = sorted((ROOT / "demo" / "params").glob("*.yml"))


def assert_same(a, b, path="params"):
    """Equal nested dicts: same keys, same types of leaf, equal values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_five_demo_files():
    assert [p.name for p in DEMO_PARAMS] == [
        "PSO_reconstruct.yml", "largeFOV_shard_canvas.yml", "tBL_WSe2_hypertune.yml",
        "tBL_WSe2_reconstruct.yml", "tBL_WSe2_reconstruct_minimal.yml"]


@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("path", DEMO_PARAMS, ids=lambda p: p.name)
def test_demo_params_load_alike(path, validate):
    ours = load_params(str(path), validate=validate)
    assert_same(ours, j_load_params(str(path), validate=validate))
    assert ours["params_path"] == str(path)
    if validate:
        assert ours["recon_params"]["BATCH_SIZE"]["grad_accumulation"] == 1  # a filled default


def _init_params_text():
    return {
        "probe_kv": 80.0, "probe_conv_angle": 24.9, "meas_Npix": 32,
        "pos_N_scan_slow": 4, "pos_N_scan_fast": 4, "pos_scan_step_size": 0.43,
        "meas_calibration": {"mode": "dx", "value": 0.15},
        "probe_pmode_max": 2, "obj_Nlayer": 1, "obj_slice_thickness": 2.0,
        "meas_source": "file", "meas_params": {"path": "x.npy"},
    }


def _write(tmp_path, kind):
    ip = _init_params_text()
    if kind == "json":
        path = tmp_path / "params.json"
        path.write_text(json.dumps({"init_params": ip,
                                    "recon_params": {"NITER": 3, "prefix_time": "date"}}))
    elif kind == "toml":
        path = tmp_path / "params.toml"
        lines = ["[init_params]"]
        for k, v in ip.items():
            if isinstance(v, dict):
                inner = ", ".join(f"{ik} = {json.dumps(iv)}" for ik, iv in v.items())
                lines.append(f"{k} = {{ {inner} }}")
            else:
                lines.append(f"{k} = {json.dumps(v)}")
        lines += ["[recon_params]", "NITER = 3", "[loss_params.loss_sparse]", "weight = 0.2"]
        path.write_text("\n".join(lines) + "\n")
    else:
        path = tmp_path / "params.py"
        path.write_text(
            "import os\n"
            "import numpy as np\n"
            "def _helper():\n"
            "    return 2\n"
            f"init_params = {ip!r}\n"
            "init_params['probe_pmode_max'] = _helper()\n"
            "model_params = {'optimizer_params': {'name': 'AdamW'}}\n")
    return str(path)


@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("kind", ["toml", "json", "py"])
def test_other_formats_load_alike(tmp_path, kind, validate):
    path = _write(tmp_path, kind)
    ours = load_params(path, validate=validate)
    assert_same(ours, j_load_params(path, validate=validate))
    assert "np" not in ours and "os" not in ours and "_helper" not in ours
    if kind == "py":
        assert ours["init_params"]["probe_pmode_max"] == 2


def _minimal(**over):
    d = {"init_params": {
        "probe_kv": 80.0, "probe_conv_angle": 24.9, "meas_Npix": 64,
        "pos_N_scan_slow": 8, "pos_N_scan_fast": 8, "pos_scan_step_size": 0.43,
        "probe_pmode_max": 4, "obj_Nlayer": 3, "obj_slice_thickness": 2.0,
        "meas_params": {"path": "data.h5", "key": "dp"},
    }}
    d.update(over)
    return d


def _extra(d):
    d["init_params"]["bogus_field"] = 1
    return d


def _ptyrad_probe_dict(d):
    d["init_params"].update(probe_source="PtyRAD", probe_params={"not": "a path"})
    return d


def _no_kv(d):
    del d["init_params"]["probe_kv"]
    return d


INVALID = {
    "extra_forbidden": lambda: _extra(_minimal()),
    "bad_optimizer": lambda: _minimal(model_params={"optimizer_params": {"name": "NotAnOpt"}}),
    "source_params_pair": lambda: _ptyrad_probe_dict(_minimal()),
    "all_data_terms_off": lambda: _minimal(loss_params={
        "loss_single": {"state": False}, "loss_poissn": {"state": False},
        "loss_pacbed": {"state": False}}),
    "electron_missing_kv": lambda: _no_kv(_minimal()),
    "negative_lr": lambda: _minimal(model_params={"update_params": {
        "obja": {"start_iter": 1, "lr": -1.0}}}),
    "bad_calibration_mode": lambda: _minimal(init_params={
        **_minimal()["init_params"], "meas_calibration": {"mode": "RBFX"}}),
}


def _errors(cls, d):
    with pytest.raises(pydantic.ValidationError) as info:
        cls(**d)
    return sorted((tuple(str(p) for p in e["loc"]), e["type"]) for e in info.value.errors())


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_params_raise_alike(case):
    ours = _errors(PtyRADParams, INVALID[case]())
    assert ours and ours == _errors(JParams, INVALID[case]())


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_file_raises_alike(tmp_path, case):
    """Through load_params on a .json: both raise, the same fields named."""
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(INVALID[case]()))
    with pytest.raises(pydantic.ValidationError) as ours:
        load_params(str(path))
    with pytest.raises(pydantic.ValidationError) as theirs:
        j_load_params(str(path))
    locs = [sorted(tuple(str(p) for p in e["loc"]) for e in info.value.errors())
            for info in (ours, theirs)]
    assert locs[0] == locs[1]


@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("loader", [load_params, j_load_params], ids=["port", "jax"])
def test_empty_params_file_raises_pointed_error(tmp_path, loader, validate):
    empty = tmp_path / "empty.yml"
    empty.write_text("# nothing here\n")
    with pytest.raises(ValueError, match="empty or does not define a mapping"):
        loader(str(empty), validate=validate)


def test_validation_without_pydantic_names_validate_false(tmp_path, monkeypatch):
    """Where pydantic is missing, validate=True raises an ImportError that
    names validate=False, and validate=False still loads."""
    path = _write(tmp_path, "json")
    for name in list(sys.modules):
        if name == "pydantic" or name.startswith(("pydantic.", "ptyrad_tpu_torch.params")):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pydantic", None)
    with pytest.raises(ImportError, match="validate=False"):
        load_params(path)
    assert load_params(path, validate=False)["init_params"]["meas_Npix"] == 32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _paths_as_str(d):
    """A JSON file holds a path as a string; validation turns a nested one
    into a pathlib.Path, which every reader treats alike."""
    if isinstance(d, dict):
        return {k: _paths_as_str(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_paths_as_str(v) for v in d]
    return str(d) if isinstance(d, pathlib.Path) else d


def test_chip_smoke_params_file_is_a_fixed_point(tmp_path):
    """chip_smoke.py's params file states every key validation fills, so
    load_params(validate=False) on the card gives what validation gives
    here: the dict validates to itself, through a .json written and read
    back as on the card."""
    cs = _chip_smoke()
    d = cs.tbl_params_file(str(tmp_path / "tbl.raw"))
    assert _paths_as_str(PtyRADParams(**d).model_dump()) == d
    path = tmp_path / "tbl.json"
    path.write_text(json.dumps(d))
    raw = load_params(str(path), validate=False)
    valid = _paths_as_str(load_params(str(path)))
    assert raw == valid
    assert valid == _paths_as_str(j_load_params(str(path)))


def test_optimizer_names_are_the_jax_registrys():
    """The names the port's schema accepts are the JAX package's registry
    keys (create_optimizer itself runs Adam only)."""
    from ptyrad_tpu.optim import OPTIMIZER_REGISTRY
    from ptyrad_tpu_torch.optim import OPTIMIZER_REGISTRY_NAMES

    assert sorted(OPTIMIZER_REGISTRY_NAMES) == sorted(OPTIMIZER_REGISTRY)
