"""ptyrad_tpu_torch.utils.dev_tools against ptyrad_tpu.utils.dev_tools on
the CPU, on the same seeded inputs.

Mirrors tests/test_utils_extra.py's TestDevTools (:85-133) and its LCM
check (:198-207). ``test_loss_fn`` and ``test_constraint_fn`` are imported
under other names, so pytest does not collect them. The loss smoke run's
terms and total are held at rtol 1e-5 against the JAX one's on the JAX
package's parameters carried across by ``params_from_numpy``; the
constraint smoke run's per-tensor max |delta| at rtol 1e-5 (atol 1e-7)
against the JAX one's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.utils import dev_tools as jdt
from ptyrad_tpu_torch.models import make_model
from ptyrad_tpu_torch.models.state import params_from_numpy
from ptyrad_tpu_torch.utils import dev_tools as dt
from ptyrad_tpu_torch.utils.dev_tools import test_constraint_fn as constraint_smoke
from ptyrad_tpu_torch.utils.dev_tools import test_loss_fn as loss_smoke
from torch_port_helpers import CPU, jax_params_numpy, toy_init

LOSSES = {
    "single": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}},
    "poissn_pacbed_sparse": {
        "loss_single": {"state": False},
        "loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
        "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2},
        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}},
}
CONSTRAINTS = {
    "obja_thresh": {"freq": 1, "relax": 0.0, "thresh": [0.98, 1.02]},
    "objp_postiv": {"freq": 2, "relax": 0.0, "mode": "clip_neg"},
    "obj_rblur": {"freq": 3, "obj_type": "both", "kernel_size": 5, "std": 0.5},
    "fix_probe_int": {"freq": 2},
}


def both_models(seed: int = 0):
    """The JAX package's (params, buffers, geom) of a toy init and the
    port's, its parameters the JAX ones carried across."""
    init = toy_init(np.random.default_rng(seed), n_scans=12, npix=16, nz=3, pmode=2)
    jp, jb, jg = j_make_model(init)
    _, tb, tg = make_model(init, None, device=CPU)
    tp = params_from_numpy(jax_params_numpy(jp), CPU)
    return (jp, jb, jg), (tp, tb, tg)


def test_nan_checker():
    clean = {"a": np.ones(3), "b": {"c": torch.zeros(2)}}
    assert dt.check_nan_inf(clean)
    dirty = {"a": torch.tensor([1.0, float("nan")])}
    assert not dt.check_nan_inf(dirty)
    with pytest.raises(FloatingPointError, match=r"tree\['a'\]: 1 NaN, 0 Inf"):
        dt.check_nan_inf(dirty, raise_on_bad=True)
    assert not dt.check_nan_inf({"z": torch.tensor([1 + 1j, complex("inf")])})
    assert dt.check_nan_inf({"i": torch.arange(3)})


def test_nan_checker_walks_params_and_buffers_as_jax_does():
    """The same verdict on the port's PtychoParams and Buffers as the JAX
    checker on the JAX package's, clean and with a NaN planted in objp."""
    (jp, jb, _), (tp, tb, _) = both_models()
    for tree, jtree in ((tp, jp), (tb, jb)):
        assert dt.check_nan_inf(tree) == jdt.check_nan_inf(jtree) is True
    bad = dataclasses.replace(tp, objp=tp.objp.clone())
    bad.objp[0, 0, 3, 4] = float("nan")
    jbad = dataclasses.replace(jp, objp=jp.objp.at[0, 0, 3, 4].set(np.nan))
    with pytest.raises(FloatingPointError, match=r"params\.objp: 1 NaN"):
        dt.check_nan_inf(bad, name="params", raise_on_bad=True)
    assert dt.check_nan_inf(bad) == jdt.check_nan_inf(jbad) is False


def test_tree_sizes_count_every_byte():
    (_, _, _), (tp, tb, _) = both_models()
    want = sum(t.numel() * t.element_size() for _, t in tp.named())
    assert dt.print_tree_sizes(tp, "params") == want
    assert dt.print_tree_sizes({"a": np.zeros((2, 3), np.float32), "b": [torch.zeros(4)]}) == 40
    assert dt.print_tree_sizes(tb) > tb.measurements.numel() * 4


def test_modes_ortho_checker():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((64, 3)) + 1j * rng.standard_normal((64, 3)))
    ortho = q.T.reshape(3, 8, 8).astype(np.complex64)
    assert dt.check_modes_ortho(ortho) == jdt.check_modes_ortho(ortho) is True
    assert dt.check_modes_ortho(torch.as_tensor(ortho))
    not_ortho = (rng.standard_normal((3, 8, 8)) + 1j * rng.standard_normal((3, 8, 8)))
    not_ortho = not_ortho.astype(np.complex64)
    assert dt.check_modes_ortho(not_ortho) == jdt.check_modes_ortho(not_ortho) is False


def test_yaml_to_json(tmp_path):
    import yaml

    ypath = tmp_path / "x.yml"
    ypath.write_text(yaml.safe_dump({"a": 1, "b": [1, 2]}))
    jpath = dt.yaml_to_json(str(ypath))
    assert json.loads(open(jpath).read()) == {"a": 1, "b": [1, 2]}
    assert jdt.yaml_to_json(str(ypath), str(tmp_path / "j.json")).endswith("j.json")
    assert json.loads((tmp_path / "j.json").read_text()) == json.loads(open(jpath).read())


def test_print_package_tree_walks_the_port(capsys):
    dt.print_package_tree()
    out = capsys.readouterr().out
    assert out.startswith("ptyrad_tpu_torch/") and "dev_tools.py" in out
    assert "fused_multislice.py" in out and "_build/" not in out  # the kernel library


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_loss_smoke_matches_jax(loss):
    (jp, jb, jg), (tp, tb, tg) = both_models()
    idx = np.arange(5)
    j_total, j_terms = jdt.test_loss_fn(jp, jb, jg, idx, LOSSES[loss])
    total, terms = loss_smoke(tp, tb, tg, idx, LOSSES[loss])
    assert sorted(terms) == sorted(j_terms)  # a jitted dict comes back sorted
    np.testing.assert_allclose(total, j_total, rtol=1e-5)
    for name, value in terms.items():
        np.testing.assert_allclose(value, j_terms[name], rtol=1e-5, atol=1e-12, err_msg=name)
    assert tp.objp.grad is None


def max_deltas_jax(before, after) -> dict:
    out = {}
    for name in ("obja", "objp", "probe_pos_shifts", "obj_tilts", "slice_thickness"):
        out[name] = float(np.abs(np.asarray(getattr(after, name))
                                 - np.asarray(getattr(before, name))).max())
    for part in ("re", "im"):
        out[f"probe.{part}"] = float(np.abs(np.asarray(getattr(after.probe, part))
                                            - np.asarray(getattr(before.probe, part))).max())
    return out


def max_deltas(before, after) -> dict:
    out = {name: float((getattr(after, name) - getattr(before, name)).abs().max())
           for name in ("obja", "objp", "probe_pos_shifts", "obj_tilts", "slice_thickness")}
    d = torch.view_as_real(after.probe - before.probe)
    out["probe.re"], out["probe.im"] = float(d[..., 0].abs().max()), float(d[..., 1].abs().max())
    return out


def test_constraint_smoke_deltas_match_jax():
    """The constraints at niter = lcm(1, 2, 3) = 6: every one fires; the
    per-tensor max |delta| equals the JAX one's, and the input is kept."""
    (jp, jb, jg), (tp, tb, tg) = both_models()
    kept = {name: t.clone() for name, t in tp.named()}
    after = constraint_smoke(tp, tb, tg, CONSTRAINTS)
    j_after = jdt.test_constraint_fn(jp, jb, jg, CONSTRAINTS)
    got, want = max_deltas(tp, after), max_deltas_jax(jp, j_after)
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-7, err_msg=name)
    assert got["obja"] > 0 and got["objp"] > 0 and got["probe.re"] > 0
    for name, t in tp.named():
        assert torch.equal(t, kept[name]), name


def test_constraint_fn_niter_covers_all_freqs():
    """A freq-2 constraint fires alongside a freq-3 one (niter = max(freqs)
    would skip it and report delta 0), as tests/test_utils_extra.py:198-207
    holds for the JAX package."""
    (_, _, _), (tp, tb, tg) = both_models()
    tp = dataclasses.replace(tp, objp=tp.objp - 1.0)  # negative phase
    out = constraint_smoke(tp, tb, tg, {
        "objp_postiv": {"freq": 2, "relax": 0.0, "mode": "clip_neg"},
        "obja_thresh": {"freq": 3, "relax": 0.0, "thresh": [0.99, 1.01]},
    })
    assert float(out.objp.min()) >= 0.0
    assert float(out.obja.max()) <= 1.01 + 1e-6


def test_time_sync_and_trace(tmp_path):
    """time_sync reads the clock after the given tensors' devices (here the
    CPU: nothing to wait for); trace writes a non-empty Chrome trace."""
    x = torch.ones(64, 64)
    t0 = dt.time_sync(x)
    with dt.trace(str(tmp_path / "tr")) as path:
        y = x @ x
    t1 = dt.time_sync({"y": y})
    assert t1 >= t0 and dt.time_sync() >= t1
    events = json.loads(open(path).read())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
