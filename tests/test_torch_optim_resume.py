"""Checkpoints of the optimizers' state through model.hdf5, both ways, one
family per state shape: SGD with momentum (a trace), AdamW (count and two
moments in the JAX package's keystr layout), Adafactor (factored and full
second moments), Adam with gradient accumulation (MultiSteps: its counters,
running mean and inner state). LBFGS's is in tests/test_torch_lbfgs.py.

On tests/test_torch_optim.py's seeded gradients, after 3 steps: the port's
state, written by the port, read by the JAX package equals it array for
array, bit for bit; written back by the JAX package and read by a fresh
port optimizer, it gives a 4th step equal bit for bit to the uninterrupted
one; and the JAX package's own state after its 3 steps reads into the port
bit for bit. A plain Adam checkpoint into an accumulating optimizer raises
"mismatch" in both packages.

Adam with mu_dtype float16 (optim.AdamRule, the moment stored as float16)
does the same both ways, bit for bit. A bfloat16 moment (mu_dtype
bfloat16) is written by both packages as the same opaque 2-byte ('|V2')
dataset of its raw bits, which neither reader casts back: both raise
ValueError on it, and both solvers warn "failed to restore optimizer
state" and start fresh (reference behaviour, kept).
"""

import logging

import numpy as np
import pytest
import torch

import h5py
import jax
from ptyrad_tpu.optim import create_optimizer as j_create_optimizer
from ptyrad_tpu.optim import load_opt_state_hdf5 as j_load_opt_state_hdf5
from ptyrad_tpu.save import save_dict_to_hdf5 as j_save_dict_to_hdf5
from ptyrad_tpu_torch import optim as O
from ptyrad_tpu_torch.models.state import PtychoParams
from ptyrad_tpu_torch.save import save_dict_to_hdf5
from test_torch_optim import UPDATE, jax_numpy, jax_params, run_both, torch_step, values
from torch_port_helpers import np_

FAMILIES = [("SGD", {"momentum": 0.9}, 1), ("AdamW", {"weight_decay": 0.1}, 1),
            ("Adafactor", {}, 1), ("Adam", {}, 2), ("Adam", {"mu_dtype": "float16"}, 1)]


def keyed(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat if hasattr(x, "shape")}


def fourth_gradient():
    rng = np.random.default_rng(0)
    values(rng)
    return [values(rng) for _ in range(4)][3]


@pytest.mark.parametrize("name, configs, k", FAMILIES,
                         ids=["SGD-momentum", "AdamW", "Adafactor", "MultiSteps-Adam",
                              "Adam-mu_dtype-float16"])
def test_checkpoint_both_ways(name, configs, k, tmp_path):
    cfg = {"name": name, "configs": dict(configs)}
    jp, jstate, params, opt = run_both(name, configs, grad_accumulation=k, steps=3)
    ours = O.optim_state_values(opt)
    assert "state" not in ours  # not upstream's Adam layout: the keystr one
    path = str(tmp_path / "ours.hdf5")
    save_dict_to_hdf5({"optim_state_dict": ours}, path)

    here = jax_params({key: np_(t) for key, t in params.named()})
    _, template, _, _ = j_create_optimizer(cfg, UPDATE, here, grad_accumulation=k)
    theirs = keyed(j_load_opt_state_hdf5(template, path, UPDATE))
    assert sorted(theirs) == sorted(ours)
    for key in ours:
        assert theirs[key].dtype == np.asarray(ours[key]).dtype, key
        np.testing.assert_array_equal(theirs[key], np.asarray(ours[key]).astype(theirs[key].dtype),
                                      key)

    back = str(tmp_path / "back.hdf5")
    j_save_dict_to_hdf5({"optim_state_dict": theirs}, back)
    fresh_params = PtychoParams(**{key: t.detach().clone() for key, t in params.named()})
    fresh, _, start = O.create_optimizer(cfg, UPDATE, fresh_params, grad_accumulation=k)
    O.load_opt_state_hdf5(fresh, back)
    g4 = fourth_gradient()
    torch_step(fresh, fresh_params, g4, 4, start)
    torch_step(opt, params, g4, 4, start)
    for (key, a), (_, b) in zip(fresh_params.named(), params.named()):
        np.testing.assert_array_equal(np_(a), np_(b), key)

    jpath = str(tmp_path / "theirs.hdf5")
    j_save_dict_to_hdf5({"optim_state_dict": keyed(jstate)}, jpath)
    p2 = PtychoParams(**{key: torch.tensor(v) for key, v in jax_numpy(jp).items()})
    opt2, _, _ = O.create_optimizer(cfg, UPDATE, p2, grad_accumulation=k)
    O.load_opt_state_hdf5(opt2, jpath)
    got = O.optim_state_values(opt2)
    for key, v in keyed(jstate).items():
        np.testing.assert_array_equal(np.asarray(got[key]).astype(v.dtype), v, key)


def test_plain_adam_into_accumulation_is_a_mismatch(tmp_path):
    """A plain Adam checkpoint (the port's: upstream's torch layout) into
    grad_accumulation 2 raises "mismatch" in both packages
    (tests/test_engine.py:728)."""
    _, _, _, opt = run_both("Adam", {}, steps=2)
    path = str(tmp_path / "adam.hdf5")
    save_dict_to_hdf5({"optim_state_dict": O.optim_state_values(opt)}, path)
    v = values(np.random.default_rng(0))
    _, template, _, _ = j_create_optimizer({"name": "Adam"}, UPDATE, jax_params(v),
                                           grad_accumulation=2)
    with pytest.raises(ValueError, match="mismatch"):
        j_load_opt_state_hdf5(template, path, UPDATE)
    params = PtychoParams(**{key: torch.tensor(a) for key, a in v.items()})
    acc, _, _ = O.create_optimizer({"name": "Adam"}, UPDATE, params, grad_accumulation=2)
    with pytest.raises(O.OptStateMismatchError, match="mismatch"):
        O.load_opt_state_hdf5(acc, path)


def datasets(path) -> dict:
    """{name: (dtype string, raw bytes)} of every dataset of a file's
    optim_state_dict."""
    out = {}
    with h5py.File(path, "r") as f:
        f["optim_state_dict"].visititems(lambda name, d: out.__setitem__(
            name, (d.dtype.str, d[()].tobytes())) if isinstance(d, h5py.Dataset) else None)
    return out


def test_bf16_state_written_alike_and_read_by_neither(tmp_path):
    """Adam with mu_dtype bfloat16 after 3 steps: the port's model.hdf5
    state and the JAX package's hold the same datasets of the same types,
    the first moments as '|V2' with the same bytes; each package's reader raises ValueError on
    either file and leaves the state as it was."""
    cfg = {"name": "Adam", "configs": {"mu_dtype": "bfloat16"}}
    jp, jstate, params, opt = run_both("Adam", cfg["configs"], steps=3)
    ours, theirs = str(tmp_path / "ours.hdf5"), str(tmp_path / "theirs.hdf5")
    save_dict_to_hdf5({"optim_state_dict": O.optim_state_values(opt)}, ours)
    j_save_dict_to_hdf5({"optim_state_dict": keyed(jstate)}, theirs)
    a, b = datasets(ours), datasets(theirs)
    assert {k: dt for k, (dt, _) in a.items()} == {k: dt for k, (dt, _) in b.items()}
    moments = sorted(k for k, (dt, _) in a.items() if dt == "|V2")
    assert moments == sorted(k for k in a if ".mu." in k)
    for k in moments:  # the float32 arrays agree at test_torch_optim.py's tolerance
        assert a[k][1] == b[k][1], k
    here = jax_params({key: np_(t) for key, t in params.named()})
    _, template, _, _ = j_create_optimizer(cfg, UPDATE, here)
    before = O.optim_state_values(opt)
    for path in (ours, theirs):
        with pytest.raises(ValueError, match="No cast function available"):
            j_load_opt_state_hdf5(template, path, UPDATE)
        with pytest.raises(ValueError, match="No cast function available"):
            O.load_opt_state_hdf5(opt, path)
        after = O.optim_state_values(opt)
        for key, v in before.items():
            assert np.asarray(after[key]).tobytes() == np.asarray(v).tobytes(), key


def test_bf16_state_does_not_resume_in_either_solver(tmp_path, capsys, monkeypatch):
    """A solver's own bfloat16 Adam state (tests/torch_port_helpers.py's
    small run, 1 iteration) given back as optimizer_params.load_state: both
    solvers warn "failed to restore optimizer state" and start from a fresh
    state (the step count 0)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from torch_port_helpers import both_solvers, small_dataset, small_params

    for logger in ("ptyrad_tpu", "ptyrad_tpu_torch"):
        monkeypatch.setattr(logging.getLogger(logger), "handlers", [])
    init = small_dataset()
    params = small_params({"name": "Adam", "configs": {"mu_dtype": "bfloat16"}}, niter=1)
    first = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False)
    first.run()
    path = str(tmp_path / "model.hdf5")
    save_dict_to_hdf5({"optim_state_dict": O.optim_state_values(first.optimizer)}, path)
    params["model_params"]["optimizer_params"]["load_state"] = path
    js, ts = both_solvers(params, init)
    capsys.readouterr()
    for solver in (ts, js):
        solver.prepare()
        solver._build()
        out = capsys.readouterr().out
        assert f"failed to restore optimizer state from '{path}'" in out, out
        assert "Using fresh state" in out
    counts = [int(np.asarray(v)) for k, v in keyed(js.opt_state).items() if k.endswith(".count")]
    assert counts and not any(counts)
    assert all(v == 0 for k, v in O.optim_state_values(ts.optimizer).items()
               if k.endswith(".count"))


@pytest.mark.parametrize("saved, resumed", [({}, {"nesterov": True}), ({"nesterov": True}, {})],
                         ids=["torch-layout-into-AdamRule", "keystr-layout-into-torch-Adam"])
def test_adam_resumes_across_its_two_layouts(saved, resumed, tmp_path):
    """Adam is torch's Adam (upstream's torch layout) at optax's defaults
    and optim.AdamRule (the keystr layout) with nesterov: a checkpoint of
    either, through model.hdf5, resumes the other in the port and in the
    JAX package, every count and moment equal to the saved one."""
    _, _, params, opt = run_both("Adam", saved, steps=3)
    path = str(tmp_path / "adam.hdf5")
    save_dict_to_hdf5({"optim_state_dict": O.optim_state_values(opt)}, path)
    names = [g["name"] for g in opt.param_groups]
    want = O.optim_state_values(opt)
    if "state" in want:
        want = O.torch_layout_to_keystr(want, names)
    cfg = {"name": "Adam", "configs": resumed}
    fresh, _, _ = O.create_optimizer(
        cfg, UPDATE, PtychoParams(**{k: t.detach().clone() for k, t in params.named()}))
    assert isinstance(fresh, torch.optim.Adam) == (not resumed)
    O.load_opt_state_hdf5(fresh, path)
    got = O.optim_state_values(fresh)
    if "state" in got:
        got = O.torch_layout_to_keystr(got, names)
    here = jax_params({key: np_(t) for key, t in params.named()})
    _, template, _, _ = j_create_optimizer(cfg, UPDATE, here)
    theirs = keyed(j_load_opt_state_hdf5(template, path, UPDATE))
    canon = {O._canonical_key(k): v for k, v in want.items()}
    for result in (got, theirs):
        mine = {O._canonical_key(k): v for k, v in result.items()}
        assert sorted(mine) == sorted(canon)
        for key, v in canon.items():
            np.testing.assert_array_equal(np.asarray(mine[key], np.float32),
                                          np.asarray(v, np.float32), str(key))
