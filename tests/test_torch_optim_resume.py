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
"""

import numpy as np
import pytest
import torch

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
            ("Adafactor", {}, 1), ("Adam", {}, 2)]


def keyed(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat if hasattr(x, "shape")}


def fourth_gradient():
    rng = np.random.default_rng(0)
    values(rng)
    return [values(rng) for _ in range(4)][3]


@pytest.mark.parametrize("name, configs, k", FAMILIES,
                         ids=["SGD-momentum", "AdamW", "Adafactor", "MultiSteps-Adam"])
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
