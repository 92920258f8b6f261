"""The optimizers inside the solver, against the JAX package's solver on the
same small tBL run (tests/torch_port_helpers.small_params: 11 scans in
batches of 4, 4 and 3, 3 iterations): trajectories of four families, the
start-iter mask of the updates, and gradient accumulation (optax.MultiSteps
in the JAX package, optim.MultiSteps here), whose running mean and
mini-step counter carry across iterations (3 batches an iteration is no
multiple of 2). A params file's optax configs (mu_dtype, nesterov) load,
validate and run alike.
"""

import copy

import numpy as np
import pytest
import torch

from ptyrad_tpu_torch import optim as O
from ptyrad_tpu_torch.engine.solver import RankBatches, build_train_epoch
from ptyrad_tpu_torch.models import make_model
from test_torch_optim import jax_numpy, run_both, STEPS
from torch_port_helpers import CPU, both_solvers, losses, np_, small_dataset, small_params


@pytest.fixture(scope="module")
def dataset():
    return small_dataset()


TRAJECTORIES = [
    ({"name": "Adam", "configs": {"weight_decay": 1e-3}}, 1.0),
    ({"name": "AdamW", "configs": {"weight_decay": 0.1}}, 1.0),
    ({"name": "SGD", "configs": {"momentum": 0.9}}, 100.0),  # SGD steps by lr x gradient
    ({"name": "Adafactor"}, 1.0),
]


@pytest.mark.parametrize("optimizer_params, lr_scale", TRAJECTORIES,
                         ids=["Adam-weight_decay", "AdamW", "SGD-momentum", "Adafactor"])
def test_trajectory_matches_jax(dataset, optimizer_params, lr_scale):
    """3 iterations of every batch and constraint on both sides: the losses
    at rtol 1e-4."""
    js, ts = both_solvers(small_params(optimizer_params, lr_scale=lr_scale), dataset)
    js.run()
    ts.run()
    np.testing.assert_array_equal(ts.batch_idx, js.batch_idx)
    ours, ref = losses(ts), losses(js)
    assert len(ours) == len(ref) == 3 and ours[-1] < ours[0]
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_adamw_decay_waits_for_start_iter(dataset):
    """AdamW's decoupled decay must not move a tensor before its start_iter
    (the JAX package masks the updates as well as the gradients,
    ptyrad_tpu/engine/solver.py:84-90): obja (start_iter 2) is unchanged bit
    for bit after iteration 1 and moves in iteration 2."""
    params = small_params({"name": "AdamW", "configs": {"weight_decay": 0.5}}, niter=2,
                          update={"obja": {"start_iter": 2, "lr": 5.0e-4}})
    params["constraint_params"] = {}
    _, ts = both_solvers(params, dataset)
    obja0 = np_(ts.params.obja).copy()
    seen = {}
    ts.run(callback=lambda n, p, h: seen.__setitem__(n, np_(p.obja).copy()))
    np.testing.assert_array_equal(seen[1], obja0)
    assert not np.array_equal(seen[2], obja0)


@pytest.mark.parametrize("name, configs, k", [("Adam", {}, 2), ("SGD", {"momentum": 0.9}, 3),
                                              ("Adafactor", {}, 2)])
def test_multisteps_matches_optax(name, configs, k):
    """grad_accumulation k on seeded gradients (tests/test_torch_optim.py's
    setting): optax.MultiSteps' running mean, one inner step every k-th
    gradient, and its state (mini_step, gradient_step, acc_grads,
    inner_opt_state) under the JAX package's keys after 5 gradients, a
    remainder left in the mean."""
    jp, state, params, opt = run_both(name, configs, grad_accumulation=k)
    assert isinstance(opt, O.MultiSteps) and opt.mini_step == STEPS % k
    assert opt.gradient_step == STEPS // k
    ref = jax_numpy(jp)
    for key, t in params.named():
        np.testing.assert_allclose(np_(t), ref[key], rtol=1e-6, err_msg=key)
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat if hasattr(x, "shape")}
    ours = O.optim_state_values(opt)
    assert sorted(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                   np.asarray(want[key], np.float64), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want[key]).max(initial=0.0)),
                                   err_msg=key)


@pytest.mark.parametrize("k", [2, 3])
def test_grad_accumulation_run_matches_multisteps(dataset, k):
    """The solver with grad_accumulation k against the JAX package's
    MultiSteps run: 3 iterations of 3 batches, losses at rtol 1e-5, and the
    mini-step counter carried over the 9 batches as optax carries it."""
    js, ts = both_solvers(small_params({"name": "Adam"}, grad_accumulation=k), dataset)
    js.run()
    ts.run()
    np.testing.assert_allclose(losses(ts), losses(js), rtol=1e-5)
    assert ts.optimizer.mini_step == int(js.opt_state.mini_step) == 9 % k
    assert ts.optimizer.gradient_step == int(js.opt_state.gradient_step) == 9 // k
    steps = {float(s["step"]) for s in ts.optimizer.state.values()}
    assert steps == {9 // k}


def test_grad_accumulation_matches_big_batch(dataset):
    """One SGD step over 2 accumulated half-batches against one over the
    full batch (tests/test_engine.py:653): MultiSteps averages the half
    batches' gradients; the full-batch loss is their mean only
    approximately (the loss is nonlinear in the batch), so the two updates
    are held to a correlation above 0.95."""
    upd = {"objp": {"lr": 1e-2, "start_iter": 1}}
    idx = torch.arange(8)[None]
    mask = torch.ones(1, 8)
    deltas = []
    for k, shape in ((1, (1, 8)), (2, (2, 4))):
        params, buffers, geom = make_model(copy.deepcopy(dataset), {"update_params": upd},
                                           device=CPU)
        before = np_(params.objp).copy()
        opt, _, start = O.create_optimizer({"name": "SGD"}, upd, params, grad_accumulation=k)
        epoch = build_train_epoch(params, RankBatches(params, buffers, geom), None, opt, start)
        epoch(idx.reshape(shape), mask.reshape(shape), 1)
        deltas.append((np_(params.objp) - before).ravel())
    assert np.abs(deltas[1]).max() > 0
    assert np.corrcoef(deltas[0], deltas[1])[0, 1] > 0.95


def test_optax_configs_from_a_yml_run_alike(dataset, tmp_path):
    """The minimal tBL yml with optimizer_params.configs {mu_dtype:
    bfloat16, nesterov: true} validates to the same optimizer_params in
    both packages; one iteration of the small run with them (the port's
    AdamRule, bfloat16 moments) gives the JAX solver's loss at rtol 1e-4
    (its jitted step may skip a bfloat16 rounding that the eager rule
    makes: tests/test_torch_optim.py::test_jitted_update_stays_within_two_bf16_steps)."""
    import yaml

    from ptyrad_tpu.load import load_params as j_load_params
    from ptyrad_tpu_torch.load import load_params
    from test_torch_params import ROOT, assert_same

    raw = load_params(str(ROOT / "demo" / "params" / "tBL_WSe2_reconstruct_minimal.yml"),
                      validate=False)
    raw.setdefault("model_params", {})["optimizer_params"] = {
        "name": "Adam", "configs": {"mu_dtype": "bfloat16", "nesterov": True}}
    path = tmp_path / "adam_bf16.yml"
    path.write_text(yaml.safe_dump(raw))
    ours = load_params(str(path))["model_params"]["optimizer_params"]
    assert_same(ours, j_load_params(str(path))["model_params"]["optimizer_params"])
    assert ours["configs"] == {"mu_dtype": "bfloat16", "nesterov": True}
    js, ts = both_solvers(small_params(ours, niter=1), dataset)
    js.run()
    ts.run()
    assert isinstance(ts.optimizer, O.AdamRule)
    assert {t.dtype for st in ts.optimizer.state.values() for t in st["mu"]} == {torch.bfloat16}
    np.testing.assert_allclose(losses(ts), losses(js), rtol=1e-4)
