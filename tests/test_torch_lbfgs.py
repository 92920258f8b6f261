"""LBFGS as the JAX package runs it (optax.lbfgs: the two-loop recursion
and the zoom line search, over every optimized tensor at the smallest
nonzero lr), ported in ptyrad_tpu_torch/optim_lbfgs.py.

On a seeded quadratic both packages take 4 steps from the same point: the
values at rtol 1e-6, the parameters at rtol 1e-6 (atol 1e-6 of each
tensor's largest entry) and the same line-search steps each step. Its
checkpoint (the JAX package's keystr layout) goes both ways through
model.hdf5. In the solver (the small tBL run of
tests/torch_port_helpers.py, 3 iterations) the losses agree at rtol 1e-4
with the same line-search steps per iteration; the two packages took the
same line-search branches at every step here, so the trajectory, not only
convergence, is held. Then the JAX package's solver tests, mirrored:
tests/test_engine.py:1027 (start_iter inside the objective), :618 (the
micro-batched objective is the batch mean) and :1048 (never wrapped in
MultiSteps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from ptyrad_tpu.optim import create_optimizer as j_create_optimizer
from ptyrad_tpu.optim import load_opt_state_hdf5 as j_load_opt_state_hdf5
from ptyrad_tpu.save import save_dict_to_hdf5 as j_save_dict_to_hdf5
from ptyrad_tpu_torch import optim as O
from ptyrad_tpu_torch.engine.solver import loss_fn
from ptyrad_tpu_torch.load import load_hdf5
from ptyrad_tpu_torch.models.state import PARAM_NAMES, PtychoParams
from ptyrad_tpu_torch.optim_lbfgs import LBFGS
from ptyrad_tpu_torch.save import save_dict_to_hdf5
from test_torch_optim import jax_numpy, jax_params, values
from torch_port_helpers import both_solvers, losses, np_, small_dataset, small_params

UPDATE = {"obja": {"lr": 1e-3}, "objp": {"lr": 2e-3}, "probe": {"lr": 1e-2},
          "probe_pos_shifts": {"lr": 1e-2}, "obj_tilts": {"lr": 0}, "slice_thickness": {"lr": 1e-3}}


def quadratic(seed=4):
    """Weights and targets of f = sum over leaves of 0.5 c (x - t)^2, the
    complex probe as its (re, im) pair."""
    rng = np.random.default_rng(seed)
    return {k: (np.abs(v.real) + 0.1 * rng.random(v.shape)).astype(np.float32)
            for k, v in values(rng).items()}, values(rng)


def jax_quadratic(c, t):
    def f(p):
        total = 0.0
        for k in PARAM_NAMES:
            if k == "probe":
                total += 0.5 * jnp.sum(c[k] * ((p.probe.re - t[k].real) ** 2
                                               + (p.probe.im - t[k].imag) ** 2))
            else:
                total += 0.5 * jnp.sum(c[k] * (getattr(p, k) - t[k]) ** 2)
        return total
    return f


def torch_objective(params, c, t):
    def objective():
        for _, x in params.named():
            x.grad = None
        total = torch.zeros(())
        for k, x in params.named():
            x = x if x.requires_grad else x.detach()
            d = x - torch.tensor(t[k])
            sq = d.real ** 2 + d.imag ** 2 if d.is_complex() else d ** 2
            total = total + 0.5 * torch.sum(torch.tensor(c[k]) * sq)
        total.backward()
        return total.detach(), {k: x.grad if x.grad is not None else torch.zeros_like(x)
                                for k, x in params.named()}
    return objective


def start_point():
    return values(np.random.default_rng(0))


def jax_steps(n):
    """n optax steps; returns (params, state, [(value, line-search steps)],
    the params and state after 3 steps)."""
    c, t = quadratic()
    f = jax_quadratic(c, t)
    jp = jax_params(start_point())
    tx, st, _, _ = j_create_optimizer({"name": "LBFGS"}, UPDATE, jp)
    out, at3 = [], None
    for i in range(n):
        value, grad = optax.value_and_grad_from_state(f)(jp, state=st)
        updates, st = tx.update(grad, st, jp, value=value, grad=grad, value_fn=f)
        jp = optax.apply_updates(jp, updates)
        out.append((float(value), int(st[1][2].info.num_linesearch_steps)))
        if i == 2:
            at3 = (jp, st)
    return jp, st, out, at3


def torch_steps(n, opt=None, params=None):
    c, t = quadratic()
    if params is None:
        params = PtychoParams(**{k: torch.tensor(a) for k, a in start_point().items()})
    if opt is None:
        opt, _, _ = O.create_optimizer({"name": "LBFGS"}, UPDATE, params)
    out = []
    for _ in range(n):
        value = opt.step(torch_objective(params, c, t))
        out.append((float(value), opt.info["num_linesearch_steps"]))
    return params, opt, out


@pytest.fixture(scope="module")
def quadratic_runs():
    return jax_steps(4), torch_steps(4)


def test_quadratic_steps_match_optax(quadratic_runs):
    (jp, _, ref, _), (params, opt, ours) = quadratic_runs
    assert isinstance(opt, LBFGS) and opt.learning_rate == 1e-3
    np.testing.assert_allclose([v for v, _ in ours], [v for v, _ in ref], rtol=1e-6)
    assert [s for _, s in ours] == [s for _, s in ref]
    want = jax_numpy(jp)
    for k, x in params.named():
        # atol: iterates that pass near zero keep the rounding of O(1) steps
        np.testing.assert_allclose(np_(x), want[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[k]).max(), err_msg=k)


def test_weight_decay_is_coupled_as_optax_chains_it():
    """weight_decay: the JAX package chains optax.add_decayed_weights after
    the lr-0 mask and ahead of optax.lbfgs, so every tensor (obj_tilts at
    lr 0 included) takes wd x into its gradient and moves; 3 steps at the
    quadratic test's tolerances, and the state's keys one chain deeper."""
    cfg = {"name": "LBFGS", "configs": {"weight_decay": 0.05}}
    c, t = quadratic()
    f = jax_quadratic(c, t)
    jp = jax_params(start_point())
    tx, st, _, _ = j_create_optimizer(cfg, UPDATE, jp)
    params = PtychoParams(**{k: torch.tensor(a) for k, a in start_point().items()})
    opt, _, _ = O.create_optimizer(cfg, UPDATE, params)
    for _ in range(3):
        value, grad = optax.value_and_grad_from_state(f)(jp, state=st)
        updates, st = tx.update(grad, st, jp, value=value, grad=grad, value_fn=f)
        jp = optax.apply_updates(jp, updates)
        ours = opt.step(torch_objective(params, c, t))
        assert float(ours) == pytest.approx(float(value), rel=1e-6)
        assert opt.info["num_linesearch_steps"] == int(st[1][1][2].info.num_linesearch_steps)
    want = jax_numpy(jp)
    assert not np.array_equal(np_(params.obj_tilts), start_point()["obj_tilts"])
    for k, x in params.named():
        np.testing.assert_allclose(np_(x), want[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[k]).max(), err_msg=k)
    flat, _ = jax.tree_util.tree_flatten_with_path(st)
    assert {jax.tree_util.keystr(p) for p, x in flat if hasattr(x, "shape")} == \
        set(O.optim_state_values(opt))


def test_checkpoint_both_ways(quadratic_runs, tmp_path):
    """The port's state after 3 steps through model.hdf5 into the JAX
    package's reader: every array equal bit for bit; the JAX package's
    state (after its own 3 steps) into the port's reader likewise; and the
    port's state through the JAX package (read, flattened, written again)
    back into the port: the next step equal bit for bit to the
    uninterrupted one."""
    params, opt, _ = torch_steps(3)
    ours = O.optim_state_values(opt)
    path = str(tmp_path / "ours.hdf5")
    save_dict_to_hdf5({"optim_state_dict": ours}, path)
    jp3 = jax_params({k: np_(x) for k, x in params.named()})
    tx, template, _, _ = j_create_optimizer({"name": "LBFGS"}, UPDATE, jp3)
    restored = j_load_opt_state_hdf5(template, path)
    flat, _ = jax.tree_util.tree_flatten_with_path(restored)
    theirs = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat if hasattr(x, "shape")}
    assert sorted(theirs) == sorted(ours)
    for k in ours:
        np.testing.assert_array_equal(theirs[k], np.asarray(ours[k]).astype(theirs[k].dtype), k)

    back = str(tmp_path / "back.hdf5")
    j_save_dict_to_hdf5({"optim_state_dict": theirs}, back)
    fresh_params = PtychoParams(**{k: x.detach().clone() for k, x in params.named()})
    fresh, _, _ = O.create_optimizer({"name": "LBFGS"}, UPDATE, fresh_params)
    O.load_opt_state_hdf5(fresh, back)
    _, _, nxt = torch_steps(1, fresh, fresh_params)
    _, _, uninterrupted = torch_steps(1, opt, params)
    assert nxt == uninterrupted
    for (k, a), (_, b) in zip(fresh_params.named(), params.named()):
        np.testing.assert_array_equal(np_(a), np_(b), k)

    jp, jstate = quadratic_runs[0][3]
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    jvals = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat if hasattr(x, "shape")}
    jpath = str(tmp_path / "theirs.hdf5")
    j_save_dict_to_hdf5({"optim_state_dict": jvals}, jpath)
    p2 = PtychoParams(**{k: torch.tensor(v) for k, v in jax_numpy(jp).items()})
    opt2, _, _ = O.create_optimizer({"name": "LBFGS"}, UPDATE, p2)
    O.load_opt_state_values(opt2, load_hdf5(jpath, key="optim_state_dict"))
    got = O.optim_state_values(opt2)
    for k, v in jvals.items():
        np.testing.assert_array_equal(np.asarray(got[k]).astype(v.dtype), v, k)


@pytest.fixture(scope="module")
def dataset():
    return small_dataset()


def test_solver_trajectory_matches_jax(dataset):
    """3 LBFGS iterations (history_size 10) on the small tBL run: the
    losses at rtol 1e-4 and the same line-search steps each iteration."""
    params = small_params({"name": "LBFGS", "configs": {"history_size": 10, "max_iter": 20}})
    js, ts = both_solvers(params, dataset)
    j_steps = []
    js.run(callback=lambda n, p, h, opt_state=None: j_steps.append(
        int(opt_state[1][2].info.num_linesearch_steps)))
    ts.run()
    np.testing.assert_allclose(losses(ts), losses(js), rtol=1e-4)
    assert [s for _, s, _ in ts.history.linesearch] == j_steps
    assert all(e >= s for _, s, e in ts.history.linesearch)


def test_lbfgs_respects_start_iter(dataset):
    """A tensor with start_iter 5 does not move in iteration 1, even inside
    the line search's evaluations (tests/test_engine.py:1027)."""
    params = small_params({"name": "LBFGS"}, niter=1, update={
        "obja": {"start_iter": 5, "lr": 1e-2}, "objp": {"start_iter": 1, "lr": 1e-2}})
    _, ts = both_solvers(params, dataset)
    ts.prepare()
    ts._build()
    obja0, objp0 = np_(ts.params.obja).copy(), np_(ts.params.objp).copy()
    idx = torch.as_tensor(ts.batch_idx)
    mask = torch.as_tensor(ts.batch_mask)
    ts.optimizer.step(ts.lbfgs_objective(idx, mask, 1))
    np.testing.assert_array_equal(np_(ts.params.obja), obja0)
    assert not np.array_equal(np_(ts.params.objp), objp0)


def test_lbfgs_microbatched_objective_is_exact_batch_mean(dataset):
    """The first step's value is the mean of the per-batch losses at the
    start parameters (tests/test_engine.py:618)."""
    _, ts = both_solvers(small_params({"name": "LBFGS"}, niter=1), dataset)
    ts.prepare()
    ts._build()
    with torch.no_grad():
        totals = [float(loss_fn(ts.params, ts.buffers, ts.geom, torch.as_tensor(i),
                                torch.as_tensor(m), ts.loss_params)[0])
                  for i, m in zip(ts.batch_idx, ts.batch_mask)]
    ts.run()
    assert losses(ts)[0] == pytest.approx(float(np.mean(totals)), rel=1e-6)


def test_lbfgs_ignores_grad_accumulation_wrapper(dataset):
    """grad_accumulation never wraps LBFGS (tests/test_engine.py:1048): its
    step is already a full-dataset objective."""
    _, ts = both_solvers(small_params({"name": "LBFGS"}, grad_accumulation=4), dataset)
    ts.prepare()
    ts._build()
    assert isinstance(ts.optimizer, LBFGS) and not isinstance(ts.optimizer, O.MultiSteps)
