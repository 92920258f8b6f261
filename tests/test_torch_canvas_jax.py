"""Canvas sharding over ranks against the JAX package's canvas path
(ptyrad_tpu/parallel/canvas.py) on ``make_mesh(n)`` over the virtual CPU
devices.

The plan, the rebased positions and every iteration's per-slab batches
equal the JAX package's exactly (the same seeds, so the ranks of both
packages draw the same batches). The gloo ranks of
tests/torch_canvas_worker.py give the loss and gradients of every position
in one batch, held against ``jax.value_and_grad`` of
``build_canvas_sharded_loss`` (the dp route with its masked partial sums
and one psum; the port's fused route folds loss_single into B3's plain
twin) at the JAX package's TestCanvasSharding tolerances: the loss at rtol
1e-5, obja/objp gradients at atol 1e-5, the probe's at 1e-5 of its largest
entry, the shifts' at 1e-7; and a 3-iteration Adam run against the JAX
solver's SHARD_CANVAS run at rtol 1e-4, the cross-package trajectory
tolerance of tests/test_torch_dist.py.
"""

import types

import jax
import numpy as np
import pytest

from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.parallel import canvas as J
from ptyrad_tpu.parallel.mesh import make_mesh
from ptyrad_tpu_torch.parallel import canvas as C
from test_torch_canvas import run_ranks
from torch_canvas_worker import (N_SCANS, NITER, canvas_init, grads_params, variant)

GRAD_ATOL = {"obja": 1e-5, "objp": 1e-5, "probe_pos_shifts": 1e-7}
PROBE_RTOL = 1e-5
JAX_TRAJ_RTOL = 1e-4


def jax_store(plan):
    """The fields of the JAX package's CanvasStore that its
    canvas_iteration_batches reads."""
    return types.SimpleNamespace(plan=plan, cap=plan.b_local, store_valid=plan.mask.copy())


@pytest.mark.parametrize("world", [2, 3, 4])
def test_plan_positions_and_batches_match_jax(world):
    """plan_canvas_sharding, slab_local_positions and canvas_iteration_batches
    of iterations 0-3, on the canvas problem's raster and on a random
    INDICES_MODE subset (plan_canvas against the JAX solver's remap)."""
    crop_pos = canvas_init()["crop_pos"]
    ours, theirs = C.plan_canvas_sharding(crop_pos, 80, 16, world), \
        J.plan_canvas_sharding(crop_pos, 80, 16, world)
    for field in ("n_dev", "rows_local", "noy_pad", "halo", "b_local"):
        assert getattr(ours, field) == getattr(theirs, field), field
    np.testing.assert_array_equal(ours.pos_index, theirs.pos_index)
    np.testing.assert_array_equal(ours.mask, theirs.mask)
    args = (crop_pos, ours.pos_index, ours.rows_local, world, ours.b_local)
    np.testing.assert_array_equal(C.slab_local_positions(*args), J.slab_local_positions(*args))
    for niter in range(4):
        for n_batches in (1, 3, 7):
            for a, b in zip(C.canvas_iteration_batches(ours, n_batches, niter),
                            J.canvas_iteration_batches(jax_store(theirs), n_batches, niter)):
                np.testing.assert_array_equal(a, b)
    idx = np.sort(np.random.default_rng(world).choice(N_SCANS, 100, replace=False))
    sub = C.plan_canvas(crop_pos, idx, 80, 16, world)
    ref = J.plan_canvas_sharding(crop_pos[idx], 80, 16, world)
    np.testing.assert_array_equal(sub.pos_index, idx[ref.pos_index])


def test_too_many_ranks_raise_as_in_jax():
    pos = canvas_init()["crop_pos"]
    messages = []
    for module in (C, J):
        with pytest.raises(ValueError) as e:
            module.plan_canvas_sharding(pos, 80, 16, 6)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The gradient cases on 2 and 4 ranks and the no_ortho_pmode run on 2."""
    out = {}
    for world in (2, 4):
        cases = [["grads", {"route": r}] for r in ("fused", "forward")]
        if world == 2:
            cases.append(["train", {"name": "no_ortho_pmode"}])
        got = run_ranks(tmp_path_factory.mktemp(f"canvas_jax{world}"), world, cases)
        out[(world, "fused")], out[(world, "forward")] = got[:2]
        if world == 2:
            out["train"] = got[2]
    return out


def jax_canvas_grads(route: str, world: int) -> dict:
    """jax.value_and_grad of the JAX package's canvas-sharded loss of every
    position, on make_mesh(world)."""
    params = grads_params(route)
    jp, jb, jg = j_make_model(canvas_init(route), params["model_params"])
    plan = J.plan_canvas_sharding(np.asarray(jb.crop_pos), jg.obj_shape[2], jg.probe_shape[0],
                                  world)
    mesh = make_mesh(world)
    loss_fn, (pos_l, meas_l) = J.build_canvas_sharded_loss(jb, jg, mesh, plan,
                                                           params["loss_params"])
    total, g = jax.jit(jax.value_and_grad(loss_fn))(J.shard_canvas_params(jp, plan, mesh),
                                                    pos_l, meas_l)
    noy = jg.obj_shape[2]
    return {"total": float(total), "obja": J.unshard_canvas(g.obja, noy),
            "objp": J.unshard_canvas(g.objp, noy),
            "probe": np.stack([np.asarray(g.probe.re), np.asarray(g.probe.im)], -1),
            "probe_pos_shifts": np.asarray(g.probe_pos_shifts)}


CASES = [(r, n) for n in (2, 4) for r in ("fused", "forward")]


@pytest.mark.parametrize("route,world", CASES, ids=[f"{r}-{n}" for r, n in CASES])
def test_canvas_loss_and_gradients_match_the_jax_canvas_loss(ranks, route, world):
    ref = jax_canvas_grads(route, world)
    for r, out in enumerate(ranks[(world, route)]):
        np.testing.assert_allclose(out["total"], ref["total"], rtol=1e-5, err_msg=f"rank {r}")
        for name, atol in GRAD_ATOL.items():
            np.testing.assert_allclose(out[name], ref[name], rtol=0, atol=atol,
                                       err_msg=f"rank {r} of {world}: {name}")
        np.testing.assert_allclose(out["probe"], ref["probe"], rtol=0,
                                   atol=PROBE_RTOL * np.abs(ref["probe"]).max())


def test_two_ranks_follow_the_jax_canvas_solver(ranks):
    """3 Adam iterations with the constraints (obj_rblur through the
    whole-canvas bridge), JAX's PtyRADSolver on make_mesh(2) with
    shard_canvas against the port's 2 ranks: the same per-slab batches, the
    losses at rtol 1e-4."""
    from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver

    params, init = variant("no_ortho_pmode")
    solver = JaxSolver(params, init_variables=init, mesh=make_mesh(2), verbose=False)
    solver.run()
    ref = np.array([v for _, v in solver.history.loss_iters])
    assert len(ref) == NITER
    for r, out in enumerate(ranks["train"]):
        np.testing.assert_allclose(out["losses"], ref, rtol=JAX_TRAJ_RTOL, err_msg=f"rank {r}")
