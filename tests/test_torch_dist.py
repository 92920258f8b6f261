"""Data parallelism over ranks (ptyrad_tpu_torch.parallel): gloo ranks on the
CPU against one process and against the JAX package's mesh.

Each case starts its ranks as processes (tests/torch_dist_worker.py, a
tcp://127.0.0.1 rendezvous on a free port, as tests/test_multihost.py:183
starts its two) and reads what they wrote. Every loss term is a non-linear
function of sums over the whole batch, so the ranks must reduce those sums
inside the loss and sum the gradients after backward; taking each rank's
own loss and summing the gradients would give another result.

Tolerances: the loss at rtol 1e-5 and the gradients at those of the JAX
package's own mesh tests (tests/test_engine.py:818-921: objp and obja atol
1e-5, the probe 5e-5, the position shifts 1e-7), for the one-process run
and for jax.value_and_grad on make_mesh(n) over the virtual CPU devices; a
2-iteration trajectory at rtol 1e-4 (tests/test_torch_solver.py's); the
ranks' parameters bit for bit after every iteration.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.losses import combined_loss as j_combined_loss
from ptyrad_tpu.models import forward as j_forward
from ptyrad_tpu.models import get_measurements as j_get_measurements
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.parallel.mesh import data_sharding, make_mesh
from ptyrad_tpu.parallel.mesh import shard_model as j_shard_model
from torch_dist_worker import GRAD_NAMES, batch_grads, grads_problem, train
from torch_port_helpers import free_port, rank_env, spawn_ranks

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
GRAD_ATOL = {"obja": 1e-5, "objp": 1e-5, "probe": 5e-5, "probe_pos_shifts": 1e-7}
RANK_TIMEOUT_S = 120


def run_ranks(tmp: Path, case: str, world: int, **args) -> list:
    """Start ``world`` ranks of ``case`` and return each rank's outputs."""
    port = free_port()
    spawn_ranks(lambda r: [sys.executable, str(WORKER), case, str(r), str(world), str(port),
                           str(tmp), json.dumps(args)], world, tmp, RANK_TIMEOUT_S, case)
    return [dict(np.load(tmp / f"{case}_{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs of the ranks, each started once for the whole module."""
    cache = {}

    def get(case: str, world: int, **args):
        key = (case, world, json.dumps(args, sort_keys=True))
        if key not in cache:
            tmp = tmp_path_factory.mktemp(f"{case}_{world}")
            cache[key] = run_ranks(tmp, case, world, **args)
        return cache[key]

    return get


# the padded batch held in the gradient cases: batch 0 of the random grouping
BATCH_INDEX = 0
CASES = [("fused", 2), ("fused", 4), ("forward", 2), ("forward", 4)]


def assert_grads(actual: dict, expected: dict, what: str) -> None:
    for name in GRAD_NAMES:
        np.testing.assert_allclose(actual[name], expected[name], rtol=0, atol=GRAD_ATOL[name],
                                   err_msg=f"{what}: gradient of {name}")


@pytest.mark.parametrize("route,world", CASES, ids=[f"{r}-{n}" for r, n in CASES])
def test_ranks_give_the_one_process_loss_and_gradients(ranks, route, world):
    one = batch_grads(route, BATCH_INDEX)
    outs = ranks("grads", world, route=route, batch=BATCH_INDEX)
    assert outs[0]["mask"].shape[0] % world == 0 and outs[0]["mask"].min() == 0, \
        "the batch does not pad on this many ranks"
    assert one["mask"].sum() == outs[0]["mask"].sum()
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["total"], one["total"], rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["terms"], one["terms"], rtol=1e-5, atol=1e-12,
                                   err_msg=f"rank {r} terms {list(out['term_names'])}")
        assert_grads(out, one, f"rank {r} of {world}")
        # every rank holds the same total and gradients, bit for bit
        assert out["total"] == outs[0]["total"]
        for name in GRAD_NAMES:
            np.testing.assert_array_equal(out[name], outs[0][name])


def jax_mesh_grads(route: str, world: int, idx: np.ndarray, mask: np.ndarray) -> dict:
    """jax.value_and_grad of forward + combined_loss on make_mesh(world):
    parameters replicated, the batch sharded over 'data'."""
    init, params = grads_problem(route)
    jp, jb, jg = j_make_model(init, params["model_params"])
    mesh = make_mesh(world)
    jp, jb = j_shard_model(jp, jb, mesh, shard_measurements=False)
    idx_s = jax.device_put(jnp.asarray(idx), data_sharding(mesh))
    mask_s = jax.device_put(jnp.asarray(mask), data_sharding(mesh))

    def loss(p):
        dp, (oa, op) = j_forward(p, jb, jg, idx_s)
        meas = j_get_measurements(jb, jg, idx_s)
        total, _ = j_combined_loss(dp, meas, oa, op, jb.omode_occu, params["loss_params"], mask_s)
        return total

    total, g = jax.jit(jax.value_and_grad(loss))(jp)
    return {"total": float(total), "obja": np.asarray(g.obja), "objp": np.asarray(g.objp),
            "probe": np.stack([np.asarray(g.probe.re), np.asarray(g.probe.im)], -1),
            "probe_pos_shifts": np.asarray(g.probe_pos_shifts)}


@pytest.mark.parametrize("route,world", CASES, ids=[f"{r}-{n}" for r, n in CASES])
def test_ranks_give_the_jax_mesh_loss_and_gradients(ranks, route, world):
    out = ranks("grads", world, route=route, batch=BATCH_INDEX)[0]
    ref = jax_mesh_grads(route, world, out["idx"], out["mask"])
    np.testing.assert_allclose(out["total"], ref["total"], rtol=1e-5)
    out = {**out, "probe": np.stack([out["probe"].real, out["probe"].imag], -1)}
    assert_grads(out, ref, f"{world} ranks against make_mesh({world})")


@pytest.mark.parametrize("optimizer,accumulation", [("Adam", 1), ("LBFGS", 1), ("Adam", 2)],
                         ids=["Adam", "LBFGS", "Adam-grad_accumulation-2"])
def test_two_ranks_follow_the_one_process_trajectory(ranks, optimizer, accumulation):
    """Under grad_accumulation the gradients are summed over the ranks
    before MultiSteps accumulates them."""
    one = train(optimizer, grad_accumulation=accumulation)
    outs = ranks("train", 2, optimizer=optimizer, grad_accumulation=accumulation)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-4, err_msg=f"rank {r}")
    # the ranks' parameters equal bit for bit after every iteration
    assert len(outs[0]["digests"]) == 2
    np.testing.assert_array_equal(outs[0]["digests"], outs[1]["digests"])
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])


def test_two_rank_workflow_writes_once(ranks, tmp_path_factory):
    """run_reconstruction on two ranks whose Initializers draw from other
    seeds (position jitter): the same epoch losses and parameters on both,
    within 1e-4 of one process seeded as rank 0; one output folder, one log,
    written by rank 0."""
    from ptyrad_tpu_torch.engine.workflow import run_reconstruction
    from ptyrad_tpu_torch.load import load_params
    from torch_port_helpers import SOLVER_SEED, recon_params_file

    tmp = tmp_path_factory.mktemp("workflow_params")
    path = recon_params_file(tmp, "p.json", NITER=2, SAVE_ITERS=1, save_result=["objp", "model"])
    outs = ranks("workflow", 2, params_path=str(path))
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])
    assert str(outs[0]["digest"]) == str(outs[1]["digest"])
    assert str(outs[0]["output_path"]) == str(outs[1]["output_path"])
    (folder,) = os.listdir(tmp / "out")
    files = os.listdir(tmp / "out" / folder)
    assert len([f for f in files if f.endswith("ptyrad_tpu_torch_log.txt")]) == 1, files
    assert {"p.json", "model_iter0001.hdf5", "model_iter0002.hdf5"} <= set(files), files
    log = next(f for f in files if f.endswith("_log.txt"))
    text = (tmp / "out" / folder / log).read_text()
    assert text.count("Iter: 2, Total Loss") == 1 and "Data parallel: 2 rank(s) over gloo" in text

    one_tmp = tmp_path_factory.mktemp("workflow_one")
    one_path = recon_params_file(one_tmp, "p.json", NITER=2, save_result=["objp"])
    one = run_reconstruction(load_params(str(one_path)), device="cpu", verbose=False,
                             init_rng=np.random.RandomState(SOLVER_SEED))
    np.testing.assert_allclose(outs[0]["losses"], [v for _, v in one.history.loss_iters],
                               rtol=1e-4)


def test_cli_n_devices_runs_gloo_ranks(tmp_path):
    """``python -m ptyrad_tpu_torch run --device cpu --n_devices 2``: exit 0,
    one output folder and log, each iteration printed once (rank 0), a
    falling loss."""
    from torch_port_helpers import recon_params_file

    path = recon_params_file(tmp_path, "p.json", NITER=2, save_result=["objp"])
    out = subprocess.run([sys.executable, "-m", "ptyrad_tpu_torch", "run", "--params_path",
                          str(path), "--device", "cpu", "--n_devices", "2"],
                         cwd=ROOT, env=rank_env(), capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    iters = [line for line in out.stdout.splitlines() if "Total Loss" in line]
    assert len(iters) == 2, out.stdout
    losses = [float(line.split("Total Loss: ")[1].split(",")[0]) for line in iters]
    assert losses[1] < losses[0]
    assert "process index   : 0 / 2" in out.stdout
    (folder,) = os.listdir(tmp_path / "out")
    assert len([f for f in os.listdir(tmp_path / "out" / folder) if f.endswith("_log.txt")]) == 1


def test_cli_multihost_joins_a_world_of_one(tmp_path):
    """``run --device cpu --multihost`` with the three distributed flags: a
    gloo world of one (chip_smoke's dist_cli phase runs the same under NCCL
    on the card)."""
    from torch_port_helpers import recon_params_file

    path = recon_params_file(tmp_path, "p.json", NITER=1, save_result=["objp"])
    out = subprocess.run([sys.executable, "-m", "ptyrad_tpu_torch", "run", "--params_path",
                          str(path), "--device", "cpu", "--multihost", "--coordinator_address",
                          f"127.0.0.1:{free_port()}", "--num_processes", "1",
                          "--process_id", "0"],
                         cwd=ROOT, env=rank_env(), capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "process index   : 0 / 1" in out.stdout
    assert "Data parallel: 1 rank(s) over gloo" in out.stdout
    assert "Iter: 1, Total Loss" in out.stdout


@pytest.fixture(scope="module")
def primitives(ranks):
    return ranks("primitives", 2)


def test_broadcast_str_gives_rank_zeros_string(primitives):
    assert [str(o["name"]) for o in primitives] == ["folder-of-rank-0"] * 2


def test_all_reduce_sum_passes_the_gradient_unchanged(primitives):
    """y = sum over ranks of 2 x: y = 2 (1 + 2) on each rank, dy/dx = 2 (the
    identity backward), not 2 x world as torch.distributed.nn's all_reduce
    gives."""
    for o in primitives:
        assert float(o["sum"]) == 6.0 and float(o["grad"]) == 2.0


def test_shard_model_gives_every_rank_rank_zeros_parameters(primitives):
    assert float(primitives[0]["obja_sum"]) == float(primitives[1]["obja_sum"])


def test_shard_canvas_and_hypertune_refuse_more_than_one_rank(primitives):
    """Neither refuses more than one rank any more: shard_canvas since the
    canvas path (tests/test_torch_canvas.py), hypertune since studies run
    over ranks (tests/test_torch_hypertune_dist.py), so an empty params dict
    fails on its missing hypertune_params, not on the rank count. An odd
    batch still refuses to split."""
    for o in primitives:
        assert str(o["hypertune"]).startswith("KeyError") and "hypertune_params" in str(
            o["hypertune"])
        assert "pad_batches(multiple_of=2)" in str(o["odd_slice"])


def test_one_process_paths_take_no_group():
    """Without a group the solver, the collectives and the helpers are the
    one-process code: rank_slice is the identity, all_reduce_sum returns
    its input, broadcast_str its string."""
    from ptyrad_tpu_torch.parallel import (all_reduce_grads, all_reduce_sum, broadcast_str,
                                           is_main_process, process_index, rank_slice,
                                           world_size)

    idx, mask = torch.arange(6), torch.ones(6)
    assert rank_slice(idx, mask, None) == (idx, mask)
    x = torch.ones(3)
    assert all_reduce_sum(x, None) is x and broadcast_str("a", None) == "a"
    assert all_reduce_grads([x], None) == 0
    assert (process_index(), world_size(), is_main_process()) == (0, 1, True)


def test_resolve_devices_beyond_the_device_count_raises():
    from ptyrad_tpu_torch.utils.system import resolve_devices

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"this host has {have}"):
        resolve_devices(max(have + 1, 2), "cuda")
    assert resolve_devices(None) == 1 and resolve_devices(3, "cpu") == 3


def test_solver_n_devices_must_match_the_group():
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    init, params = grads_problem("fused")
    with pytest.raises(ValueError, match="one process per device"):
        PtyRADSolver(params, init_variables=init, device="cpu", n_devices=2)
