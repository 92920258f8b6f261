"""One rank of tests/test_torch_dist.py, and the problems its cases share.

    python tests/torch_dist_worker.py <case> <rank> <world> <port> <outdir> <json args>

joins a gloo group of ``world`` CPU ranks at tcp://127.0.0.1:<port> and
writes what the case computed to <outdir>/<case>_<rank>.npz. The same
functions with ``group=None`` give the one-process run that the test holds
the ranks against. Imports ptyrad_tpu_torch only (no JAX), so a rank starts
in about a second.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port_helpers import small_dataset, small_params, toy_init  # noqa: E402

from ptyrad_tpu_torch.engine.solver import PtyRADSolver, RankBatches, params_tensors  # noqa: E402
from ptyrad_tpu_torch.parallel import all_reduce_grads, init_multihost, rank_slice  # noqa: E402

# 37 positions in batches of 10: the random grouping gives batches of 13, 12
# and 12; the first pads to 14 on two ranks and to 16 on four
N_SCANS, BATCH = 37, 10
GRAD_NAMES = ("obja", "objp", "probe", "probe_pos_shifts")
ROUTES = {
    # fused_loss_terms (B3's plain twin on the CPU): one object mode
    "fused": (1, {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
                  "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}}),
    # forward() (B4's plain twin) + combined_loss: two object modes, so that
    # loss_simlar is not zero
    "forward": (2, {"loss_single": {"state": False},
                    "loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
                    "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2},
                    "loss_simlar": {"state": True, "weight": 0.1, "obj_type": "both",
                                    "blur_std": 1.0, "scale_factor": [1.0, 1.0]}}),
}
UPDATE = {"obja": {"lr": 1e-2, "start_iter": 1}, "objp": {"lr": 1e-2, "start_iter": 1},
          "probe": {"lr": 1e-3, "start_iter": 1}, "probe_pos_shifts": {"lr": 1e-4, "start_iter": 1}}


def grads_problem(route: str):
    """(init_variables, params) of the gradient cases: 37 scans of 16^2, 2
    slices, 2 probe modes, nonzero position shifts (at zero shift the data's
    shift gradient is rounding noise)."""
    omode, loss_params = ROUTES[route]
    rng = np.random.default_rng(3)
    init = toy_init(rng, n_scans=N_SCANS, npix=16, omode=omode, nz=2, pmode=2, canvas=40)
    init["probe_pos_shifts"] = rng.uniform(-0.5, 0.5, (N_SCANS, 2)).astype(np.float32)
    params = {"model_params": {"update_params": UPDATE}, "loss_params": loss_params,
              "recon_params": {"BATCH_SIZE": {"size": BATCH}, "GROUP_MODE": "random",
                               "GROUP_MODE_SEED": 0}}
    return init, params


def batch_grads(route: str, batch: int, group=None) -> dict:
    """Loss terms and gradients of one padded batch: each rank its block,
    the loss reduced over the ranks, the gradients all-reduced."""
    init, params = grads_problem(route)
    solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False, group=group)
    solver.prepare()
    p = solver.params
    for name in GRAD_NAMES:
        getattr(p, name).requires_grad_(True)
    idx = torch.as_tensor(solver.batch_idx[batch])
    mask = torch.as_tensor(solver.batch_mask[batch])
    # the rank's slice and, the store being split over the ranks by
    # default, its rows fetched from the ranks that hold them
    share = RankBatches(p, solver.buffers, solver.geom, group)
    local_idx, local_mask, plans = share.slice(idx[None], mask[None])
    total, terms = share.loss(local_idx[0], local_mask[0], params["loss_params"], plans[0])
    total.backward()
    all_reduce_grads(params_tensors(p), group)
    out = {"total": float(total.detach()), "idx": idx.numpy(), "mask": mask.numpy(),
           "term_names": np.array(list(terms)),
           "terms": np.array([float(v.detach()) for v in terms.values()])}
    for name in GRAD_NAMES:
        g = getattr(p, name).grad.numpy()
        out[name] = g
    return out


def state_digest(params) -> str:
    """sha256 of every parameter's bytes."""
    h = hashlib.sha256()
    for _, t in params.named():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train(optimizer: str, group=None, grad_accumulation: int = 1) -> dict:
    """Two iterations of tests/torch_port_helpers.py's small run (11 scans in
    batches of 4, 4 and 3: the last padded on 2 ranks), the digest of the
    parameters after each."""
    params = small_params({"name": optimizer}, niter=2, grad_accumulation=grad_accumulation)
    solver = PtyRADSolver(params, init_variables=small_dataset(), device="cpu", verbose=False,
                          group=group)
    digests = []
    solver.run(callback=lambda niter, p, history: digests.append(state_digest(p)))
    return {"losses": np.array([v for _, v in solver.history.loss_iters]),
            "digests": np.array(digests),
            **{name: t.detach().numpy() for name, t in solver.params.named()}}


def workflow(params_path: str, group) -> dict:
    """run_reconstruction from a params file with a logger; each rank's
    Initializer draws from another seed, so only shard_model's broadcast
    keeps the ranks together."""
    from ptyrad_tpu_torch.engine.workflow import run_reconstruction
    from ptyrad_tpu_torch.load import load_params
    from ptyrad_tpu_torch.utils.logging import CustomLogger

    from torch_port_helpers import SOLVER_SEED

    logger = CustomLogger(log_file="ptyrad_tpu_torch_log.txt")
    try:
        solver = run_reconstruction(load_params(params_path), logger=logger, device="cpu",
                                    init_rng=np.random.RandomState(SOLVER_SEED + group.rank),
                                    group=group)
    finally:
        logger.close()
    return {"losses": np.array([v for _, v in solver.history.loss_iters]),
            "digest": np.array(state_digest(solver.params)),
            "output_path": np.array(solver.output_path)}


def primitives(group) -> dict:
    """broadcast_str, all_reduce_sum's gradient, shard_model, and
    run_hypertune on more than one rank, which no longer refuses (an empty
    params dict fails on its missing section)."""
    from ptyrad_tpu_torch.engine.hypertune import run_hypertune
    from ptyrad_tpu_torch.parallel import all_reduce_sum, broadcast_str

    out = {"name": np.array(broadcast_str(f"folder-of-rank-{group.rank}", group))}
    x = torch.tensor(1.0 + group.rank, requires_grad=True)
    y = all_reduce_sum(2.0 * x, group)
    y.backward()
    out["sum"], out["grad"] = float(y.detach()), float(x.grad)

    init, params = grads_problem("fused")
    init["obj"] = init["obj"] * (1.0 + 0.1 * group.rank)
    solver = PtyRADSolver({**params, "recon_params": {**params["recon_params"],
                                                       "shard_canvas": True}},
                          init_variables=init, device="cpu", verbose=False, group=group)
    out["obja_sum"] = float(solver.params.obja.sum())
    try:
        run_hypertune({})
        out["hypertune"] = np.array("no error")
    except Exception as e:  # noqa: BLE001 — the test reads which error it was
        out["hypertune"] = np.array(f"{type(e).__name__}: {e}")
    try:
        rank_slice(torch.arange(5), torch.ones(5), group)
        out["odd_slice"] = np.array("no error")
    except ValueError as e:
        out["odd_slice"] = np.array(str(e))
    return out


def main(argv) -> None:
    case, rank, world, port, outdir, args = argv[1], *map(int, argv[2:5]), argv[5], argv[6]
    args = json.loads(args)
    torch.set_num_threads(1)
    group = init_multihost(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    try:
        if case == "grads":
            out = batch_grads(args["route"], args["batch"], group)
        elif case == "train":
            out = train(args["optimizer"], group, args["grad_accumulation"])
        elif case == "workflow":
            out = workflow(args["params_path"], group)
        else:
            out = primitives(group)
        np.savez(os.path.join(outdir, f"{case}_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
