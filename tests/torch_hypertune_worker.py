"""One rank of tests/test_torch_hypertune_dist.py.

    python tests/torch_hypertune_worker.py <rank> <world> <port> <outdir> <json cases>

joins a gloo group of ``world`` CPU ranks at tcp://127.0.0.1:<port> and
runs each case of the JSON list ([name, {args}] pairs) in turn: a hypertune
study of the params dict in args["cfg"] (a JSON file) through
``run_hypertune(..., group=)``, the Initializer seeded with args["seed"] on
every rank. Case i writes <outdir>/case<i>_<rank>.npz: on rank 0 the
study's trials (as JSON), on every rank what each trial it ran computed
(its number and values, its losses or that it diverged, the shape of
its final objp, whether it was pruned; on request the objp itself). Imports
ptyrad_tpu_torch only (no JAX).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ptyrad_tpu_torch.engine import hypertune as ht  # noqa: E402
from ptyrad_tpu_torch.parallel import init_multihost  # noqa: E402


def study(cfg_path: str, seed: int, group, keep_objp: bool = False) -> dict:
    """The study on the ranks; every trial loop the rank ran recorded (with
    ``keep_objp`` also its final objp and what the contrast metric reads
    beside it)."""
    with open(cfg_path, encoding="utf-8") as f:
        cfg = json.load(f)
    ran = []
    run_loop = ht._run_trial_loop

    def recording_loop(trial, *args, **kwargs):
        record = {"number": trial.number, "params": dict(trial.values), "diverged": True}
        ran.append(record)
        solver, error, pruned = run_loop(trial, *args, **kwargs)
        record.update(diverged=False, losses=[v for _, v in solver.history.loss_iters],
                      objp_shape=list(solver.params.objp.shape),
                      obj_shape=list(solver.geom.obj_shape), pruned=pruned)
        if keep_objp:
            record.update(objp=solver.params.objp.detach().numpy().tolist(),
                          crop_pos=solver.buffers.crop_pos.numpy().tolist(),
                          indices=np.asarray(solver.indices).tolist(),
                          probe_shape=list(solver.geom.probe_shape))
        return solver, error, pruned

    ht._run_trial_loop = recording_loop
    try:
        result = ht.run_hypertune(cfg, use_optuna=False, device="cpu",
                                  init_rng=np.random.RandomState(seed), group=group)
    finally:
        ht._run_trial_loop = run_loop
    return {"trials": np.array(json.dumps(None if result is None else result.trials)),
            "ran": np.array(json.dumps(ran))}


def main(argv) -> None:
    rank, world, port, outdir = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    cases = json.loads(argv[5])
    torch.set_num_threads(1)
    group = init_multihost(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    try:
        for i, (_name, args) in enumerate(cases):
            out = study(args["cfg"], args["seed"], group, args.get("keep_objp", False))
            np.savez(os.path.join(outdir, f"case{i}_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
