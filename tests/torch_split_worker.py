"""One rank of tests/test_torch_store_split.py, and the problems its cases share.

    python tests/torch_split_worker.py <rank> <world> <port> <outdir> <json cases>

joins a gloo group of ``world`` CPU ranks at tcp://127.0.0.1:<port>, runs
each case of the JSON list ([name, {args}] pairs) in turn and writes what
case i computed to <outdir>/case<i>_<rank>.npz. Imports ptyrad_tpu_torch
only (no JAX).

The training problem is tests/torch_port_helpers.py's small run: 11
patterns of 16^2 in batches of 3 (4 batches, the last of 2, padded to a
multiple of the world size), so the store of 11 rows splits into blocks of
6 (2 ranks) or 3 (4 ranks) with padding rows at the end.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_dist_worker import batch_grads, state_digest  # noqa: E402
from torch_port_helpers import small_dataset, small_params  # noqa: E402

from ptyrad_tpu_torch.engine.solver import PtyRADSolver  # noqa: E402
from ptyrad_tpu_torch.models.state import MEAS_DTYPES  # noqa: E402
from ptyrad_tpu_torch.parallel import (exchange_plan, exchange_rows,  # noqa: E402
                                       init_multihost, rank_slice, split_store, store_split)

# (store rows, batch length per rank) of the exchange cases: a store that
# splits evenly, one that does not, and one smaller than a batch
EXCHANGE_SHAPES = ((24, 3), (37, 5), (5, 4))
EXCHANGE_PATTERNS = ("random", "repeated", "padded", "one_owner")
VARIANTS = ("adam", "lbfgs", "pad", "bf16")


def whole_store(n_rows: int, seed: int = 11) -> np.ndarray:
    """A (n_rows, 4, 3) float32 store whose rows are told apart by value."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_rows, 4, 3)) * 100.0).astype(np.float32)


def batch_pattern(kind: str, n_rows: int, length: int, seed: int) -> tuple:
    """(idx, mask) of one padded batch of ``length`` global indices, the
    same on every rank: random rows, a few rows repeated, a tail of padded
    slots (index 0, mask 0), or every row from one rank's block."""
    rng = np.random.default_rng(seed)
    mask = np.ones(length, np.float32)
    if kind == "random":
        idx = rng.integers(0, n_rows, length)
    elif kind == "repeated":
        idx = rng.choice(rng.integers(0, n_rows, 2), length)
    elif kind == "padded":
        idx = rng.integers(0, n_rows, length)
        idx[length // 2:], mask[length // 2:] = 0, 0.0
    else:
        idx = np.full(length, n_rows - 1)
    return idx.astype(np.int64), mask


def exchange_cases(group) -> dict:
    """The exchange of every (shape, pattern, store dtype) against the whole
    store's rows of the rank's slice, both as float32 (exact for every
    store type), and each block's row count."""
    out = {}
    for n_rows, per in EXCHANGE_SHAPES:
        meas = whole_store(n_rows)
        split = store_split(n_rows, group)
        for dtype in MEAS_DTYPES:
            block = split_store(meas, split, torch.device("cpu"), dtype)
            whole = torch.as_tensor(meas).to(MEAS_DTYPES[dtype])
            out[f"block_rows_{n_rows}_{dtype}"] = np.array(block.shape[0])
            for p, kind in enumerate(EXCHANGE_PATTERNS):
                idx, mask = batch_pattern(kind, n_rows, per * group.size, seed=100 * n_rows + p)
                rows = exchange_rows(block, exchange_plan(idx, split, block.device), group)
                local, _ = rank_slice(torch.as_tensor(idx), torch.as_tensor(mask), group)
                key = f"{n_rows}_{kind}_{dtype}"
                out[f"got_{key}"] = rows.float().numpy()
                out[f"want_{key}"] = whole[local].float().numpy()
                out[f"dtype_{key}"] = np.array(str(rows.dtype))
    return out


def variant(name: str, shard: bool):
    """(params, init_variables) of a training variant: Adam for 3
    iterations; LBFGS for 2; Adam on patterns cropped to 12^2 and padded on
    the fly back to 16^2; Adam with a bfloat16 store."""
    from ptyrad_tpu_torch.initialization import meas_pad_on_the_fly

    init = small_dataset()
    optimizer = {"name": "LBFGS"} if name == "lbfgs" else {"name": "Adam"}
    params = small_params(optimizer, niter=2 if name == "lbfgs" else 3)
    params["recon_params"]["shard_measurements"] = shard
    if name == "pad":
        crops = np.ascontiguousarray(init["measurements"][:, 2:14, 2:14])
        template, idx = meas_pad_on_the_fly(crops, "constant", 16, value=0.01)
        init.update(measurements=crops, on_the_fly_meas_padded=template,
                    on_the_fly_meas_padded_idx=idx)
    if name == "bf16":
        params["model_params"]["meas_dtype"] = "bfloat16"
    return params, init


def train(name: str, group) -> dict:
    """The variant with the store split and replicated, on the same ranks:
    losses, the parameters' digest after every iteration and the final
    parameters of each, and the split store's block."""
    out = {}
    for shard in (True, False):
        params, init = variant(name, shard)
        solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False,
                              group=group)
        tag = "split" if shard else "replicated"
        out[f"{tag}_store_rows"] = np.array(solver.buffers.measurements.shape[0])
        out[f"{tag}_store_dtype"] = np.array(str(solver.buffers.measurements.dtype))
        digests = []
        solver.run(callback=lambda niter, p, history: digests.append(state_digest(p)))
        out[f"{tag}_losses"] = np.array([v for _, v in solver.history.loss_iters])
        out[f"{tag}_digests"] = np.array(digests)
        for pname, t in solver.params.named():
            out[f"{tag}_{pname}"] = t.detach().numpy()
    return out


def main(argv) -> None:
    rank, world, port, outdir = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    cases = json.loads(argv[5])
    torch.set_num_threads(1)
    group = init_multihost(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    try:
        for i, (name, args) in enumerate(cases):
            if name == "exchange":
                out = exchange_cases(group)
            elif name == "train":
                out = train(args["name"], group)
            else:
                out = batch_grads(args["route"], args["batch"], group)
            np.savez(os.path.join(outdir, f"case{i}_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
