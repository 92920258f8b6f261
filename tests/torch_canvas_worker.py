"""One rank of tests/test_torch_canvas.py, and the problems its cases share.

    python tests/torch_canvas_worker.py <rank> <world> <port> <outdir> <json cases>

joins a gloo group of ``world`` CPU ranks at tcp://127.0.0.1:<port>, runs
each case of the JSON list ([name, {args}] pairs) in turn and writes what
case i computed to <outdir>/case<i>_<rank>.npz. The replicated references
the test holds the ranks against are computed by the same functions with
``group=None`` (``replicated_*``). Imports ptyrad_tpu_torch only (no JAX).

The canvas problem: a 13 x 11 raster of 16^2 patterns, 5 px apart, on an
80-row canvas (70 columns, or 90 for the wide variant), 2 slices, 2 probe
modes. On 4 ranks the slabs are 20 rows: the first three hold 44 positions
each, the last 11, so the last rank's store is mostly padding slots, whose
corner (position 0's, row 2) rebases to a negative row; a patch whose top
row is 17 reads three rows of its own slab and 13 of the next.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_dist_worker import ROUTES  # noqa: E402
from torch_port_helpers import toy_init  # noqa: E402

from ptyrad_tpu_torch.engine.solver import PtyRADSolver, loss_fn, recon_loop  # noqa: E402
from ptyrad_tpu_torch.optim import optim_state_values  # noqa: E402
from ptyrad_tpu_torch.parallel import (all_reduce_grads, global_batches,  # noqa: E402
                                       init_multihost, plan_canvas)
from ptyrad_tpu_torch.parallel.canvas import canvas_batch_count  # noqa: E402

NOY, NPIX, N_SLOW, N_FAST, STEP = 80, 16, 13, 11, 5
N_SCANS = N_SLOW * N_FAST
GRAD_NAMES = ("obja", "objp", "probe", "probe_pos_shifts")
UPDATE = {"obja": {"lr": 1e-2, "start_iter": 1}, "objp": {"lr": 1e-2, "start_iter": 1},
          "probe": {"lr": 1e-3, "start_iter": 1},
          "probe_pos_shifts": {"lr": 1e-4, "start_iter": 2}}
CONSTRAINTS = {
    "ortho_pmode": {"freq": 1},
    "fix_probe_int": {"freq": 1},
    "obj_rblur": {"freq": 2, "obj_type": "both", "kernel_size": 5, "std": 0.5},
    "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
    "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
}
NITER = 3
BATCH = 60  # 143 positions: 3 batches an iteration


def canvas_init(route: str = "fused", width: int = 70, seed: int = 3) -> dict:
    """init_variables of the canvas problem (see the module docstring):
    random probe, weak object, noise measurements, position shifts within
    half a pixel."""
    omode = ROUTES[route][0]
    rng = np.random.default_rng(seed)
    init = toy_init(rng, n_scans=N_SCANS, npix=NPIX, omode=omode, nz=2, pmode=2,
                    canvas=max(NOY, width))
    init["obj"] = np.ascontiguousarray(init["obj"][..., :NOY, :width])
    ys, xs = np.meshgrid(2 + STEP * np.arange(N_SLOW), 2 + STEP * np.arange(N_FAST),
                         indexing="ij")
    init["crop_pos"] = np.stack([ys.ravel(), xs.ravel()], -1).astype(np.int32)
    init["probe_pos_shifts"] = rng.uniform(-0.5, 0.5, (N_SCANS, 2)).astype(np.float32)
    init["N_scan_slow"], init["N_scan_fast"] = N_SLOW, N_FAST
    return init


# the training variants: (route, canvas width, model_params entries, recon
# BATCH_SIZE entries, update_params entries, init entries)
VARIANTS = {
    "adam": ("fused", 70, {}, {}, {}, {}),
    "forward": ("forward", 70, {}, {}, {}, {}),
    "bf16": ("fused", 70, {"compute_dtype": "bfloat16"}, {}, {}, {}),
    "grad_accumulation": ("fused", 70, {}, {"grad_accumulation": 2}, {}, {}),
    # the canvases alone, as the JAX package's canvas LBFGS test: with the
    # probe and shifts at their rates the line search fails at iteration 2
    # and a float32 rounding then decides iteration 3's steps
    "lbfgs": ("fused", 70, {"optimizer_params": {"name": "LBFGS"}}, {},
              {"probe": {"lr": 0}, "probe_pos_shifts": {"lr": 0}}, {}),
    "tilt_dz": ("fused", 70, {}, {}, {"obj_tilts": {"lr": 1e-3, "start_iter": 1},
                                      "slice_thickness": {"lr": 1e-3, "start_iter": 1}},
                {"obj_tilts": np.array([[1.0, -2.0]], np.float32)}),
    "tilt_each": ("fused", 70, {}, {}, {"obj_tilts": {"lr": 1e-3, "start_iter": 1}},
                  {"obj_tilts": np.tile(np.array([[1.0, -2.0]], np.float32), (N_SCANS, 1))}),
    "adamw": ("fused", 70, {"optimizer_params": {"name": "AdamW",
                                                 "configs": {"weight_decay": 0.1}}},
              {}, {}, {}),
    "adafactor": ("fused", 70, {"optimizer_params": {"name": "Adafactor", "configs": {
        "min_dim_size_to_factor": 8}}}, {}, {}, {}),
    "adafactor_wide": ("fused", 90, {"optimizer_params": {"name": "Adafactor", "configs": {
        "min_dim_size_to_factor": 8}}}, {}, {}, {}),
    "adafactor_unfactored": ("fused", 70, {"optimizer_params": {"name": "Adafactor"}},
                             {}, {}, {}),
    "muon": ("fused", 70, {"optimizer_params": {"name": "Muon"}}, {}, {}, {}),
    # without ortho_pmode, whose eigh gauge parts the two packages: the
    # trajectory held against the JAX package's canvas solver
    "no_ortho_pmode": ("fused", 70, {}, {}, {}, {}),
}


def variant(name: str, shard: bool = True):
    """(params, init_variables) of a training variant."""
    route, width, model, batch, update, init_over = VARIANTS[name]
    init = canvas_init(route, width)
    init.update(init_over)
    params = {
        "model_params": {"update_params": {**UPDATE, **update}, **copy.deepcopy(model)},
        "loss_params": copy.deepcopy(ROUTES[route][1]),
        "constraint_params": {k: copy.deepcopy(v) for k, v in CONSTRAINTS.items()
                              if name != "no_ortho_pmode" or k != "ortho_pmode"},
        "recon_params": {"NITER": NITER, "BATCH_SIZE": {"size": BATCH, **batch},
                         "GROUP_MODE": "random", "GROUP_MODE_SEED": 0,
                         "shard_canvas": shard},
    }
    return params, init


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (torch.view_as_real(t) if t.is_complex() else t).numpy()


def flat_state(values, prefix="") -> dict:
    """optim_state_values' nested dict as {key path: array}."""
    out = {}
    for k, v in values.items():
        if isinstance(v, dict):
            out.update(flat_state(v, f"{prefix}{k}/"))
        elif isinstance(v, np.ndarray) or np.isscalar(v):
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# -- the full-batch loss and gradients ---------------------------------------

def grads_params(route: str) -> dict:
    return {"model_params": {"update_params": UPDATE}, "loss_params": ROUTES[route][1],
            "recon_params": {"BATCH_SIZE": {"size": 1000}, "shard_canvas": True}}


def canvas_grads(route: str, group) -> dict:
    """The canvas loss of every position in one batch (each rank its store)
    and its gradients, the canvases gathered whole; the bytes the gradient
    all-reduce moved; the shapes the rank keeps."""
    solver = PtyRADSolver(grads_params(route), init_variables=canvas_init(route), device="cpu",
                          verbose=False, group=group)
    solver.prepare()
    solver._build()
    shard, _ = solver._canvas
    plan = shard.plan
    cut = slice(group.rank * plan.b_local, (group.rank + 1) * plan.b_local)
    total, terms = shard.loss(torch.arange(plan.b_local), torch.as_tensor(plan.mask[cut]),
                              solver.loss_params)
    total.backward()
    nbytes = all_reduce_grads(shard.replicated_tensors(), group)
    p = shard.params
    out = {"total": float(total.detach()),
           "terms": np.array([float(v.detach()) for v in terms.values()]), "bytes": nbytes,
           "pos_index": plan.pos_index, "mask": plan.mask, "slab_shape": np.array(p.obja.shape),
           "store_shape": np.array(shard.store.measurements.shape),
           "store_gid": shard.store.gid.numpy(), "store_meas": shard.store.measurements.numpy(),
           "pad_grad_max": max(float(getattr(p, n).grad[..., shard.valid_rows:, :].abs().max())
                               if shard.valid_rows < plan.rows_local else 0.0
                               for n in ("obja", "objp"))}
    for name in ("obja", "objp"):
        out[name] = shard.gather(getattr(p, name).grad).numpy()
    for name in ("probe", "probe_pos_shifts"):
        out[name] = host(getattr(p, name).grad)
    return out


def replicated_grads(route: str, world: int) -> dict:
    """The same batch through the replicated loss in one process: every
    position of the world-rank plan in slot order, padding slots at mask 0."""
    params = grads_params(route)
    params["recon_params"]["shard_canvas"] = False
    solver = PtyRADSolver(params, init_variables=canvas_init(route), device="cpu", verbose=False)
    solver.prepare()
    solver._build()
    geom = solver.geom
    plan = plan_canvas(solver.buffers.crop_pos.numpy(), solver.indices, geom.obj_shape[2],
                       geom.probe_shape[0], world)
    total, terms = loss_fn(solver.params, solver.buffers, geom, torch.as_tensor(plan.pos_index),
                           torch.as_tensor(plan.mask), solver.loss_params)
    total.backward()
    out = {"total": float(total.detach()),
           "terms": np.array([float(v.detach()) for v in terms.values()])}
    for name in GRAD_NAMES:
        out[name] = host(getattr(solver.params, name).grad)
    return out


# -- the halo exchange against whole-canvas patches ---------------------------

def halo_case(group) -> dict:
    """B1/B2's plain twins on each rank's halo-extended slab against the
    whole canvas: the rank's store patches (real slots, the patch whose top
    row is 17 among them, and padding slots), and the gradient of a seeded
    linear function of the real patches, gathered whole."""
    from ptyrad_tpu_torch.ops.patches import extract_patch_pair
    from ptyrad_tpu_torch.parallel import halo_extend
    from ptyrad_tpu_torch.parallel.canvas import CanvasShard

    init = canvas_init()
    solver = PtyRADSolver(grads_params("fused"), init_variables=init, device="cpu",
                          verbose=False, group=group)
    solver.prepare()
    geom = solver.geom
    plan = plan_canvas(solver.buffers.crop_pos.numpy(), solver.indices, geom.obj_shape[2],
                       geom.probe_shape[0], group.size)
    shard = CanvasShard(solver.params, solver.buffers, geom, plan, group)
    a = shard.params.obja.clone().requires_grad_(True)
    p = shard.params.objp.clone().requires_grad_(True)
    ext_a, ext_p = halo_extend(a, p, plan.halo, group)
    pa, pp = extract_patch_pair(ext_a, ext_p, shard.store.crop_pos, geom.probe_shape)
    cut = slice(group.rank * plan.b_local, (group.rank + 1) * plan.b_local)
    mask = torch.as_tensor(plan.mask[cut])
    cot = halo_cotangents(geom.obj_shape, shard.store.gid.numpy())
    w = mask.reshape(-1, 1, 1, 1, 1)
    (pa * cot[0] * w + pp * cot[1] * w).sum().backward()
    return {"patches_a": pa.detach().numpy(), "patches_p": pp.detach().numpy(),
            "ext_a": ext_a.detach().numpy(), "store_pos": shard.store.crop_pos.numpy(),
            "gid": shard.store.gid.numpy(), "mask": mask.numpy(),
            "grad_a": shard.gather(a.grad).numpy(), "grad_p": shard.gather(p.grad).numpy(),
            "pad_grad": np.array([float(a.grad[..., shard.valid_rows:, :].abs().sum()),
                                  float(p.grad[..., shard.valid_rows:, :].abs().sum())])}


def halo_cotangents(obj_shape, gid: np.ndarray) -> torch.Tensor:
    """(2, B, omode, Nz, Ny, Nx) seeded cotangents of the patches of the
    positions gid (the same for a position on any rank)."""
    omode, nz = obj_shape[:2]
    table = np.random.default_rng(17).standard_normal(
        (2, N_SCANS, omode, nz, NPIX, NPIX)).astype(np.float32)
    return torch.as_tensor(table[:, gid])


# -- training --------------------------------------------------------------------

def canvas_train(name: str, group, gated: bool = False) -> dict:
    """NITER iterations of a training variant on the ranks: the losses, the
    digest of the replicated tensors and of the whole canvases after every
    iteration (a callback without canvas_save_iters fires each iteration),
    the whole final parameters and the optimizer state gathered whole.
    ``gated``: the callback carries canvas_save_iters = 2 and records the
    iterations it sees."""
    params, init = variant(name)
    solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False, group=group)
    seen, digests = [], []

    def callback(niter, p, history):
        seen.append((niter, p.obja.shape[-2], p.objp.shape[-2]))
        digests.append(digest([p.probe, p.probe_pos_shifts, p.obj_tilts, p.slice_thickness]))
        digests.append(digest([p.obja, p.objp]))

    if gated:
        callback.canvas_save_iters = 2
    solver.prepare()
    solver._build()
    shard, _ = solver._canvas
    solver.run(callback=callback)
    local = flat_state(optim_state_values(solver.optimizer))
    out = {"losses": np.array([v for _, v in solver.history.loss_iters]),
           "linesearch": np.array(solver.history.linesearch).reshape(-1, 3),
           "digests": np.array(digests), "seen": np.array(seen).reshape(-1, 3),
           "slab_rows": shard.plan.rows_local,
           "canvas_state_rows": np.array([a.shape[-2] for a in local.values()
                                          if a.ndim >= 4 and a.shape[-1] == shard.nox])}
    for k, v in solver.params.named():
        out[f"param_{k}"] = host(v)
    for k, v in flat_state(shard.gather_state(optim_state_values(solver.optimizer))).items():
        out[f"state_{k}"] = v
    return out


def replicated_train(name: str, world: int) -> dict:
    """The variant in one process on the batches the ranks draw together
    (global_batches of the world-rank plan; LBFGS on iteration 0's split)."""
    params, init = variant(name, shard=False)
    solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False)
    solver.prepare()
    solver._build()
    geom = solver.geom
    plan = plan_canvas(solver.buffers.crop_pos.numpy(), solver.indices, geom.obj_shape[2],
                       geom.probe_shape[0], world)
    n_batches = canvas_batch_count(plan, len(solver.indices), BATCH, verbose=False)
    if solver.lbfgs_objective is not None:
        solver._lbfgs_loop(NITER, batches=global_batches(plan, n_batches, 0))
    else:
        recon_loop(solver.train_epoch, solver.params,
                   lambda niter: global_batches(plan, n_batches, niter), None, NITER,
                   solver.constraint_fn, solver.buffers, history=solver.history, verbose=False)
    out = {"losses": np.array([v for _, v in solver.history.loss_iters]),
           "linesearch": np.array(solver.history.linesearch).reshape(-1, 3)}
    for k, v in solver.params.named():
        out[f"param_{k}"] = host(v)
    for k, v in flat_state(optim_state_values(solver.optimizer)).items():
        out[f"state_{k}"] = v
    return out


# -- checkpoints ----------------------------------------------------------------

def resume_params(load_state=None, shard: bool = True, save_dir=None):
    """The Adam variant for the checkpoint cases: 2 iterations, saving the
    optimizer state into model.hdf5 (under save_dir) or resuming from one."""
    params, init = variant("adam", shard=shard)
    params["recon_params"].update(NITER=2)
    if save_dir is not None:
        params["recon_params"].update(save_result=["model", "optim_state"],
                                      result_modes={"bit": ["8"], "FOV": ["full"],
                                                    "obj_dim": [2]})
    if load_state is not None:
        params["model_params"]["optimizer_params"] = {"name": "Adam", "load_state": load_state}
    return params, init


def save_run(save_dir: str, group) -> dict:
    """2 iterations whose callback saves iteration 2 as the workflow does
    (save.save_results: model_iter0002.hdf5 with the optimizer state, rank 0
    writing); under canvas sharding the callback gets whole canvases and the
    state gathered whole. Returns the file's path and the losses."""
    from ptyrad_tpu_torch.save import save_results

    params, init = resume_params(shard=group is not None, save_dir=save_dir)
    solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False, group=group)
    solver.prepare()

    def callback(niter, p, history, optimizer=None):
        save_results(save_dir, p, solver.buffers, solver.geom, params, optimizer, history,
                     niter, solver.indices, lr_dict=solver.lr_dict,
                     start_dict=solver.start_dict)

    callback.canvas_save_iters = 2
    solver.run(callback=callback)
    return {"path": np.array(os.path.join(save_dir, "model_iter0002.hdf5")),
            "losses": np.array([v for _, v in solver.history.loss_iters])}


def resume_case(load_state: str, group) -> dict:
    """A solver resuming from load_state: its optimizer state right after
    the build (gathered whole under canvas sharding), then one iteration's
    loss."""
    params, init = resume_params(load_state, shard=group is not None)
    params["recon_params"]["NITER"] = 1
    solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False, group=group)
    solver.prepare()
    solver._build()
    values = optim_state_values(solver.optimizer)
    if solver._canvas is not None:
        values = solver._canvas[0].gather_state(values)
    out = {f"state_{k}": v for k, v in flat_state(values).items()}
    solver.run()
    out["losses"] = np.array([v for _, v in solver.history.loss_iters])
    return out


def refusals(group) -> dict:
    """The canvas path's refusals on the ranks: LBFGS with a load_state."""
    params, init = variant("lbfgs")
    params["model_params"]["optimizer_params"]["load_state"] = "model.hdf5"
    solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=False, group=group)
    solver.prepare()
    try:
        solver._build()
        return {"lbfgs_load_state": np.array("no error")}
    except NotImplementedError as e:
        return {"lbfgs_load_state": np.array(str(e))}


def main(argv) -> None:
    rank, world, port, outdir = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    cases = json.loads(argv[5])
    torch.set_num_threads(1)
    group = init_multihost(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    try:
        for i, (case, args) in enumerate(cases):
            if case == "grads":
                out = canvas_grads(args["route"], group)
            elif case == "halo":
                out = halo_case(group)
            elif case == "train":
                out = canvas_train(args["name"], group, args.get("gated", False))
            elif case == "save":
                out = save_run(args["save_dir"], group)
            elif case == "resume":
                out = resume_case(args["load_state"], group)
            elif case == "refusals":
                out = refusals(group)
            else:
                raise ValueError(f"unknown case {case}")
            np.savez(os.path.join(outdir, f"case{i}_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
