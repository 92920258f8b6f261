"""A reconstruction from a params dict to its saved results (counterpart of
ptyrad_tpu/engine/workflow.py:run_reconstruction).

Build the solver (the Initializer, the model), create the self-describing
output folder, copy the params file there, move the log there, train with a
callback that saves every SAVE_ITERS iterations, then save the last
iteration unless the callback has just saved it. A run that would save a
checkpoint (``model`` or ``optim_state`` in save_result) checks that h5py
imports before anything else, so a missing h5py ends the run before its
first iteration rather than at its first save. With selected_figs, the
position grouping is drawn once the folder exists (``group`` or ``all``:
summary_grouping.png) and visualization.plot_summary draws the summary
figures after each SAVE_ITERS save (ptyrad_tpu/engine/workflow.py:56-103).

With a group (parallel.DataGroup) every rank composes the folder name and
takes rank 0's (parallel.broadcast_str: a prefix_time name can differ by a
clock tick); only rank 0 makes the folder, copies the params, writes the
log, draws and saves (ptyrad_tpu/engine/workflow.py:34-57, :80-115).
Under recon_params.shard_canvas the callback fires on save iterations only
and gets whole canvases; the last save takes the optimizer state the solver
gathered whole on every rank (``solver.checkpoint_optimizer``).
"""

from __future__ import annotations

from typing import Optional

from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.parallel.mesh import broadcast_str
from ptyrad_tpu_torch.save import (copy_params_to_dir, import_h5py, make_output_folder,
                                   save_results)
from ptyrad_tpu_torch.utils.logging import vprint
from ptyrad_tpu_torch.visualization import plot_summary, save_grouping_figure


def run_reconstruction(params: dict, logger=None, verbose: Optional[bool] = None, device=None,
                       init_rng=None, group=None) -> PtyRADSolver:
    """The whole run; returns the solver, its ``output_path`` set.

    params: a params dict as load_params gives it. logger: a CustomLogger,
    flushed into the output folder once it exists. device: None means CUDA
    (see device.resolve_device). init_rng: the Initializer's generator.
    group: a parallel.DataGroup (None: one process).
    """
    recon_params = params.get("recon_params", {}) or {}
    if verbose is None:
        verbose = not recon_params.get("if_quiet", False)
    save_list = recon_params.get("save_result") or ["model", "obj", "probe"]
    if "model" in save_list or "optim_state" in save_list:
        import_h5py(f"save_result {save_list}: the checkpoint model.hdf5")
    if "optim_state" in save_list and "model" not in save_list:
        vprint("WARNING: save_result holds 'optim_state' without 'model': the optimizer state "
               "is saved inside model.hdf5, so none is written")

    solver = PtyRADSolver(params, device=device, verbose=verbose, init_rng=init_rng,
                          group=group)
    solver.prepare()
    main = group is None or group.is_main
    output_path = broadcast_str(make_output_folder(
        recon_params.get("output_dir", "output/"), solver.indices, params, solver.params,
        solver.geom, recon_dir_affixes=recon_params.get("recon_dir_affixes"),
        make_dir=main), group)
    vprint(f"Output folder: {output_path}", verbose=verbose)
    if recon_params.get("copy_params", True) and main:
        copy_params_to_dir(params.get("params_path"), output_path)
    if logger is not None:
        logger.flush_to_dir(output_path)
    selected = recon_params.get("selected_figs") or []
    if ("group" in selected or "all" in selected) and main:
        save_grouping_figure(output_path, solver.buffers.crop_pos.cpu().numpy(),
                             solver.batch_idx, solver.batch_mask)

    save_iters = recon_params.get("SAVE_ITERS")
    last_saved = {"niter": None}

    def save(niter, optimizer, cur_params):
        save_results(output_path, cur_params, solver.buffers, solver.geom, params,
                     optimizer, solver.history, niter, solver.indices,
                     lr_dict=solver.lr_dict, start_dict=solver.start_dict)
        last_saved["niter"] = niter

    def callback(niter, cur_params, history, optimizer=None):
        if save_iters and niter % save_iters == 0:
            save(niter, optimizer, cur_params)
            if selected and main:
                plot_summary(output_path, cur_params, solver.buffers, solver.geom, history,
                             niter, solver.indices, selected_figs=selected,
                             init_variables=solver.init_variables)

    # under shard_canvas each call gathers whole canvases on every rank: the
    # canvas loop calls this callback on save iterations only
    callback.canvas_save_iters = save_iters
    solver.run(callback=callback)
    # the callback has already written the last iteration when it lands on
    # a SAVE_ITERS boundary
    n_final = len(solver.history.loss_iters)
    if last_saved["niter"] != n_final or n_final == 0:
        save(n_final, solver.checkpoint_optimizer, solver.params)
    solver.output_path = output_path
    return solver
