"""A reconstruction from a params dict to its saved results (counterpart of
ptyrad_tpu/engine/workflow.py:run_reconstruction).

Build the solver (the Initializer, the model), create the self-describing
output folder, copy the params file there, move the log there, train with a
callback that saves every SAVE_ITERS iterations, then save the last
iteration unless the callback has just saved it. A run that would save a
checkpoint (``model`` or ``optim_state`` in save_result) checks that h5py
imports before anything else, so a missing h5py ends the run before its
first iteration rather than at its first save. Figures (selected_figs) are
ROADMAP item A9: asked for, they are skipped with one warning.
"""

from __future__ import annotations

from typing import Optional

from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.save import (copy_params_to_dir, import_h5py, make_output_folder,
                                   save_results)
from ptyrad_tpu_torch.utils.logging import vprint


def run_reconstruction(params: dict, logger=None, verbose: Optional[bool] = None, device=None,
                       init_rng=None) -> PtyRADSolver:
    """The whole run; returns the solver, its ``output_path`` set.

    params: a params dict as load_params gives it. logger: a CustomLogger,
    flushed into the output folder once it exists. device: None means CUDA
    (see device.resolve_device). init_rng: the Initializer's generator.
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
    if recon_params.get("selected_figs"):
        vprint(f"WARNING: selected_figs {recon_params['selected_figs']} skipped: figures are "
               "not ported yet (ROADMAP item A9)")

    solver = PtyRADSolver(params, device=device, verbose=verbose, init_rng=init_rng)
    solver.prepare()
    output_path = make_output_folder(
        recon_params.get("output_dir", "output/"), solver.indices, params, solver.params,
        solver.geom, recon_dir_affixes=recon_params.get("recon_dir_affixes"))
    vprint(f"Output folder: {output_path}", verbose=verbose)
    if recon_params.get("copy_params", True):
        copy_params_to_dir(params.get("params_path"), output_path)
    if logger is not None:
        logger.flush_to_dir(output_path)

    save_iters = recon_params.get("SAVE_ITERS")
    last_saved = {"niter": None}

    def save(niter, optimizer):
        save_results(output_path, solver.params, solver.buffers, solver.geom, params,
                     optimizer, solver.history, niter, solver.indices,
                     lr_dict=solver.lr_dict, start_dict=solver.start_dict)
        last_saved["niter"] = niter

    def callback(niter, cur_params, history, optimizer=None):
        if save_iters and niter % save_iters == 0:
            save(niter, optimizer)

    solver.run(callback=callback)
    # the callback has already written the last iteration when it lands on
    # a SAVE_ITERS boundary
    n_final = len(solver.history.loss_iters)
    if last_saved["niter"] != n_final or n_final == 0:
        save(n_final, solver.optimizer)
    solver.output_path = output_path
    return solver
