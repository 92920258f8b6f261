"""Hyperparameter tuning: staged re-initialization, pruning, collation
(counterpart of ptyrad_tpu/engine/hypertune.py).

Parity with reference src/ptyrad/reconstruction.py:145-240 (hypertune) and
905-1118 (optuna_objective): each trial samples from up to 22 tunable params
(optimizer, batch size, 6 learning rates, dx, probe params, Nlayer, dz,
4 affine terms, tilts), re-runs only the Initializer stages the sampled
value invalidates, builds a fresh solver, reports the per-iteration error
for pruning, and collates pruned and final results with error-stamped file
names.

A trial runs the production loop: ``recon_loop`` (or ``_lbfgs_loop``) with
a callback that reports the error to the pruner after each iteration and
stops the loop when the pruner says so. A non-finite loss raises
FloatingPointError before it is reported. A kernel that fails inside a
trial raises too: there is no retry with the kernels off.

Multi-worker: N independent processes share one sqlite storage (the
reference's Slurm LoopSubmit pattern); optuna is used when it imports, else
the built-in engine (engine/tuner.py) with the same semantics.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Optional

import numpy as np

from ptyrad_tpu_torch.engine import tuner as builtin_tuner
from ptyrad_tpu_torch.initialization import Initializer
from ptyrad_tpu_torch.utils.logging import vprint

LR_TO_TENSOR = {
    "plr": "probe", "oalr": "obja", "oplr": "objp",
    "slr": "probe_pos_shifts", "tlr": "obj_tilts", "dzlr": "slice_thickness",
}


def _suggest(trial, suggest: str, name: str, kwargs: dict):
    kw = {k: v for k, v in kwargs.items() if k != "optim_configs"}
    if suggest == "cat":
        return trial.suggest_categorical(name, **kw)
    if suggest == "int":
        return trial.suggest_int(name, **kw)
    if suggest == "float":
        return trial.suggest_float(name, **kw)
    raise ValueError(f"suggest method '{suggest}' not supported")


def parse_hypertune_params_to_str(params: dict) -> str:
    return "".join(
        f"_{k}_{v:.4g}" if isinstance(v, float) else f"_{k}_{v}" for k, v in params.items()
    )


def apply_trial_params(trial, params: dict, init: Initializer) -> dict:
    """Sample enabled tune_params and re-run only the invalidated init stages
    (reference reconstruction.py:962-1049). Mutates `init`; returns a fresh
    deep-copied params dict with the sampled values applied."""
    params = deepcopy(params)
    tune = params["hypertune_params"]["tune_params"]

    def on(name):
        return tune[name]["state"]

    def val(name):
        return _suggest(trial, tune[name]["suggest"], name, tune[name]["kwargs"])

    if on("batch_size"):
        params["recon_params"]["BATCH_SIZE"]["size"] = val("batch_size")

    if on("optimizer"):
        optim_name = val("optimizer")
        params["model_params"]["optimizer_params"]["name"] = optim_name
        params["model_params"]["optimizer_params"]["configs"] = (
            tune["optimizer"]["kwargs"].get("optim_configs", {}).get(optim_name, {})
        )

    for vname, tensor in LR_TO_TENSOR.items():
        if on(vname):
            params["model_params"]["update_params"].setdefault(tensor, {"start_iter": 1})
            params["model_params"]["update_params"][tensor]["lr"] = val(vname)
            params["model_params"]["update_params"][tensor].setdefault("start_iter", 1)

    # dx invalidates calibration + everything geometric
    if on("dx"):
        init.init_params["meas_calibration"] = {"mode": "dx", "value": val("dx")}
        init.init_calibration()
        init.set_variables_dict()
        init.init_probe()
        init.init_pos()
        init.init_obj()
        init.init_H()

    # probe shape params invalidate only the probe
    remake_probe = False
    for vname, field in [
        ("pmode_max", "probe_pmode_max"), ("conv_angle", "probe_conv_angle"),
        ("defocus", "probe_defocus"), ("c3", "probe_c3"), ("c5", "probe_c5"),
    ]:
        if on(vname):
            init.init_params[field] = val(vname)
            remake_probe = True
    if remake_probe:
        init.init_probe()

    if on("Nlayer"):
        init.init_params["obj_Nlayer"] = val("Nlayer")
        init.init_obj()

    if on("dz"):
        init.init_params["obj_slice_thickness"] = val("dz")
        init.set_variables_dict()
        init.init_obj()
        init.init_H()

    # affine invalidates positions + object extent. Re-init whenever any
    # affine param is TUNED — gating on value != identity would leave the
    # shared Initializer holding the PREVIOUS trial's positions when this
    # trial happens to sample exactly the identity (cross-trial
    # contamination: recorded params would not reproduce the trial's error)
    affine_init = params["init_params"].get("pos_scan_affine") or [1, 0, 0, 0]
    defaults = dict(zip(["scale", "asymmetry", "rotation", "shear"], affine_init))
    affine_tuned = any(on(v) for v in ("scale", "asymmetry", "rotation", "shear"))
    scan_affine = [val(v) if on(v) else defaults[v] for v in ("scale", "asymmetry", "rotation", "shear")]
    if affine_tuned or scan_affine != [1, 0, 0, 0]:
        init.init_params["pos_scan_affine"] = scan_affine
        init.init_pos()
        init.init_obj()

    # global tilt override — same rule: tuned means re-set every trial
    if on("tilt_y") or on("tilt_x"):
        obj_tilts = [[val("tilt_y") if on("tilt_y") else 0.0,
                      val("tilt_x") if on("tilt_x") else 0.0]]
        init.init_variables["obj_tilts"] = np.asarray(obj_tilts, dtype=np.float32)

    return params


def compute_hypertune_error(solver, error_metric: str) -> float:
    if error_metric == "loss":
        return float(solver.history.loss_iters[-1][1])
    if error_metric == "contrast":
        from ptyrad_tpu_torch.losses import objp_contrast

        return -objp_contrast(
            solver.params.objp.detach().cpu().numpy(), solver.buffers.crop_pos.cpu().numpy(),
            solver.geom.probe_shape, solver.indices,
        )
    raise ValueError(f"Unsupported error_metric '{error_metric}'; use 'loss' or 'contrast'")


class _StopTrial(Exception):
    """Raised by the trial's callback to leave the iteration loop once the
    pruner has spoken."""


def hypertune_objective(trial, params: dict, init: Initializer, device=None,
                        verbose: bool = False) -> float:
    """One trial: apply sampled params, rebuild the model, run NITER
    iterations with per-iteration pruning reports, collate results.
    run_hypertune passes catch=(FloatingPointError,) to optuna, so a diverged
    trial is recorded as failed without ending the study."""
    trial_params = apply_trial_params(trial, params, init)
    recon_params = trial_params["recon_params"]
    ht = trial_params["hypertune_params"]
    n_iter = int(recon_params.get("NITER", 50))
    trial_id = "t" + str(trial.number).zfill(4)

    solver, error, pruned = _run_trial_loop(trial, trial_params, init, device, verbose, ht,
                                            n_iter)
    if ht.get("collate_results", True):
        _collate_trial(trial, trial_params, init, solver, error, trial_id, ht, recon_params)
    if pruned:
        raise _pruned_exception()
    return error


def _run_trial_loop(trial, trial_params, init, device, verbose, ht, n_iter):
    """Build the trial's solver and run its iterations through the
    production loop; returns (solver, error, pruned).

    Adam and the other per-batch optimizers run recon_loop (the batch order
    permuted per iteration, the due constraints after each). LBFGS runs
    _lbfgs_loop on the permuted batches, as the JAX package's trial passes
    them to its lbfgs_step. After each iteration the callback raises
    FloatingPointError on a non-finite loss (before any report: a NaN value
    would break the TPE sort order and is unprunable), then, with a pruner,
    reports the error and stops the loop when the pruner says so."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver, recon_loop

    solver = PtyRADSolver(trial_params, init_variables=init.init_variables, device=device,
                          verbose=verbose)
    solver.prepare()
    solver._build()
    state = {"error": None, "pruned": False}

    def callback(niter, params, history):
        total = history.loss_iters[-1][1]
        if not np.isfinite(total):
            raise FloatingPointError(f"trial diverged: non-finite loss at iter {niter}")
        if ht.get("pruner_params") is not None:
            state["error"] = compute_hypertune_error(solver, ht["error_metric"])
            trial.report(state["error"], niter)
            if trial.should_prune():
                state["pruned"] = True
                raise _StopTrial()

    try:
        if solver.lbfgs_objective is not None:
            solver._lbfgs_loop(n_iter, callback, permute=True)
        else:
            recon_loop(solver.train_epoch, solver.params, solver.batch_idx, solver.batch_mask,
                       n_iter, solver.constraint_fn, solver.buffers, history=solver.history,
                       callback=callback, verbose=verbose, optimizer=solver.optimizer)
    except _StopTrial:
        pass
    losses = solver.history.loss_iters
    if losses and not np.isfinite(losses[-1][1]):
        # recon_loop stops at a non-finite loss before its callback
        raise FloatingPointError(f"trial diverged: non-finite loss at iter {losses[-1][0]}")
    error = state["error"]
    if error is None:
        error = compute_hypertune_error(solver, ht["error_metric"])
    return solver, error, state["pruned"]


def _collate_trial(trial, trial_params, init, solver, error, trial_id, ht, recon_params):
    """The trial's results and figures in output_dir, each name stamped
    with ``_error_<error>_<trial_id>`` and the sampled params. A failed
    drawing only warns (plot_summary); a failed save or forward_panels
    raises."""
    from ptyrad_tpu_torch.save import save_results
    from ptyrad_tpu_torch.visualization import plot_summary

    params_str = parse_hypertune_params_to_str(trial.params) if ht.get("append_params", True) else ""
    collate_str = f"_error_{error:.5f}_{trial_id}{params_str}"
    out_dir = recon_params.get("output_dir", "output/")
    niter = len(solver.history.loss_iters)
    save_results(out_dir, solver.params, solver.buffers, solver.geom, trial_params,
                 solver.optimizer, solver.history, niter, solver.indices,
                 lr_dict=solver.lr_dict, start_dict=solver.start_dict, collate_str=collate_str)
    selected = recon_params.get("selected_figs") or []
    if selected:
        plot_summary(out_dir, solver.params, solver.buffers, solver.geom, solver.history, niter,
                     solver.indices, selected_figs=selected, init_variables=init.init_variables,
                     collate_str=collate_str)


def _pruned_exception():
    try:
        import optuna

        return optuna.exceptions.TrialPruned()
    except ImportError:
        return builtin_tuner.TrialPruned()


def run_hypertune(params: dict, logger=None, jobid: Optional[str] = None,
                  use_optuna: Optional[bool] = None, device=None, init_rng=None):
    """Create or load the (shared) study and optimize (reference
    reconstruction.py:145-240). Returns the study.

    logger: a CustomLogger, flushed into recon_params.output_dir (its file
    name carries the worker's job id). jobid: the worker's label (the
    logger's file name carries it). device: None means CUDA. init_rng: the
    Initializer's generator. The trials print each iteration unless
    recon_params.if_quiet. A study that collates a checkpoint checks that
    h5py imports before the Initializer runs."""
    from ptyrad_tpu_torch.save import import_h5py

    ht = params["hypertune_params"]
    recon_params = params.get("recon_params", {}) or {}
    verbose = not recon_params.get("if_quiet", False)
    save_list = recon_params.get("save_result") or ["model", "obj", "probe"]
    if ht.get("collate_results", True) and ("model" in save_list or "optim_state" in save_list):
        import_h5py(f"hypertune collate_results with save_result {save_list}: the checkpoint "
                    "model.hdf5")
    if logger is not None:
        logger.flush_to_dir(recon_params.get("output_dir", "output/"))
    if jobid not in (None, "", "0", 0):
        vprint(f"Hypertune worker {jobid}")
    init = Initializer(params["init_params"], verbose=False, rng=init_rng)
    init.init_all()

    if use_optuna is None:
        try:
            import optuna  # noqa: F401

            use_optuna = True
        except ImportError:
            use_optuna = False

    n_trials = int(ht.get("n_trials", 50))
    timeout = ht.get("timeout")

    if use_optuna:
        import optuna

        sampler_cls = getattr(optuna.samplers, ht["sampler_params"]["name"])
        sampler = sampler_cls(**(ht["sampler_params"].get("configs") or {}))
        pruner = None
        if ht.get("pruner_params") is not None:
            pruner_cls = getattr(optuna.pruners, ht["pruner_params"]["name"])
            pruner = pruner_cls(**(ht["pruner_params"].get("configs") or {}))
        storage = ht.get("storage_path", "hypertune.db")
        if storage is not None and not storage.startswith("sqlite:"):
            # None = in-memory study, like the reference's storage=None
            storage = f"sqlite:///{storage}"
        study = optuna.create_study(
            study_name=ht.get("study_name", "ptyrad_hypertune"),
            storage=storage,
            sampler=sampler, pruner=pruner, direction="minimize", load_if_exists=True,
        )
    else:
        study = builtin_tuner.create_study(
            study_name=ht.get("study_name", "ptyrad_hypertune"),
            # the same default as the optuna branch and the schema
            storage_path=ht.get("storage_path", "hypertune.db"),
            sampler_params=ht.get("sampler_params"),
            pruner_params=ht.get("pruner_params"),
            load_if_exists=True,
        )

    vprint(f"Starting hypertune: {n_trials} trials, engine={'optuna' if use_optuna else 'builtin'}")
    optimize_kwargs = {}
    if use_optuna:
        # a diverged trial raises FloatingPointError; without catch= optuna
        # ends the whole study at the first bad trial (the reference's bug,
        # reconstruction.py:234). The builtin engine records every failed
        # trial and goes on (tuner.Study.optimize).
        optimize_kwargs["catch"] = (FloatingPointError,)
    study.optimize(
        lambda trial: hypertune_objective(trial, params, init, device=device, verbose=verbose),
        n_trials=n_trials, timeout=timeout, **optimize_kwargs,
    )
    try:
        best = study.best_trial
    except ValueError:
        # optuna raises when no trial completed (the builtin engine returns None)
        best = None
    if best is None:
        vprint("WARNING: no completed trials — nothing to report as best")
    elif isinstance(best, dict):
        vprint(f"Best trial: #{best['number']} value={best['value']:.6g} params={best['params']}")
    else:
        vprint(f"Best trial: #{best.number} value={best.value:.6g} params={best.params}")
    return study
