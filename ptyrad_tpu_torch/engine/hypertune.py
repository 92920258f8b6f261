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

Over ranks (``group``, a parallel.DataGroup; the JAX package runs each
trial on its mesh, ptyrad_tpu/engine/hypertune.py:188-340): every rank runs
every trial, its solver on the group, so the store is split and the batches
shared as in a reconstruction. Only rank 0 holds the study: it opens it,
samples, reports, prunes, collates and prints. Before each trial it
broadcasts the trial's number and sampled values (or the end of the study);
the other ranks replay them through ``_FollowerTrial`` and take rank 0's
pruning decision, broadcast after every iteration, so every rank re-runs the
same Initializer stages, leaves the loop at the same iteration and fails a
diverged trial with the others. A canvas-sharded trial
(``recon_params.shard_canvas``) iterates through the solver's canvas loop;
its error reads whole canvases, gathered when the metric needs them, and
every rank gathers the whole canvases after a pruned trial before rank 0
collates.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Optional

import numpy as np

from ptyrad_tpu_torch.engine import tuner as builtin_tuner
from ptyrad_tpu_torch.initialization import Initializer
from ptyrad_tpu_torch.parallel.mesh import broadcast_object, broadcast_str
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


def compute_hypertune_error(solver, error_metric: str, objp=None) -> float:
    """The trial's error: its last loss, or minus the contrast of the phase
    object ``objp`` (a whole canvas; None: the solver's own)."""
    if error_metric == "loss":
        return float(solver.history.loss_iters[-1][1])
    if error_metric == "contrast":
        from ptyrad_tpu_torch.losses import objp_contrast

        objp = solver.params.objp if objp is None else objp
        return -objp_contrast(
            objp.detach().cpu().numpy(), solver.buffers.crop_pos.cpu().numpy(),
            solver.geom.probe_shape, solver.indices,
        )
    raise ValueError(f"Unsupported error_metric '{error_metric}'; use 'loss' or 'contrast'")


class _StopTrial(Exception):
    """Raised by the trial's callback to leave the iteration loop once the
    pruner has spoken."""


class _LeadTrial:
    """Rank 0's side of a trial over ranks: the study's trial, whose sampled
    values it records and announces to the other ranks, and whose pruning
    decision it sends them."""

    def __init__(self, trial, group):
        self.trial, self.group, self.values = trial, group, {}
        self.number = trial.number

    @property
    def params(self) -> dict:
        return self.trial.params

    def _keep(self, name, value):
        self.values[name] = value
        return value

    def suggest_float(self, name, *args, **kwargs):
        return self._keep(name, self.trial.suggest_float(name, *args, **kwargs))

    def suggest_int(self, name, *args, **kwargs):
        return self._keep(name, self.trial.suggest_int(name, *args, **kwargs))

    def suggest_categorical(self, name, *args, **kwargs):
        return self._keep(name, self.trial.suggest_categorical(name, *args, **kwargs))

    def announce(self) -> None:
        broadcast_object((self.number, self.values), self.group)

    def report(self, value: float, step: int) -> None:
        self.trial.report(value, step)

    def should_prune(self) -> bool:
        return broadcast_object(bool(self.trial.should_prune()), self.group)


class _FollowerTrial:
    """Another rank's side: rank 0's trial number and sampled values,
    reports that go nowhere, and rank 0's pruning decision."""

    def __init__(self, number: int, values: dict, group):
        self.number, self.values, self.group = number, dict(values), group
        self.params = self.values

    def _value(self, name, *args, **kwargs):
        return self.values[name]

    suggest_float = suggest_int = suggest_categorical = _value

    def announce(self) -> None:
        pass

    def report(self, value: float, step: int) -> None:
        pass

    def should_prune(self) -> bool:
        return broadcast_object(None, self.group)


def hypertune_objective(trial, params: dict, init: Initializer, device=None,
                        verbose: bool = False, group=None) -> float:
    """One trial: apply sampled params, rebuild the model, run NITER
    iterations with per-iteration pruning reports, collate results.
    run_hypertune passes catch=(FloatingPointError,) to optuna, so a diverged
    trial is recorded as failed without ending the study. With a group of
    ranks, ``trial`` is a _LeadTrial on rank 0 (which announces the sampled
    values once they are drawn) or a _FollowerTrial, and rank 0 alone
    collates."""
    trial_params = apply_trial_params(trial, params, init)
    if group is not None:
        trial.announce()
    recon_params = trial_params["recon_params"]
    ht = trial_params["hypertune_params"]
    n_iter = int(recon_params.get("NITER", 50))
    trial_id = "t" + str(trial.number).zfill(4)

    solver, error, pruned = _run_trial_loop(trial, trial_params, init, device, verbose, ht,
                                            n_iter, group)
    if ht.get("collate_results", True) and (group is None or group.is_main):
        _collate_trial(trial, trial_params, init, solver, error, trial_id, ht, recon_params)
    if pruned:
        raise _pruned_exception()
    return error


def _run_trial_loop(trial, trial_params, init, device, verbose, ht, n_iter, group=None):
    """Build the trial's solver and run its iterations through the
    production loop; returns (solver, error, pruned).

    Adam and the other per-batch optimizers run recon_loop (the batch order
    permuted per iteration, the due constraints after each). LBFGS runs
    _lbfgs_loop on the permuted batches, as the JAX package's trial passes
    them to its lbfgs_step. A canvas-sharded solver runs its canvas loop
    (the per-slab draw; LBFGS on iteration 0's split), the callback on the
    rank's slabs, and ends with whole canvases even when pruned. After each
    iteration the callback raises FloatingPointError on a non-finite loss
    (before any report: a NaN value would break the TPE sort order and is
    unprunable), then, with a pruner, reports the error and stops the loop
    when the pruner says so."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver, recon_loop

    solver = PtyRADSolver(trial_params, init_variables=init.init_variables, device=device,
                          verbose=verbose, group=group)
    solver.prepare()
    solver._build()
    state = {"error": None, "pruned": False}
    canvas = solver._canvas is not None

    def callback(niter, params, history):
        total = history.loss_iters[-1][1]
        if not np.isfinite(total):
            raise FloatingPointError(f"trial diverged: non-finite loss at iter {niter}")
        if ht.get("pruner_params") is not None:
            objp = None
            if canvas and ht["error_metric"] == "contrast":
                shard = solver._canvas[0]
                objp = shard.gather(shard.params.objp)
            state["error"] = compute_hypertune_error(solver, ht["error_metric"], objp)
            trial.report(state["error"], niter)
            if trial.should_prune():
                state["pruned"] = True
                raise _StopTrial()

    # the canvas loop hands this callback the rank's slabs, ungathered
    callback.canvas_slabs = True
    try:
        if canvas:
            solver._canvas_loop(n_iter, callback)
        elif solver.lbfgs_objective is not None:
            solver._lbfgs_loop(n_iter, callback, permute=True)
        else:
            recon_loop(solver.train_epoch, solver.params, solver.batch_idx, solver.batch_mask,
                       n_iter, solver.constraint_fn, solver.buffers, history=solver.history,
                       callback=callback, verbose=verbose, optimizer=solver.optimizer)
    except _StopTrial:
        if canvas:
            solver._canvas_close()
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
                 solver.checkpoint_optimizer, solver.history, niter, solver.indices,
                 lr_dict=solver.lr_dict, start_dict=solver.start_dict, collate_str=collate_str)
    selected = recon_params.get("selected_figs") or []
    if selected:
        plot_summary(out_dir, solver.params, solver.buffers, solver.geom, solver.history, niter,
                     solver.indices, selected_figs=selected, init_variables=init.init_variables,
                     collate_str=collate_str)


def _follow_trials(params: dict, init: Initializer, device, verbose: bool, group,
                   use_optuna: bool) -> None:
    """A rank other than 0: run each trial rank 0 announces until it
    announces the end. A trial ends here as the study on rank 0 ends it: a
    pruned or diverged one always; with the built-in engine any failed one
    (it records every failure and goes on), with optuna only those (the rest
    end the study on every rank)."""
    caught = ((Exception,) if not use_optuna
              else (FloatingPointError, type(_pruned_exception())))
    while True:
        message = broadcast_object(None, group)
        if message is None:
            return
        number, values = message
        try:
            hypertune_objective(_FollowerTrial(number, values, group), params, init,
                                device=device, verbose=verbose, group=group)
        except caught:
            pass


def _pruned_exception():
    try:
        import optuna

        return optuna.exceptions.TrialPruned()
    except ImportError:
        return builtin_tuner.TrialPruned()


def run_hypertune(params: dict, logger=None, jobid: Optional[str] = None,
                  use_optuna: Optional[bool] = None, device=None, init_rng=None, group=None):
    """Create or load the (shared) study and optimize (reference
    reconstruction.py:145-240). Returns the study (None on a rank other
    than 0).

    logger: a CustomLogger, flushed into recon_params.output_dir (its file
    name carries the worker's job id). jobid: the worker's label (the
    logger's file name carries it). device: None means CUDA (the group's
    device with a group). init_rng: the Initializer's generator; None with a
    group is one seed broadcast from rank 0. group: a parallel.DataGroup
    whose ranks all run every trial (see the module docstring); None is one
    process. The trials print each iteration unless recon_params.if_quiet.
    A study that collates a checkpoint checks that h5py imports before the
    Initializer runs."""
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
    if group is not None and init_rng is None:
        # one seed for every rank's Initializer, as PtyRADSolver seeds its own
        seed = broadcast_str(str(np.random.SeedSequence().entropy % 2**32), group)
        init_rng = np.random.RandomState(int(seed))
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
    if group is not None and not group.is_main:
        _follow_trials(params, init, device, verbose, group, use_optuna)
        return None

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

    vprint(f"Starting hypertune: {n_trials} trials, engine={'optuna' if use_optuna else 'builtin'}"
           + (f", every trial on {group.size} ranks" if group is not None else ""))
    optimize_kwargs = {}
    if use_optuna:
        # a diverged trial raises FloatingPointError; without catch= optuna
        # ends the whole study at the first bad trial (the reference's bug,
        # reconstruction.py:234). The builtin engine records every failed
        # trial and goes on (tuner.Study.optimize).
        optimize_kwargs["catch"] = (FloatingPointError,)

    def objective(trial):
        if group is not None:
            trial = _LeadTrial(trial, group)
        return hypertune_objective(trial, params, init, device=device, verbose=verbose,
                                   group=group)

    study.optimize(objective, n_trials=n_trials, timeout=timeout, **optimize_kwargs)
    # the end of the study; a trial that raised past the study's own catch
    # raised on every rank and ends them all
    broadcast_object(None, group)
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
