"""Reconstruction engine: train epoch, iteration loop, solver facade.

Counterpart of ptyrad_tpu/engine/solver.py for one device, from a params
dict (through the Initializer) or a prebuilt init_variables. Each iteration
is a Python loop over the padded mini-batches: the loss
(``fused_loss_terms`` when in regime, else ``forward`` + ``combined_loss``),
backward, start-iter gating of the gradients, the optimizer's step (with
``grad_accumulation`` k > 1, one step every k batches, optim.MultiSteps),
the updates of tensors that have not started put back; then the due
constraints. The per-batch loss terms stay on the device and reach the host
once per iteration. LBFGS instead takes one step an iteration on the mean
of all batch losses (``build_lbfgs_objective``, ``PtyRADSolver._lbfgs_loop``).
An iteration of recon_loop, each step and their phases run under the spans
of utils/tracing.py (``ptyrad.iter``, ``ptyrad.step`` and their parts), and
the optimizer's construction under ``ptyrad.setup.optimizer``.

``optimizer_params.load_state`` resumes the optimizer from a model.hdf5
(either package's or upstream PtyRAD's), and ``recon_loop(start_niter=)``
continues a run at a given iteration; engine/workflow.py saves.

Data parallelism (``group``, a parallel.DataGroup; ptyrad_tpu/engine/
solver.py:410-600 on a mesh): every rank builds the same padded batches (a
fixed group seed, the length a multiple of the world size), takes its
contiguous block of each (parallel.rank_slice), computes the whole batch's
loss terms (the loss all-reduces its batch sums) and, after backward, sums
every gradient over the ranks in one flat buffer before the start-iter
gating and the optimizer's step; the parameters stay bit-identical across
ranks. With ``recon_params.shard_measurements`` (the default) each rank
keeps its block of the measurement store and every batch's loss first
fetches its slice's rows from the ranks that hold them
(``RankBatches``, parallel.exchange_rows).

Canvas sharding (``recon_params.shard_canvas`` on more than one rank;
ptyrad_tpu/engine/solver.py:605-880, parallel/canvas.py): each rank keeps
its row slab of obja/objp, of the optimizer's canvas-shaped state and of the
measurement store (the whole store stays on the host, ``make_model(...,
store_on_host=True)``); each iteration draws every slab's batches
(canvas_iteration_batches), the loss runs on the rank's halo-extended slab
(CanvasShard.loss) and only the replicated tensors' gradients are summed
over the ranks; constraints, callbacks and saves see whole canvases.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ptyrad_tpu_torch.constraints import ConstraintScheduler
from ptyrad_tpu_torch.device import resolve_device
from ptyrad_tpu_torch.engine.batching import make_batches, pad_batches, select_scan_indices
from ptyrad_tpu_torch.initialization import Initializer
from ptyrad_tpu_torch.losses import combined_loss
from ptyrad_tpu_torch.models.forward import forward, fused_loss_terms, get_measurements
from ptyrad_tpu_torch.models.state import Buffers, Geometry, PtychoParams, make_model
from ptyrad_tpu_torch.optim import (OptStateMismatchError, create_optimizer, is_lbfgs,
                                    load_opt_state_hdf5, mask_unstarted_grads,
                                    optim_state_values, started, unstarted_tensors)
from ptyrad_tpu_torch.parallel.canvas import CanvasShard, canvas_batch_count, plan_canvas
from ptyrad_tpu_torch.parallel.mesh import (DataGroup, all_reduce_grads, broadcast_str,
                                            exchange_plan, exchange_rows, rank_slice,
                                            shard_model)
from ptyrad_tpu_torch.utils.logging import vprint
from ptyrad_tpu_torch.utils.tracing import span


def loss_fn(params: PtychoParams, buffers: Buffers, geom: Geometry, indices, mask,
            loss_params, group: Optional[DataGroup] = None, rows=None):
    """(total, terms) for one batch, the loss-folded chain first. With a
    group, indices and mask are the rank's slice and the terms the whole
    batch's. ``rows``: the slice's store rows when the store is split over
    the ranks (RankBatches fetches them)."""
    fused = fused_loss_terms(params, buffers, geom, indices, mask, loss_params, group, rows)
    if fused is not None:
        return fused
    dp, (obja_p, objp_p) = forward(params, buffers, geom, indices)
    meas = get_measurements(buffers, geom, indices, rows)
    with span("ptyrad.model.loss"):
        return combined_loss(dp, meas, obja_p, objp_p, buffers.omode_occu, loss_params, mask,
                             group)


def params_tensors(params: PtychoParams) -> list:
    return [t for _, t in params.named()]


class RankBatches:
    """A rank's share of every batch on the replicated path: its contiguous
    block of each batch with, when the store is split over the ranks, each
    batch's row exchange (``slice``: idx, mask and one parallel.ExchangePlan
    or None per batch), the loss of it whose terms are the whole batch's
    (``loss``, which runs the exchange), and the tensors whose gradients are
    summed over the ranks (``replicated_tensors``: all of them).
    parallel.canvas.CanvasShard is the canvas path's: the same three methods
    and ``group``. Without a group, the whole batch in one process."""

    def __init__(self, params: PtychoParams, buffers: Buffers, geom: Geometry,
                 group: Optional[DataGroup] = None):
        self.params, self.buffers, self.geom, self.group = params, buffers, geom, group

    def slice(self, idx_all: torch.Tensor, mask_all: torch.Tensor) -> tuple:
        idx, mask = rank_slice(idx_all, mask_all, self.group)
        split = self.buffers.store_split
        if split is None:
            return idx, mask, [None] * idx.shape[0]
        store = self.buffers.measurements
        plans = [exchange_plan(row, split, store.device)
                 for row in idx_all.reshape(-1, idx_all.shape[-1]).cpu().numpy()]
        return idx, mask, plans

    def loss(self, idx, mask, loss_params, plan=None):
        rows = (None if plan is None
                else exchange_rows(self.buffers.measurements, plan, self.group))
        return loss_fn(self.params, self.buffers, self.geom, idx, mask, loss_params, self.group,
                       rows)

    def replicated_tensors(self) -> list:
        return params_tensors(self.params)


def build_train_epoch(params: PtychoParams, share, loss_params: Optional[dict],
                      optimizer: torch.optim.Optimizer, start_iters: Dict[str, int]):
    """One call per iteration over all (padded) batches.

    Returns train_epoch(idx_all, mask_all, niter) -> (mean total, {term:
    per-batch values}), with idx_all/mask_all (n_batches, L) tensors on the
    device; params are updated in place. The updates of tensors whose
    start_iter has not come are masked as the gradients are (their values
    are put back after the step): decoupled or coupled weight decay would
    move them otherwise (ptyrad_tpu/engine/solver.py:84-90). ``share`` (a
    RankBatches, or under canvas sharding the rank's CanvasShard) says what
    the rank computes of each batch: its part of the batch, the loss, and
    the tensors whose gradients are summed over the ranks, before the gating
    and the step (under grad_accumulation, before MultiSteps accumulates
    them).
    """
    tensors = share.replicated_tensors()

    def train_epoch(idx_all: torch.Tensor, mask_all: torch.Tensor, niter: int):
        totals, term_rows = [], []
        frozen = unstarted_tensors(params, niter, start_iters)
        idx_all, mask_all, plans = share.slice(idx_all, mask_all)
        for b in range(idx_all.shape[0]):
            with span("ptyrad.step"):
                optimizer.zero_grad(set_to_none=True)
                with span("ptyrad.step.loss"):
                    total, terms = share.loss(idx_all[b], mask_all[b], loss_params, plans[b])
                with span("ptyrad.step.backward"):
                    total.backward()
                all_reduce_grads(tensors, share.group)
                mask_unstarted_grads(params, niter, start_iters)
                kept = [t.detach().clone() for t in frozen]
                with span("ptyrad.step.optimizer"):
                    optimizer.step()
                with torch.no_grad():
                    for t, k in zip(frozen, kept):
                        t.copy_(k)
                totals.append(total.detach())
                term_rows.append(torch.stack([t.detach() for t in terms.values()]))
        names = list(terms.keys())
        with span("ptyrad.iter.table"):
            table = torch.stack(term_rows).cpu().numpy()  # the one device->host copy
        batch_terms = {k: table[:, i].tolist() for i, k in enumerate(names)}
        return float(torch.stack(totals).mean()), batch_terms

    return train_epoch


def build_lbfgs_objective(params: PtychoParams, share, loss_params: Optional[dict],
                          start_iters: Dict[str, int]):
    """The LBFGS objective (ptyrad_tpu/engine/solver.py build_lbfgs_step):
    objective_of(idx_all, mask_all, niter)() -> (value, {name: gradient}) at
    the live parameters, the value the mean of the per-batch losses (summed
    in batch order in float32, then divided by the batch count) and the
    gradient its gradient: one backward per batch with cotangent 1/n,
    accumulated, so one batch's graph is alive at a time. Tensors that have
    not started (freeze_unstarted_params) and tensors not optimized get a
    zero gradient. ``share`` as in build_train_epoch: over ranks each runs
    its part of every batch, the batch losses are already global (the loss
    reduces over the ranks) and the accumulated gradients of
    share.replicated_tensors() are summed over the ranks once, so the line
    search takes the same steps on every rank."""
    tensors = share.replicated_tensors()

    def objective_of(idx_all: torch.Tensor, mask_all: torch.Tensor, niter: int):
        n = idx_all.shape[0]
        idx_all, mask_all, plans = share.slice(idx_all, mask_all)

        def objective():
            for _, t in params.named():
                t.grad = None
            scale = torch.tensor(1.0 / n, dtype=torch.float32, device=idx_all.device)
            acc = torch.zeros((), dtype=torch.float32, device=idx_all.device)
            for b in range(n):
                total, _ = share.loss(idx_all[b], mask_all[b], loss_params, plans[b])
                acc = acc + total.detach()
                total.backward(scale)
            all_reduce_grads(tensors, share.group)
            grads = {}
            for name, t in params.named():
                live = t.grad is not None and started(name, niter, start_iters)
                grads[name] = t.grad if live else torch.zeros_like(t)
                t.grad = None
            return acc / n, grads

        return objective

    return objective_of


@dataclass
class ReconHistory:
    """Per-iteration records."""

    loss_iters: List[tuple] = field(default_factory=list)
    iter_times: List[float] = field(default_factory=list)
    dz_iters: List[tuple] = field(default_factory=list)
    avg_tilt_iters: List[tuple] = field(default_factory=list)
    term_iters: List[dict] = field(default_factory=list)
    batch_terms: Dict[str, list] = field(default_factory=dict)
    # LBFGS: (niter, line-search steps, objective evaluations) per iteration
    linesearch: List[tuple] = field(default_factory=list)


def iter_batch_perm(niter: int, n_batches: int) -> np.ndarray:
    """Per-iteration batch-order permutation, seeded by the iteration (copied
    exactly from the JAX package so both run the same batch order)."""
    return np.random.default_rng(1000003 * niter + 7).permutation(n_batches)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def recon_loop(train_epoch, params: PtychoParams, batch_idx, batch_mask, n_iter: int,
               constraint_fn: Optional[ConstraintScheduler], buffers: Buffers,
               history: Optional[ReconHistory] = None, callback: Optional[Callable] = None,
               verbose: bool = True, optimizer: Optional[torch.optim.Optimizer] = None,
               start_niter: int = 1):
    """n_iter iterations, numbered from start_niter: the batch order, the
    start_iter gates and the constraints' schedule follow the number, so a
    run resumed at k + 1 from iteration k's parameters and optimizer state
    repeats the uninterrupted run's iteration k + 1. batch_idx and
    batch_mask: (n_batches, L) arrays, taken each iteration in
    iter_batch_perm's order; or batch_idx a function of the iteration
    giving its (idx, mask) arrays (the canvas path's per-slab draw) and
    batch_mask None. callback(niter, params, history) fires after each
    iteration; a callback that declares an ``optimizer`` parameter also
    gets the live optimizer. Halts on a non-finite loss."""
    history = history or ReconHistory()
    cb_takes_optimizer = (callback is not None
                          and "optimizer" in inspect.signature(callback).parameters)
    device = params.obja.device
    if callable(batch_idx):
        batches_of = batch_idx
    else:
        batch_idx, batch_mask = np.asarray(batch_idx), np.asarray(batch_mask)

        def batches_of(niter):
            perm = iter_batch_perm(niter, batch_idx.shape[0])
            return batch_idx[perm], batch_mask[perm]
    for niter in range(start_niter, start_niter + n_iter):
        with span("ptyrad.iter"):
            t0 = time.perf_counter()
            with span("ptyrad.iter.batches"):
                idx_np, mask_np = batches_of(niter)
                idx_dev = torch.as_tensor(idx_np, device=device)
                mask_dev = torch.as_tensor(mask_np, device=device)
            _total, batch_terms = train_epoch(idx_dev, mask_dev, niter)
            term_avgs = {k: float(np.mean(v)) for k, v in batch_terms.items()}
            history.batch_terms = batch_terms
            if constraint_fn is not None:
                with span("ptyrad.iter.constraints"):
                    constraint_fn(params, buffers, niter)
            with span("ptyrad.iter.end"):
                _sync(device)
                iter_t = time.perf_counter() - t0

                total = float(sum(term_avgs.values()))
                if not np.isfinite(total):
                    vprint(
                        f"ERROR: non-finite loss at iter {niter} "
                        f"(terms: {term_avgs}); stopping early. Check learning rates, "
                        "normalization, and constraint settings.",
                    )
                    history.loss_iters.append((niter, total))
                    break
                history.loss_iters.append((niter, total))
                history.term_iters.append(term_avgs)
                history.iter_times.append(iter_t)
                history.dz_iters.append((niter, float(params.slice_thickness.detach())))
                history.avg_tilt_iters.append(
                    (niter, params.obj_tilts.detach().cpu().numpy().mean(0)))

            term_str = ", ".join(f"{k}: {v:.4f}" for k, v in term_avgs.items())
            vprint(f"Iter: {niter}, Total Loss: {total:.4f}, {term_str}, in {iter_t:.3f} sec",
                   verbose=verbose)
            if cb_takes_optimizer:
                callback(niter, params, history, optimizer=optimizer)
            elif callback is not None:
                callback(niter, params, history)
    return params, history


class PtyRADSolver:
    """Reconstruction facade (counterpart of ptyrad_tpu.engine.solver.PtyRADSolver).

    params: dict with init_params, model_params, loss_params,
    constraint_params and recon_params sections (load.load_params reads
    them from a params file). init_variables: a prebuilt init dict; None
    runs ``Initializer(params["init_params"], rng=init_rng).init_all()``.
    init_rng: the Initializer's generator (np.random.RandomState; None is a
    fresh unseeded one). device: None means "cuda" (the group's device with
    a group); pass "cpu" to run the plain PyTorch path on the CPU.
    group: a parallel.DataGroup for data parallelism over ranks (one
    process per rank: parallel.init_multihost, or the CLI's --n_devices /
    --multihost); None is one process. n_devices: the number of devices the
    caller expects, which must be the group's size (1 without a group).
    With recon_params.shard_canvas and a group of more than one rank the
    run is canvas-sharded (parallel/canvas.py; ``_build_canvas``,
    ``_canvas_loop``); on one rank it warns and runs the replicated path.
    """

    def __init__(self, params: Optional[dict] = None, init_variables: Optional[dict] = None,
                 device=None, verbose: bool = True, init_rng=None,
                 group: Optional[DataGroup] = None, n_devices: Optional[int] = None):
        world = group.size if group is not None else 1
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(
                f"n_devices={n_devices} but the run has {world} rank(s): ptyrad_tpu_torch runs "
                "one process per device; start the ranks with `python -m ptyrad_tpu_torch run "
                "--n_devices N` or parallel.init_multihost and pass the group")
        self.group = group
        self.device = resolve_device(device if device is not None or group is None
                                     else group.device)
        self.params_dict = params or {}
        self.verbose = verbose
        if init_variables is None and init_rng is None and group is not None:
            # one seed for every rank's Initializer: the store it builds must agree
            seed = broadcast_str(str(np.random.SeedSequence().entropy % 2**32), group)
            init_rng = np.random.RandomState(int(seed))
        if init_variables is None:
            init = Initializer(self.params_dict["init_params"], verbose=verbose, rng=init_rng)
            init.init_all()
            init_variables = init.init_variables
        self.init_variables = init_variables
        self.model_params = self.params_dict.get("model_params", {}) or {}
        self.recon_params = self.params_dict.get("recon_params", {}) or {}
        canvas = bool(self.recon_params.get("shard_canvas")) and world > 1
        split = (bool(self.recon_params.get("shard_measurements", True)) and world > 1
                 and not canvas)
        # the canvas path and the split store move only their rows to the device
        self.params, self.buffers, self.geom = make_model(
            init_variables, self.model_params, self.device, store_on_host=canvas or split)
        self.params, self.buffers = shard_model(
            self.params, self.buffers, group, shard_measurements=split, verbose=verbose,
            meas_dtype=self.model_params.get("meas_dtype", "float32"))
        self.loss_params = self.params_dict.get("loss_params")
        self.constraint_fn = ConstraintScheduler(self.params_dict.get("constraint_params"),
                                                 self.geom)
        self.history = ReconHistory()
        self.batch_idx = None
        self.indices = None
        self.optimizer = None
        self.train_epoch = None
        self.lbfgs_objective = None
        self.share = None  # RankBatches, or the canvas path's CanvasShard
        self.grad_accumulation = 1
        self._canvas = None  # (CanvasShard, n_batches) under canvas sharding
        self._gathered_state = None

    @property
    def checkpoint_optimizer(self):
        """What a checkpoint reads the optimizer state from: the optimizer,
        or after a canvas-sharded run its state gathered whole on every rank
        (None unless save_result holds 'optim_state')."""
        return self.optimizer if self._canvas is None else self._gathered_state

    def prepare(self):
        rp = self.recon_params
        im = rp.get("INDICES_MODE", {}) or {}
        indices = select_scan_indices(
            self.geom.n_scan_slow, self.geom.n_scan_fast,
            im.get("subscan_slow"), im.get("subscan_fast"), mode=im.get("mode", "full"),
        )
        batch_size = int((rp.get("BATCH_SIZE", {}) or {}).get("size", 32))
        self.grad_accumulation = int((rp.get("BATCH_SIZE", {}) or {}).get("grad_accumulation", 1))
        pos = self.buffers.crop_pos.cpu().numpy()
        world = self.group.size if self.group is not None else 1
        seed = rp.get("GROUP_MODE_SEED")
        if seed is None and world > 1:
            # every rank must build the same batches (ptyrad_tpu/engine/solver.py:487-494)
            seed = 0
        batches = make_batches(indices, pos, batch_size, mode=rp.get("GROUP_MODE", "random"),
                               seed=seed)
        self.batch_idx, self.batch_mask = pad_batches(batches, multiple_of=world)
        self.indices = indices
        return self.batch_idx, self.batch_mask

    def _build(self):
        optimizer_params = self.model_params.get("optimizer_params", {"name": "Adam"})
        self.optimizer_name = optimizer_params.get("name", "Adam")
        if self.recon_params.get("shard_canvas"):
            if self.group is not None and self.group.size > 1:
                self._build_canvas(optimizer_params)
                return
            vprint("WARNING: recon_params.shard_canvas requires more than one rank (--n_devices "
                   "or --multihost); running the replicated path instead.", verbose=self.verbose)
        with span("ptyrad.setup.optimizer"):
            self.optimizer, self.lr_dict, self.start_dict = create_optimizer(
                optimizer_params, self.model_params.get("update_params"), self.params,
                grad_accumulation=self.grad_accumulation)
            self._load_state(optimizer_params.get("load_state"))
        self._build_steps(RankBatches(self.params, self.buffers, self.geom, self.group))

    def _build_steps(self, share) -> None:
        """The epoch, or the LBFGS objective, over ``share``'s part of each
        batch (build_train_epoch)."""
        self.share = share
        if is_lbfgs(self.optimizer_name):
            self.lbfgs_objective = build_lbfgs_objective(self.params, share, self.loss_params,
                                                         self.start_dict)
        else:
            self.train_epoch = build_train_epoch(self.params, share, self.loss_params,
                                                 self.optimizer, self.start_dict)

    def _load_state(self, load_state, cut=None) -> None:
        """optimizer_params.load_state: the optimizer state of a model.hdf5
        (``cut``: CanvasShard.cut_state, the rank's rows of its canvases)."""
        if not load_state:
            return
        if not str(load_state).endswith((".hdf5", ".h5")):
            raise NotImplementedError(
                f"optimizer_params.load_state='{load_state}': ptyrad_tpu_torch resumes the "
                "optimizer from a model.hdf5 (saved with 'optim_state' in save_result); an "
                "orbax optimizer directory is the JAX package's own format")
        try:
            load_opt_state_hdf5(self.optimizer, str(load_state), cut=cut)
            vprint(f"Restored optimizer state from '{load_state}'", verbose=self.verbose)
        except OptStateMismatchError:
            raise  # a fresh state here would pass for the resume asked for
        except (OSError, KeyError, ValueError) as e:
            vprint(f"WARNING: failed to restore optimizer state from '{load_state}': {e}. "
                   "Using fresh state.")

    def _build_canvas(self, optimizer_params: dict) -> None:
        """The canvas-sharded build (ptyrad_tpu/engine/solver.py:605-755): the
        plan over the INDICES_MODE positions, the rank's CanvasShard (its
        padded slabs and its slab store on the device), the optimizer on the
        slab parameters (its canvas-shaped state born slab-sized) with the
        shard attached for the rules that reduce over a tensor, a resumed
        state cut to the rank's rows, and the epoch or LBFGS objective on
        the shard's loss. The batch count is capped at the busiest slab's
        count."""
        if is_lbfgs(self.optimizer_name) and optimizer_params.get("load_state"):
            raise NotImplementedError(
                "shard_canvas + LBFGS cannot resume optimizer state (the line search state "
                "holds padded parameter and gradient copies); drop optimizer_params.load_state "
                "or use a first-order optimizer")
        geom = self.geom
        plan = plan_canvas(self.buffers.crop_pos.cpu().numpy(), self.indices, geom.obj_shape[2],
                           geom.probe_shape[0], self.group.size)
        shard = CanvasShard(self.params, self.buffers, geom, plan, self.group,
                            self.model_params.get("meas_dtype", "float32"))
        self.params = shard.params
        with span("ptyrad.setup.optimizer"):
            self.optimizer, self.lr_dict, self.start_dict = create_optimizer(
                optimizer_params, self.model_params.get("update_params"), self.params,
                grad_accumulation=self.grad_accumulation, slab=shard)
            self._load_state(optimizer_params.get("load_state"), cut=shard.cut_state)
        self._build_steps(shard)
        batch_size = int((self.recon_params.get("BATCH_SIZE", {}) or {}).get("size", 32))
        self._canvas = (shard, canvas_batch_count(plan, len(self.indices), batch_size,
                                                  self.verbose))

    def _canvas_loop(self, n_iter: int, callback: Optional[Callable] = None):
        """Canvas-sharded iterations (ptyrad_tpu/engine/solver.py:757-880):
        recon_loop over each iteration's per-slab draw, or LBFGS on the fixed
        split of iteration 0; due constraints on whole canvases
        (CanvasShard.constrain); ``callback`` as CanvasShard.wrap_callback
        calls it (whole canvases; only on its canvas_save_iters when it has
        that attribute). Then self.params holds the whole canvases and
        checkpoint_optimizer the state gathered whole (_canvas_close, which
        a caller whose callback leaves the loop early calls itself)."""
        shard, n_batches = self._canvas
        wrapped = shard.wrap_callback(callback, self.optimizer, self._canvas_saves_optim)
        constrain = shard.constrain(self.constraint_fn)
        if self.lbfgs_objective is not None:
            self._lbfgs_loop(n_iter, wrapped, batches=shard.local_batches(n_batches, 0),
                             constrain=constrain)
        else:
            recon_loop(self.train_epoch, self.params,
                       lambda niter: shard.local_batches(n_batches, niter), None, n_iter,
                       constrain, self.buffers, history=self.history, callback=wrapped,
                       verbose=self.verbose, optimizer=self.optimizer)
        self._canvas_close()
        return self.params, self.history

    @property
    def _canvas_saves_optim(self) -> bool:
        return "optim_state" in (self.recon_params.get("save_result") or [])

    def _canvas_close(self) -> None:
        """Whole canvases into self.params and, when the run saves it, the
        optimizer state gathered whole (every rank calls it)."""
        shard = self._canvas[0]
        if self._canvas_saves_optim:
            self._gathered_state = shard.gather_state(optim_state_values(self.optimizer))
        self.params = shard.whole_params()

    def _lbfgs_loop(self, n_iter: int, callback: Optional[Callable] = None,
                    start_niter: int = 1, permute: bool = False, batches=None,
                    constrain: Optional[Callable] = None):
        """LBFGS iterations (ptyrad_tpu/engine/solver.py _lbfgs_loop): one
        optimizer step an iteration on the mean loss over all batches in
        their planned order (``permute``: in iter_batch_perm's order of the
        iteration, as the JAX package's hypertune trial passes them), then
        the due constraints; the history records the objective at the start
        of each step (``LBFGS Loss``), the line search's steps and the
        objective's evaluations. callback as for recon_loop. The canvas path
        passes its own ``batches`` (idx, mask arrays) and ``constrain``."""
        history = self.history
        constrain = constrain or self.constraint_fn
        idx_all, mask_all = (self.batch_idx, self.batch_mask) if batches is None else batches
        idx_all = torch.as_tensor(idx_all, device=self.device)
        mask_all = torch.as_tensor(mask_all, device=self.device)
        cb_takes_optimizer = (callback is not None
                              and "optimizer" in inspect.signature(callback).parameters)
        for niter in range(start_niter, start_niter + n_iter):
            t0 = time.perf_counter()
            idx, mask = idx_all, mask_all
            if permute:
                perm = iter_batch_perm(niter, self.batch_idx.shape[0])
                idx = torch.as_tensor(self.batch_idx[perm], device=self.device)
                mask = torch.as_tensor(self.batch_mask[perm], device=self.device)
            value = self.optimizer.step(self.lbfgs_objective(idx, mask, niter))
            constrain(self.params, self.buffers, niter)
            _sync(self.device)
            iter_t = time.perf_counter() - t0
            value = float(value)
            history.loss_iters.append((niter, value))
            history.iter_times.append(iter_t)
            history.dz_iters.append((niter, float(self.params.slice_thickness.detach())))
            history.avg_tilt_iters.append(
                (niter, self.params.obj_tilts.detach().cpu().numpy().mean(0)))
            history.linesearch.append((niter, self.optimizer.info["num_linesearch_steps"],
                                       self.optimizer.evaluations))
            vprint(f"Iter: {niter}, LBFGS Loss: {value:.4f}, in {iter_t:.3f} sec",
                   verbose=self.verbose)
            if cb_takes_optimizer:
                callback(niter, self.params, history, optimizer=self.optimizer)
            elif callback is not None:
                callback(niter, self.params, history)
        return self.params, history

    def reconstruct(self, callback: Optional[Callable] = None):
        n_iter = int(self.recon_params.get("NITER", 100))
        if self.batch_idx is None:
            self.prepare()
        if self.optimizer is None:
            self._build()
        vprint(
            f"Starting reconstruction: {n_iter} iters, "
            f"{self.batch_idx.shape[0]} batches of {self.batch_idx.shape[1]}, "
            f"optimizer={self.optimizer_name}, device={self.device}",
            verbose=self.verbose,
        )
        if self._canvas is not None:
            shard, n_batches = self._canvas
            plan = shard.plan
            vprint(f"Canvas sharding: {plan.n_dev} ranks over {self.group.backend}, slabs of "
                   f"{plan.rows_local} rows + a {plan.halo}-row halo, {int(plan.mask.sum())} "
                   f"positions in {n_batches} batches, {plan.b_local} store rows on each "
                   f"rank ({int(plan.mask.reshape(plan.n_dev, -1)[shard.rank].sum())} real on "
                   "this one)", verbose=self.verbose)
        elif self.group is not None:
            vprint(f"Data parallel: {self.group.size} rank(s) over {self.group.backend}, "
                   f"{self.batch_idx.shape[1] // self.group.size} positions of every batch "
                   "on each", verbose=self.verbose)
        if self.geom.bf16_operands or self.geom.compute_dtype != "float32":
            vprint(f"Compute policy: compute_dtype={self.geom.compute_dtype}, transform "
                   f"operands {'bfloat16' if self.geom.bf16_operands else 'float32'}; "
                   "parameters, gradients and the loss float32", verbose=self.verbose)
        if self._canvas is not None:
            return self._canvas_loop(n_iter, callback)
        if self.lbfgs_objective is not None:
            return self._lbfgs_loop(n_iter, callback)
        self.params, self.history = recon_loop(
            self.train_epoch, self.params, self.batch_idx, self.batch_mask, n_iter,
            self.constraint_fn, self.buffers, history=self.history, callback=callback,
            verbose=self.verbose, optimizer=self.optimizer,
        )
        return self.params, self.history

    def run(self, callback: Optional[Callable] = None):
        """Entry point: reconstruct and report the wall time."""
        t0 = time.perf_counter()
        result = self.reconstruct(callback=callback)
        vprint(f"Reconstruction finished in {time.perf_counter() - t0:.1f} sec",
               verbose=self.verbose)
        return result
