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

``optimizer_params.load_state`` resumes the optimizer from a model.hdf5
(either package's or upstream PtyRAD's), and ``recon_loop(start_niter=)``
continues a run at a given iteration; engine/workflow.py saves. Not in this
slice: device meshes and canvas sharding (ROADMAP queue A).
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
                                    load_opt_state_hdf5, mask_unstarted_grads, started,
                                    unstarted_tensors)
from ptyrad_tpu_torch.utils.logging import vprint


def loss_fn(params: PtychoParams, buffers: Buffers, geom: Geometry, indices, mask,
            loss_params):
    """(total, terms) for one batch, the loss-folded chain first."""
    fused = fused_loss_terms(params, buffers, geom, indices, mask, loss_params)
    if fused is not None:
        return fused
    dp, (obja_p, objp_p) = forward(params, buffers, geom, indices)
    meas = get_measurements(buffers, geom, indices)
    return combined_loss(dp, meas, obja_p, objp_p, buffers.omode_occu, loss_params, mask)


def build_train_epoch(params: PtychoParams, buffers: Buffers, geom: Geometry,
                      loss_params: Optional[dict], optimizer: torch.optim.Optimizer,
                      start_iters: Dict[str, int]):
    """One call per iteration over all (padded) batches.

    Returns train_epoch(idx_all, mask_all, niter) -> (mean total, {term:
    per-batch values}), with idx_all/mask_all (n_batches, L) tensors on the
    device; params are updated in place. The updates of tensors whose
    start_iter has not come are masked as the gradients are (their values
    are put back after the step): decoupled or coupled weight decay would
    move them otherwise (ptyrad_tpu/engine/solver.py:84-90).
    """

    def train_epoch(idx_all: torch.Tensor, mask_all: torch.Tensor, niter: int):
        totals, term_rows = [], []
        frozen = unstarted_tensors(params, niter, start_iters)
        for b in range(idx_all.shape[0]):
            optimizer.zero_grad(set_to_none=True)
            total, terms = loss_fn(params, buffers, geom, idx_all[b], mask_all[b], loss_params)
            total.backward()
            mask_unstarted_grads(params, niter, start_iters)
            kept = [t.detach().clone() for t in frozen]
            optimizer.step()
            with torch.no_grad():
                for t, k in zip(frozen, kept):
                    t.copy_(k)
            totals.append(total.detach())
            term_rows.append(torch.stack([t.detach() for t in terms.values()]))
        names = list(terms.keys())
        table = torch.stack(term_rows).cpu().numpy()  # the one device->host copy
        batch_terms = {k: table[:, i].tolist() for i, k in enumerate(names)}
        return float(torch.stack(totals).mean()), batch_terms

    return train_epoch


def build_lbfgs_objective(params: PtychoParams, buffers: Buffers, geom: Geometry,
                          loss_params: Optional[dict], start_iters: Dict[str, int]):
    """The LBFGS objective (ptyrad_tpu/engine/solver.py build_lbfgs_step):
    objective_of(idx_all, mask_all, niter)() -> (value, {name: gradient}) at
    the live parameters, the value the mean of the per-batch losses (summed
    in batch order in float32, then divided by the batch count) and the
    gradient its gradient: one backward per batch with cotangent 1/n,
    accumulated, so one batch's graph is alive at a time. Tensors that have
    not started (freeze_unstarted_params) and tensors not optimized get a
    zero gradient."""

    def objective_of(idx_all: torch.Tensor, mask_all: torch.Tensor, niter: int):
        n = idx_all.shape[0]

        def objective():
            for _, t in params.named():
                t.grad = None
            scale = torch.tensor(1.0 / n, dtype=torch.float32, device=idx_all.device)
            acc = torch.zeros((), dtype=torch.float32, device=idx_all.device)
            for b in range(n):
                total, _ = loss_fn(params, buffers, geom, idx_all[b], mask_all[b], loss_params)
                acc = acc + total.detach()
                total.backward(scale)
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


def recon_loop(train_epoch, params: PtychoParams, batch_idx: np.ndarray,
               batch_mask: np.ndarray, n_iter: int,
               constraint_fn: Optional[ConstraintScheduler], buffers: Buffers,
               history: Optional[ReconHistory] = None, callback: Optional[Callable] = None,
               verbose: bool = True, optimizer: Optional[torch.optim.Optimizer] = None,
               start_niter: int = 1):
    """n_iter iterations, numbered from start_niter: the batch order, the
    start_iter gates and the constraints' schedule follow the number, so a
    run resumed at k + 1 from iteration k's parameters and optimizer state
    repeats the uninterrupted run's iteration k + 1. callback(niter, params,
    history) fires after each iteration; a callback that declares an
    ``optimizer`` parameter also gets the live optimizer. Halts on a
    non-finite loss."""
    history = history or ReconHistory()
    cb_takes_optimizer = (callback is not None
                          and "optimizer" in inspect.signature(callback).parameters)
    device = params.obja.device
    batch_idx = np.asarray(batch_idx)
    batch_mask = np.asarray(batch_mask)
    for niter in range(start_niter, start_niter + n_iter):
        t0 = time.perf_counter()
        perm = iter_batch_perm(niter, batch_idx.shape[0])
        idx_dev = torch.as_tensor(batch_idx[perm], device=device)
        mask_dev = torch.as_tensor(batch_mask[perm], device=device)
        _total, batch_terms = train_epoch(idx_dev, mask_dev, niter)
        term_avgs = {k: float(np.mean(v)) for k, v in batch_terms.items()}
        history.batch_terms = batch_terms
        if constraint_fn is not None:
            constraint_fn(params, buffers, niter)
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
        history.avg_tilt_iters.append((niter, params.obj_tilts.detach().cpu().numpy().mean(0)))

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
    fresh unseeded one). device: None means "cuda"; pass "cpu" to run the
    plain PyTorch path on the CPU.
    """

    def __init__(self, params: Optional[dict] = None, init_variables: Optional[dict] = None,
                 device=None, verbose: bool = True, init_rng=None):
        self.device = resolve_device(device)
        self.params_dict = params or {}
        self.verbose = verbose
        if init_variables is None:
            init = Initializer(self.params_dict["init_params"], verbose=verbose, rng=init_rng)
            init.init_all()
            init_variables = init.init_variables
        self.init_variables = init_variables
        self.model_params = self.params_dict.get("model_params", {}) or {}
        self.params, self.buffers, self.geom = make_model(
            init_variables, self.model_params, self.device)
        self.recon_params = self.params_dict.get("recon_params", {}) or {}
        self.loss_params = self.params_dict.get("loss_params")
        self.constraint_fn = ConstraintScheduler(self.params_dict.get("constraint_params"),
                                                 self.geom)
        self.history = ReconHistory()
        self.batch_idx = None
        self.indices = None
        self.optimizer = None
        self.train_epoch = None
        self.lbfgs_objective = None
        self.grad_accumulation = 1

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
        batches = make_batches(indices, pos, batch_size, mode=rp.get("GROUP_MODE", "random"),
                               seed=rp.get("GROUP_MODE_SEED"))
        self.batch_idx, self.batch_mask = pad_batches(batches)
        self.indices = indices
        return self.batch_idx, self.batch_mask

    def _build(self):
        optimizer_params = self.model_params.get("optimizer_params", {"name": "Adam"})
        self.optimizer_name = optimizer_params.get("name", "Adam")
        self.optimizer, self.lr_dict, self.start_dict = create_optimizer(
            optimizer_params, self.model_params.get("update_params"), self.params,
            grad_accumulation=self.grad_accumulation)
        load_state = optimizer_params.get("load_state")
        if load_state:
            if not str(load_state).endswith((".hdf5", ".h5")):
                raise NotImplementedError(
                    f"optimizer_params.load_state='{load_state}': ptyrad_tpu_torch resumes the "
                    "optimizer from a model.hdf5 (saved with 'optim_state' in save_result); an "
                    "orbax optimizer directory is the JAX package's own format")
            try:
                load_opt_state_hdf5(self.optimizer, str(load_state))
                vprint(f"Restored optimizer state from '{load_state}'", verbose=self.verbose)
            except OptStateMismatchError:
                raise  # a fresh state here would pass for the resume asked for
            except (OSError, KeyError, ValueError) as e:
                vprint(f"WARNING: failed to restore optimizer state from '{load_state}': {e}. "
                       "Using fresh state.")
        if is_lbfgs(self.optimizer_name):
            self.lbfgs_objective = build_lbfgs_objective(
                self.params, self.buffers, self.geom, self.loss_params, self.start_dict)
        else:
            self.train_epoch = build_train_epoch(
                self.params, self.buffers, self.geom, self.loss_params, self.optimizer,
                self.start_dict)

    def _lbfgs_loop(self, n_iter: int, callback: Optional[Callable] = None,
                    start_niter: int = 1, permute: bool = False):
        """LBFGS iterations (ptyrad_tpu/engine/solver.py _lbfgs_loop): one
        optimizer step an iteration on the mean loss over all batches in
        their planned order (``permute``: in iter_batch_perm's order of the
        iteration, as the JAX package's hypertune trial passes them), then
        the due constraints; the history records the objective at the start
        of each step (``LBFGS Loss``), the line search's steps and the
        objective's evaluations. callback as for recon_loop."""
        history = self.history
        idx_all = torch.as_tensor(self.batch_idx, device=self.device)
        mask_all = torch.as_tensor(self.batch_mask, device=self.device)
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
            self.constraint_fn(self.params, self.buffers, niter)
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
