"""Reconstruction engine: train epoch, iteration loop, solver facade.

Counterpart of ptyrad_tpu/engine/solver.py for the single-device Adam path.
Each iteration is a Python loop over the padded mini-batches: the loss
(``fused_loss_terms`` when in regime, else ``forward`` + ``combined_loss``),
backward, start-iter gating of the gradients, the Adam step; then the due
constraints. The per-batch loss terms stay on the device and reach the host
once per iteration.

Not in this slice: device meshes, LBFGS, canvas sharding and saving
(ROADMAP queue A).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ptyrad_tpu_torch.constraints import ConstraintScheduler
from ptyrad_tpu_torch.device import resolve_device
from ptyrad_tpu_torch.engine.batching import make_batches, pad_batches, select_scan_indices
from ptyrad_tpu_torch.losses import combined_loss
from ptyrad_tpu_torch.models.forward import forward, fused_loss_terms, get_measurements
from ptyrad_tpu_torch.models.state import Buffers, Geometry, PtychoParams, make_model
from ptyrad_tpu_torch.optim import create_optimizer, mask_unstarted_grads
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
    device; params are updated in place.
    """

    def train_epoch(idx_all: torch.Tensor, mask_all: torch.Tensor, niter: int):
        totals, term_rows = [], []
        for b in range(idx_all.shape[0]):
            optimizer.zero_grad(set_to_none=True)
            total, terms = loss_fn(params, buffers, geom, idx_all[b], mask_all[b], loss_params)
            total.backward()
            mask_unstarted_grads(params, niter, start_iters)
            optimizer.step()
            totals.append(total.detach())
            term_rows.append(torch.stack([t.detach() for t in terms.values()]))
        names = list(terms.keys())
        table = torch.stack(term_rows).cpu().numpy()  # the one device->host copy
        batch_terms = {k: table[:, i].tolist() for i, k in enumerate(names)}
        return float(torch.stack(totals).mean()), batch_terms

    return train_epoch


@dataclass
class ReconHistory:
    """Per-iteration records."""

    loss_iters: List[tuple] = field(default_factory=list)
    iter_times: List[float] = field(default_factory=list)
    dz_iters: List[tuple] = field(default_factory=list)
    avg_tilt_iters: List[tuple] = field(default_factory=list)
    term_iters: List[dict] = field(default_factory=list)
    batch_terms: Dict[str, list] = field(default_factory=dict)


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
               verbose: bool = True):
    """NITER outer loop. callback(niter, params, history) fires after each
    iteration. Halts on a non-finite loss."""
    history = history or ReconHistory()
    device = params.obja.device
    batch_idx = np.asarray(batch_idx)
    batch_mask = np.asarray(batch_mask)
    for niter in range(1, n_iter + 1):
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
        history.dz_iters.append((niter, float(params.slice_thickness)))
        history.avg_tilt_iters.append((niter, params.obj_tilts.detach().cpu().numpy().mean(0)))

        term_str = ", ".join(f"{k}: {v:.4f}" for k, v in term_avgs.items())
        vprint(f"Iter: {niter}, Total Loss: {total:.4f}, {term_str}, in {iter_t:.3f} sec",
               verbose=verbose)
        if callback is not None:
            callback(niter, params, history)
    return params, history


class PtyRADSolver:
    """Reconstruction facade (counterpart of ptyrad_tpu.engine.solver.PtyRADSolver).

    params: dict with model_params, loss_params, constraint_params and
    recon_params sections. init_variables: the prebuilt init dict (the
    Initializer is not ported yet). device: None means "cuda"; pass "cpu" to
    run the plain PyTorch path on the CPU.
    """

    def __init__(self, params: Optional[dict] = None, init_variables: Optional[dict] = None,
                 device=None, verbose: bool = True):
        self.device = resolve_device(device)
        self.params_dict = params or {}
        self.verbose = verbose
        if init_variables is None:
            raise NotImplementedError(
                "the Initializer is not ported yet (ROADMAP queue A): pass init_variables")
        self.model_params = self.params_dict.get("model_params", {}) or {}
        self.params, self.buffers, self.geom = make_model(
            init_variables, self.model_params, self.device)
        self.recon_params = self.params_dict.get("recon_params", {}) or {}
        self.loss_params = self.params_dict.get("loss_params")
        self.constraint_fn = ConstraintScheduler(self.params_dict.get("constraint_params"))
        self.history = ReconHistory()
        self.batch_idx = None
        self.train_epoch = None

    def prepare(self):
        rp = self.recon_params
        im = rp.get("INDICES_MODE", {}) or {}
        indices = select_scan_indices(
            self.geom.n_scan_slow, self.geom.n_scan_fast,
            im.get("subscan_slow"), im.get("subscan_fast"), mode=im.get("mode", "full"),
        )
        batch_size = int((rp.get("BATCH_SIZE", {}) or {}).get("size", 32))
        if int((rp.get("BATCH_SIZE", {}) or {}).get("grad_accumulation", 1)) != 1:
            raise NotImplementedError("grad_accumulation waits for ROADMAP queue A")
        pos = self.buffers.crop_pos.cpu().numpy()
        batches = make_batches(indices, pos, batch_size, mode=rp.get("GROUP_MODE", "random"),
                               seed=rp.get("GROUP_MODE_SEED"))
        self.batch_idx, self.batch_mask = pad_batches(batches)
        return self.batch_idx, self.batch_mask

    def _build(self):
        optimizer_params = self.model_params.get("optimizer_params", {"name": "Adam"})
        self.optimizer_name = optimizer_params.get("name", "Adam")
        self.optimizer, self.lr_dict, self.start_dict = create_optimizer(
            optimizer_params, self.model_params.get("update_params"), self.params)
        self.train_epoch = build_train_epoch(
            self.params, self.buffers, self.geom, self.loss_params, self.optimizer,
            self.start_dict)

    def reconstruct(self, callback: Optional[Callable] = None):
        n_iter = int(self.recon_params.get("NITER", 100))
        if self.batch_idx is None:
            self.prepare()
        if self.train_epoch is None:
            self._build()
        vprint(
            f"Starting reconstruction: {n_iter} iters, "
            f"{self.batch_idx.shape[0]} batches of {self.batch_idx.shape[1]}, "
            f"optimizer={self.optimizer_name}, device={self.device}",
            verbose=self.verbose,
        )
        self.params, self.history = recon_loop(
            self.train_epoch, self.params, self.batch_idx, self.batch_mask, n_iter,
            self.constraint_fn, self.buffers, history=self.history, callback=callback,
            verbose=self.verbose,
        )
        return self.params, self.history

    def run(self, callback: Optional[Callable] = None):
        """Entry point: reconstruct and report the wall time."""
        t0 = time.perf_counter()
        result = self.reconstruct(callback=callback)
        vprint(f"Reconstruction finished in {time.perf_counter() - t0:.1f} sec",
               verbose=self.verbose)
        return result
