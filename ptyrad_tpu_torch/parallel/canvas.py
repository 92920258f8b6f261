"""Canvas sharding over ranks (counterpart of ptyrad_tpu/parallel/canvas.py).

``recon_params.shard_canvas`` on more than one rank splits the object
canvases obja/objp into row slabs, one per rank, padded to ``noy_pad =
rows_local * n`` rows (obja 1, objp 0: no patch reads a padding row, and
they receive zero gradient). Each scan position belongs to the slab that
holds its patch's top row (``plan_canvas_sharding``), so a patch reads its
own slab plus at most ``halo`` (the probe height) rows of the next one.
Each step ``halo_extend`` appends the next rank's top ``halo`` rows to the
rank's slab (an all_gather of every rank's top rows, of which the rank takes
the next one's; the last rank appends zeros, which no patch reads); its
backward sends the halo rows' cotangent back and adds it to the owner's top
rows. B1 gathers the patches from the extended slab at corners rebased to
the slab's first row, B2 scatters their gradients into it; a padding slot's
corner may lie on another slab and clamps, its mask is 0.

The measurements are stored slab-major (``CanvasShard.store``): a rank holds
``cap = b_local`` rows, the positions of its slab, and every iteration
shuffles each slab's positions with the JAX package's seed (1000003 niter
+ 7, ``canvas_iteration_batches``), so every rank builds the same order.
Each rank keeps only its slab of obja/objp and of the optimizer's
canvas-shaped state; the probe, the position shifts, the tilts and the
slice thickness are replicated, and only their gradients are all-reduced.

The loss is the port's own ``engine.solver.loss_fn`` with ``group`` on a
local view (``CanvasShard.loss``): a PtychoParams whose obja/objp are the
halo-extended slabs and whose shifts and tilts are gathered in store order,
and a Buffers whose crop_pos and measurements are the rank's store. It
reduces every term's batch sums over the ranks, so it takes the route the
replicated path takes: B3a/B3b where ``fused_loss_terms`` accepts (one
object mode), B4a/B4b through forward() where it declines, B5/B6 at N = 256
or 512. The JAX canvas loss always forms dp (``_dispatch_dp``, :87) and
folds the terms by hand (:404-512); the fused B3 gives the same loss up to
the order of float32 sums.

Constraints, saves and checkpoints see whole, unpadded canvases
(``whole_params``, ``constrain``, ``gather_state``/``cut_state``): a
checkpoint written here resumes the replicated path or another rank count,
and the other way round. Rules that reduce over a whole tensor take that
reduction over the ranks' real rows: LBFGS's inner products
(optim_lbfgs.vdot) and Adafactor's factored moments and block RMS
(optim.AdafactorRule); Muon's Newton-Schulz only acts on the 2-D shifts and
tilts, which are replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ptyrad_tpu_torch.models.state import Buffers, PtychoParams, _measurements
from ptyrad_tpu_torch.optim import optim_state_values
from ptyrad_tpu_torch.parallel.mesh import DataGroup, all_gather_rows
from ptyrad_tpu_torch.utils.logging import vprint

CANVAS_NAMES = ("obja", "objp")
PAD_VALUE = {"obja": 1.0, "objp": 0.0}
REPLICATED_NAMES = ("probe", "probe_pos_shifts", "obj_tilts", "slice_thickness")


@dataclasses.dataclass(frozen=True)
class CanvasPlan:
    """The split of one (scan, canvas, rank count) into slabs."""

    n_dev: int
    rows_local: int        # canvas rows per rank (after padding)
    noy_pad: int           # rows_local * n_dev >= Noy
    halo: int              # rows borrowed from the next slab (= probe Ny)
    b_local: int           # scan positions per rank (the busiest slab's count)
    pos_index: np.ndarray  # (n_dev * b_local,) global position id of each slot
    mask: np.ndarray       # (n_dev * b_local,) float32: 1 a real slot, 0 padding


def _slab_of(crop_pos: np.ndarray, rows_local: int, n_dev: int) -> np.ndarray:
    """The slab owning each position: the slab of its patch's top row."""
    return np.minimum(crop_pos[:, 0] // rows_local, n_dev - 1)


def plan_canvas_sharding(crop_pos: np.ndarray, noy: int, probe_ny: int,
                         n_dev: int) -> CanvasPlan:
    """Assign each position to the slab of its patch's top row and pad every
    slab's slots with position 0, mask 0, to the busiest slab's count
    (ptyrad_tpu/parallel/canvas.py:166-205). Raises when a patch could span
    more than two slabs (the probe taller than a slab)."""
    crop_pos = np.asarray(crop_pos)
    rows_local = -(-int(noy) // n_dev)
    halo = int(probe_ny)
    if halo > rows_local:
        raise ValueError(
            f"canvas sharding: probe height {halo} exceeds the {rows_local}-row "
            f"slab — patches would span >2 slabs; use fewer devices (<= {noy // probe_ny})"
        )
    slab = _slab_of(crop_pos, rows_local, n_dev)
    counts = np.bincount(slab, minlength=n_dev)
    b_local = int(counts.max())
    if b_local == 0:
        raise ValueError("canvas sharding: no scan positions")
    pos_index = np.zeros((n_dev, b_local), np.int64)
    mask = np.zeros((n_dev, b_local), np.float32)
    for d in range(n_dev):
        mine = np.nonzero(slab == d)[0]
        pos_index[d, :len(mine)] = mine
        mask[d, :len(mine)] = 1.0
    return CanvasPlan(n_dev=n_dev, rows_local=rows_local, noy_pad=rows_local * n_dev,
                      halo=halo, b_local=b_local, pos_index=pos_index.ravel(),
                      mask=mask.ravel())


def plan_canvas(crop_pos: np.ndarray, indices, noy: int, probe_ny: int,
                n_dev: int) -> CanvasPlan:
    """plan_canvas_sharding of the positions ``indices`` (INDICES_MODE's
    subset), its slots holding global position ids, as the JAX solver's
    _build_canvas remaps them (ptyrad_tpu/engine/solver.py:640-646)."""
    idx = np.asarray(indices)
    plan = plan_canvas_sharding(np.asarray(crop_pos)[idx], noy, probe_ny, n_dev)
    return dataclasses.replace(plan, pos_index=idx[plan.pos_index])


def slab_local_positions(crop_pos, pos_index, rows_local: int, n_dev: int,
                         b_local: int) -> np.ndarray:
    """crop_pos in slot order with each row rebased to its slab's first row
    (ptyrad_tpu/parallel/canvas.py:236-247); leading axes of pos_index
    broadcast."""
    pos = np.asarray(crop_pos)[np.asarray(pos_index)].astype(np.int32)
    first = (np.arange(n_dev, dtype=np.int32) * rows_local).repeat(b_local)
    pos[..., 0] -= first
    return pos


def canvas_iteration_batches(plan: CanvasPlan, n_batches: int, niter: int):
    """Iteration niter's minibatches over the slab-major store
    (ptyrad_tpu/parallel/canvas.py:729-763): each slab's real slots shuffled
    with the iteration's seed and split in n_batches, padded with the
    slab's slot 0 at mask 0. Returns (slots (n_batches, n_dev * b) int32
    global store slots, mask, n_valid (n_batches,))."""
    n_dev, cap = plan.n_dev, plan.b_local
    rng = np.random.default_rng(1000003 * niter + 7)
    valid = plan.mask.reshape(n_dev, cap)
    parts = {}
    b_local = 1
    for d in range(n_dev):
        slots = np.nonzero(valid[d])[0] + d * cap
        slots = rng.permutation(slots)
        for b, part in enumerate(np.array_split(slots, n_batches)):
            parts[(b, d)] = part
            b_local = max(b_local, len(part))
    slots_arr = np.zeros((n_batches, n_dev, b_local), np.int32)
    mask = np.zeros((n_batches, n_dev, b_local), np.float32)
    for d in range(n_dev):
        slots_arr[:, d, :] = d * cap
    for (b, d), part in parts.items():
        slots_arr[b, d, :len(part)] = part
        mask[b, d, :len(part)] = 1.0
    nval = mask.reshape(n_batches, -1).sum(axis=1).astype(np.float32)
    if nval.min() == 0:
        raise ValueError(
            f"canvas batching: iteration batch {int(nval.argmin())} has no "
            f"scan positions — use n_batches <= {int(valid.sum(1).max())}")
    return slots_arr.reshape(n_batches, -1), mask.reshape(n_batches, -1), nval


def global_batches(plan: CanvasPlan, n_batches: int, niter: int):
    """Iteration niter's canvas minibatches as global position ids and masks,
    (n_batches, n_dev * b) each: the batches of a replicated run that does
    what the ranks do together (the reference of the canvas path's tests)."""
    slots, mask, _ = canvas_iteration_batches(plan, n_batches, niter)
    return plan.pos_index[slots], mask


def canvas_batch_count(plan: CanvasPlan, n_positions: int, batch_size: int, verbose=True):
    """The number of minibatches of an iteration: the positions over
    batch_size, capped at the busiest slab's count so that every batch holds
    a position (ptyrad_tpu/engine/solver.py:723-733)."""
    n_batches = max(1, -(-n_positions // batch_size))
    busiest = int(plan.mask.reshape(plan.n_dev, -1).sum(axis=1).max())
    if n_batches > busiest:
        vprint(f"WARNING: shard_canvas caps the batch count at {busiest} (busiest slab) — "
               f"BATCH_SIZE.size {batch_size} asked for {n_batches} batches", verbose=verbose)
        n_batches = busiest
    return n_batches


# -- the halo exchange -------------------------------------------------------

def _all_gather(x: torch.Tensor, group: DataGroup) -> list:
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x.contiguous())
    return parts


class _HaloExchange(torch.autograd.Function):
    """(obja, objp) slabs -> the slabs with the next rank's top ``halo`` rows
    appended (zeros on the last rank), in one all_gather; the backward
    sends each rank's halo cotangent to its owner, the next rank, which adds
    it to its top rows (the ppermute and its transpose,
    ptyrad_tpu/parallel/canvas.py:341-348)."""

    @staticmethod
    def forward(ctx, obja, objp, halo: int, group: DataGroup):
        ctx.halo, ctx.group, ctx.rows = halo, group, obja.shape[-2]
        parts = _all_gather(torch.stack([obja[..., :halo, :], objp[..., :halo, :]]), group)
        nxt = (parts[group.rank + 1] if group.rank + 1 < group.size
               else torch.zeros_like(parts[0]))
        return torch.cat([obja, nxt[0]], dim=-2), torch.cat([objp, nxt[1]], dim=-2)

    @staticmethod
    def backward(ctx, ga, gp):
        rows, halo, group = ctx.rows, ctx.halo, ctx.group
        parts = _all_gather(torch.stack([ga[..., rows:, :], gp[..., rows:, :]]), group)
        da, dp = ga[..., :rows, :].clone(), gp[..., :rows, :].clone()
        if group.rank > 0:
            back = parts[group.rank - 1]
            da[..., :halo, :] += back[0]
            dp[..., :halo, :] += back[1]
        return da, dp, None, None


def halo_extend(obja: torch.Tensor, objp: torch.Tensor, halo: int,
                group: DataGroup) -> tuple:
    """The rank's (omode, Nz, rows_local, Nox) slabs extended by the next
    rank's top ``halo`` rows, differentiable through the exchange."""
    return _HaloExchange.apply(obja, objp, halo, group)


# -- one rank's share ----------------------------------------------------------

def _bits(a: np.ndarray) -> np.ndarray:
    """A host state array as torch takes it: bfloat16's bits (the opaque
    2-byte type of optim.bf16_bits) as int16, which rows are moved and
    padded in (zero bits are bfloat16's 0); any other array as it is."""
    return a.view(np.int16) if a.dtype.kind == "V" else a


def slab_rows(whole: torch.Tensor, plan: CanvasPlan, rank: int, value: float) -> torch.Tensor:
    """The rank's rows of a (..., Noy, Nox) canvas padded to noy_pad rows
    with ``value``, as a new tensor."""
    noy, lo = whole.shape[-2], rank * plan.rows_local
    out = torch.full(whole.shape[:-2] + (plan.rows_local, whole.shape[-1]), value,
                     dtype=whole.dtype, device=whole.device)
    real = max(0, min(plan.rows_local, noy - lo))
    out[..., :real, :] = whole[..., lo:lo + real, :]
    return out


@dataclasses.dataclass
class CanvasStore:
    """The rank's slab-major measurement store (ptyrad_tpu/parallel/canvas.py:
    671-726): its plan.b_local slots, on the rank's device."""

    measurements: torch.Tensor  # (cap, Ky, Kx) in the store's type
    crop_pos: torch.Tensor      # (cap, 2) int32 corners, rows rebased to the slab
    gid: torch.Tensor           # (cap,) int64 global position ids


class CanvasShard:
    """A rank's share of a canvas-sharded run: the slab parameters (obja and
    objp the rank's padded slabs, the other four tensors the run's
    replicated ones), the slab store, the local Buffers view and the
    reductions and gathers over the ranks.

    params: the whole model's PtychoParams (equal on every rank, e.g. after
    shard_model); buffers: its Buffers, whose measurements may stay on the
    host (only the slab's rows are read); meas_dtype: the store's type.
    An optimizer rule that reduces over a whole tensor (Adafactor, LBFGS)
    takes the shard as its ``slab`` (create_optimizer(slab=)) and reduces
    its ``canvas_names`` tensors over the ranks. ``slice``, ``loss`` and
    ``replicated_tensors`` are engine.solver.RankBatches' methods, the
    rank's share of each batch for build_train_epoch.
    """

    canvas_names = CANVAS_NAMES

    def __init__(self, params: PtychoParams, buffers: Buffers, geom, plan: CanvasPlan,
                 group: DataGroup, meas_dtype: str = "float32"):
        self.plan, self.group, self.geom = plan, group, geom
        self.rank = group.rank
        self.noy = int(params.obja.shape[-2])
        self.nox = int(params.obja.shape[-1])
        self.valid_rows = max(0, min(plan.rows_local, self.noy - self.rank * plan.rows_local))
        with torch.no_grad():
            slabs = {name: slab_rows(getattr(params, name).detach(), plan, self.rank,
                                     PAD_VALUE[name]) for name in CANVAS_NAMES}
        self.params = dataclasses.replace(params, **slabs)
        self.slab_shape = tuple(self.params.obja.shape)
        self.whole_shape = tuple(params.obja.shape)
        self.store = self._build_store(buffers, meas_dtype)
        self.buffers = dataclasses.replace(buffers, measurements=self.store.measurements,
                                           crop_pos=self.store.crop_pos)

    def _build_store(self, buffers: Buffers, meas_dtype: str) -> CanvasStore:
        plan, cap = self.plan, self.plan.b_local
        cut = slice(self.rank * cap, (self.rank + 1) * cap)
        ids = plan.pos_index[cut]
        crop_pos = buffers.crop_pos.cpu().numpy()
        pos = slab_local_positions(crop_pos, plan.pos_index, plan.rows_local, plan.n_dev,
                                   cap)[cut]
        meas = buffers.measurements
        rows = meas[torch.as_tensor(ids, device=meas.device)]
        dev = buffers.crop_pos.device
        return CanvasStore(measurements=_measurements(rows, dev, meas_dtype),
                           crop_pos=torch.as_tensor(pos, device=dev),
                           gid=torch.as_tensor(ids, device=dev))

    # -- the loss on the rank's slab --
    def replicated_tensors(self) -> list:
        """The tensors whose gradients are summed over the ranks."""
        return [getattr(self.params, name) for name in REPLICATED_NAMES]

    def view(self) -> PtychoParams:
        """The local view the loss runs on: the halo-extended slabs, and the
        shifts and per-position tilts gathered in store order (their
        gradients scatter back; a padding slot's is zero)."""
        p, geom = self.params, self.geom
        ext_a, ext_p = halo_extend(p.obja, p.objp, self.plan.halo, self.group)
        shifts = p.probe_pos_shifts[self.store.gid] if geom.shift_probes else p.probe_pos_shifts
        tilts = p.obj_tilts if geom.global_tilt else p.obj_tilts[self.store.gid]
        return dataclasses.replace(p, obja=ext_a, objp=ext_p, probe_pos_shifts=shifts,
                                   obj_tilts=tilts)

    def loss(self, slots: torch.Tensor, mask: torch.Tensor, loss_params, plan=None):
        """(total, terms) of a batch, whole-batch terms on every rank: slots
        and mask are the rank's store slots of the batch (``plan`` is
        RankBatches'; the slab store needs no exchange)."""
        from ptyrad_tpu_torch.engine.solver import loss_fn

        return loss_fn(self.view(), self.buffers, self.geom, slots, mask, loss_params,
                       self.group)

    def slice(self, idx_all: torch.Tensor, mask_all: torch.Tensor) -> tuple:
        """The rank's part of each batch (engine.solver.build_train_epoch):
        its store slots, as the canvas loop passes them, and no exchange."""
        return idx_all, mask_all, [None] * idx_all.shape[0]

    def local_batches(self, n_batches: int, niter: int):
        """The rank's block of canvas_iteration_batches as its own store slots
        and masks, (n_batches, b) each."""
        slots, mask, _ = canvas_iteration_batches(self.plan, n_batches, niter)
        per = slots.shape[1] // self.plan.n_dev
        cut = slice(self.rank * per, (self.rank + 1) * per)
        return slots[:, cut] - self.rank * self.plan.b_local, mask[:, cut]

    # -- reductions over the slabs (optim.AdafactorRule, optim_lbfgs.vdot) --
    def rows(self, x: torch.Tensor, axis: int = -2) -> torch.Tensor:
        """x without the padding rows of its rows axis."""
        return x.narrow(axis, 0, self.valid_rows)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks (no gradient)."""
        t = t.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    # -- whole canvases --
    def gather(self, slab: torch.Tensor) -> torch.Tensor:
        """The whole, unpadded canvas of a slab-shaped tensor (rows axis -2)."""
        return all_gather_rows(slab, self.group, self.noy)

    def own_rows(self, whole: torch.Tensor, value: float) -> torch.Tensor:
        """The rank's rows of a (..., Noy, Nox) canvas, padded with value."""
        return slab_rows(whole, self.plan, self.rank, value)

    def whole_params(self) -> PtychoParams:
        """Whole canvases (new tensors) beside the live replicated tensors."""
        return dataclasses.replace(self.params, **{
            name: self.gather(getattr(self.params, name)) for name in CANVAS_NAMES})

    @torch.no_grad()
    def set_whole(self, whole: PtychoParams) -> None:
        """Take the rank's rows of whole canvases into the slabs, padding rows
        reset."""
        for name in CANVAS_NAMES:
            getattr(self.params, name).copy_(self.own_rows(getattr(whole, name),
                                                           PAD_VALUE[name]))

    def constrain(self, constraint_fn) -> Callable:
        """constraint_fn(params, buffers, niter) on whole canvases
        (ptyrad_tpu/parallel/canvas.py:1014-1051): on an iteration where a
        constraint is due, gather, apply, cut; the replicated tensors are
        constrained in place, alike on every rank."""
        def apply(params, buffers, niter):
            if not constraint_fn.due(niter):
                return params
            whole = self.whole_params()
            constraint_fn(whole, buffers, niter)
            self.set_whole(whole)
            return params
        return apply

    def _walk(self, values, fn):
        if isinstance(values, dict):
            return {k: self._walk(v, fn) for k, v in values.items()}
        return fn(values) if isinstance(values, np.ndarray) else values

    def gather_state(self, values):
        """An optimizer state (optim.optim_state_values' dict of host arrays)
        with each slab-shaped array, trailing dims (omode, Nz, rows_local,
        Nox), gathered whole and unpadded: the layout the replicated path
        writes (ptyrad_tpu/parallel/canvas.py:958-987), in its own dtype.
        Every rank calls it."""
        dev = self.params.obja.device

        def fix(a):
            if a.shape[-4:] != self.slab_shape:
                return a
            whole = self.gather(torch.as_tensor(_bits(a), device=dev)).cpu().numpy()
            return whole.view(a.dtype)
        return self._walk(values, fix)

    def cut_state(self, values):
        """The inverse of gather_state for a checkpoint's state: each array
        with the whole canvas's trailing dims zero-padded and cut to the
        rank's rows (padding rows take no gradient, so zero moments are the
        exact resume; ptyrad_tpu/parallel/canvas.py:990-1011), in its own
        dtype."""
        def fix(a):
            if a.shape[-4:] != self.whole_shape:
                return a
            whole = torch.from_numpy(np.ascontiguousarray(_bits(a)))
            return self.own_rows(whole, 0).numpy().view(a.dtype)
        return self._walk(values, fix)

    def wrap_callback(self, callback: Optional[Callable], optimizer, save_optim: bool):
        """The callback the loop calls: it hands ``callback`` whole canvases
        (and, if it declares ``optimizer``, the gathered state when the run
        saves it), on every iteration, or only on multiples of its
        ``canvas_save_iters`` attribute when it has one (None: never;
        ptyrad_tpu/engine/solver.py:784-797). A callback whose
        ``canvas_slabs`` attribute is true is called every iteration with the
        loop's own arguments, the rank's slabs, and gathers what it needs
        itself (a hypertune trial's)."""
        if callback is None or getattr(callback, "canvas_slabs", False):
            return callback
        import inspect

        unset = object()
        gate = getattr(callback, "canvas_save_iters", unset)
        takes_optimizer = "optimizer" in inspect.signature(callback).parameters

        def wrapped(niter, params, history):
            if gate is not unset and not (gate and niter % gate == 0):
                return
            whole = self.whole_params()
            if not takes_optimizer:
                callback(niter, whole, history)
                return
            callback(niter, whole, history, optimizer=(
                self.gather_state(optim_state_values(optimizer)) if save_optim else optimizer))
        return wrapped
