"""Data parallelism over ranks (counterpart of ptyrad_tpu/parallel/mesh.py).

In PyTorch's idiom: one process per rank and one device per process, joined
by ``torch.distributed`` (NCCL between GPUs, gloo on the CPU), as DDP runs
the reference. There is no single-process mesh over several devices. A
``DataGroup`` holds the world size, the rank and the rank's device; ``None``
in its place means one process, and every function below is then the
identity or a plain local computation.

Each rank holds the whole model, replicated (``shard_model`` broadcasts
rank 0's parameters), and takes its contiguous block of every padded batch
(``rank_slice``: the JAX package's ``P("data")`` split of the batch axis).
The kernels B1-B6 run unchanged on the rank's block and see nothing of the
other ranks, so ``put_global`` (ptyrad_tpu/parallel/mesh.py:60) and the
kernels' mesh (ptyrad_tpu/ops/mesh_env.py) have no counterpart. What XLA
reduces across the mesh is reduced here by two collectives:

- inside the loss, ``all_reduce_sum`` over the batch sums before any sqrt,
  power or division (losses.py, models/forward.py:fused_loss_terms): the
  counterpart of the fused loss kernel's psum of s1 and s2
  (ptyrad_tpu/ops/pallas_multislice.py:679-680) and of the psums that
  GSPMD inserts into the XLA loss. Its backward is the identity, so each
  rank's backward gives the gradient of the global loss through its own
  samples;
- after backward, ``all_reduce_grads`` sums every parameter's gradient in
  one flat buffer: the counterpart of B2's per-shard scatter and canvas
  psum (ptyrad_tpu/ops/patches.py:322 ``_shard_scatter``) and of the
  kernels' psums of the shared probe and H cotangents
  (ptyrad_tpu/ops/pallas_multislice.py:491-499, :774-780;
  ptyrad_tpu/ops/pallas_chain.py:960-961, :1134-1135).

``recon_params.shard_measurements`` (the default) splits the measurement
store over the ranks (ptyrad_tpu/parallel/mesh.py:108-158): rank r keeps
rows [r M/n, (r+1) M/n) of the store zero-padded to M = n ceil(N/n) rows
on its device (``StoreSplit``, ``shard_model``). Where XLA gathers any
index pattern across the shards, the port exchanges rows explicitly, once
per batch and without a request round: every rank holds the same padded
batch, so each works out which of its rows every other rank's
``rank_slice`` needs (``exchange_plan``) and one ``all_to_all_single``
with per-rank split sizes hands each rank its slice's rows in slice order,
in the store's type (``exchange_rows``). Canvas sharding
(``recon_params.shard_canvas``, parallel/canvas.py) splits the object and
the store into row slabs instead; it gathers whole canvases with
``all_gather_rows`` and all-reduces only the replicated tensors' gradients.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ranks of a data-parallel run: this process's rank, the world
    size and this rank's device (the default process group)."""

    rank: int
    size: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> str:
        return str(dist.get_backend())


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without torch.distributed)."""
    return dist.get_rank() if _joined() else 0


def world_size() -> int:
    """The number of ranks (1 without torch.distributed)."""
    return dist.get_world_size() if _joined() else 1


def is_main_process() -> bool:
    """True in a run of one process and on rank 0 of a distributed run."""
    return process_index() == 0


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None, process_id: Optional[int] = None,
                   backend: Optional[str] = None, device_type: str = "cuda") -> DataGroup:
    """Join a distributed run (the launch-side counterpart of
    ptyrad_tpu/parallel/mesh.py:161 and the reference's accelerate launch).

    With ``coordinator_address`` ('host:port'), ``num_processes`` and
    ``process_id`` the group meets at ``tcp://host:port``; with none of
    them it reads torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT). ``backend`` None is NCCL for ``device_type`` cuda and
    gloo for cpu. The rank's device is ``cuda:{LOCAL_RANK or rank %
    device_count}`` (ranks beyond the card count share cards), or the CPU.
    Returns the group."""
    given = [v is not None for v in (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError("init_multihost: give coordinator_address, num_processes and "
                         "process_id together, or none of them (torchrun's environment)")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"init_multihost: device_type {device_type!r}; use 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_multihost: CUDA is not available; pass device_type='cpu' "
                           "(gloo on the CPU)")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if all(given):
        rank, local = int(process_id), int(process_id)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=rank)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise ValueError(
                f"init_multihost: no coordinator_address, num_processes and process_id, and "
                f"torchrun's environment lacks {', '.join(missing)}: pass the three (the CLI's "
                "--coordinator_address, --num_processes, --process_id) or launch with torchrun")
        dist.init_process_group(backend, init_method="env://")
        rank = dist.get_rank()
        local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cpu")
    if device_type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return DataGroup(rank=rank, size=dist.get_world_size(), device=device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward is the identity: each rank's cotangent
    flows into its own local term, and all_reduce_grads then sums the
    parameter gradients once. (torch.distributed.nn's all_reduce also
    all-reduces the cotangent, which would count every term world-size
    times after the gradient all-reduce.)"""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


def all_reduce_sum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """x summed over the group's ranks (x itself for group None); the
    gradient passes through unchanged."""
    return x if group is None else _AllReduceSum.apply(x)


def _real_view(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce_grads(tensors, group: Optional[DataGroup]) -> int:
    """Sum the ``.grad`` of every tensor that has one over the ranks, in one
    flat float32 buffer (complex gradients as their real pairs), in place.
    Every rank runs the same code on the same tensors, so all hold a
    gradient for the same ones. Returns the bytes all-reduced (0 for group
    None)."""
    if group is None:
        return 0
    grads = [_real_view(t.grad) for t in tensors if t.grad is not None]
    if not grads:
        return 0
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    return flat.numel() * flat.element_size()


def all_gather_rows(slab: torch.Tensor, group: Optional[DataGroup],
                    rows: Optional[int] = None) -> torch.Tensor:
    """Every rank's slab, of one shape on every rank, stacked along axis -2
    in rank order (the rows of a canvas split in row slabs) and cut to its
    first ``rows`` rows; the slab itself (cut) for group None. Not
    differentiable."""
    if group is None:
        return slab if rows is None else slab[..., :rows, :]
    slab = slab.detach().contiguous()
    parts = [torch.empty_like(slab) for _ in range(group.size)]
    dist.all_gather(parts, slab)
    whole = torch.cat(parts, dim=-2)
    return whole if rows is None else whole[..., :rows, :]


def rank_slice(idx: torch.Tensor, mask: torch.Tensor, group: Optional[DataGroup]):
    """The rank's contiguous block [r L/n, (r+1) L/n) of the last (batch)
    axis of idx and mask, whose length L is a multiple of the world size n
    (pad_batches(multiple_of=n)); both unchanged for group None."""
    if group is None:
        return idx, mask
    length = idx.shape[-1]
    if length % group.size:
        raise ValueError(f"a batch of {length} does not split over {group.size} ranks; pad "
                         f"it with pad_batches(multiple_of={group.size})")
    per = length // group.size
    cut = slice(group.rank * per, (group.rank + 1) * per)
    return idx[..., cut], mask[..., cut]


def broadcast_str(s: str, group: Optional[DataGroup], max_len: int = 512) -> str:
    """Rank 0's string on every rank (s itself for group None), carried as
    a uint8 tensor on the group's device: names that ranks compose a clock
    tick apart (a prefix_time output folder) must agree."""
    if group is None:
        return s
    raw = s.encode()
    if len(raw) > max_len:
        raise ValueError(
            f"broadcast_str: {len(raw)}-byte string exceeds max_len={max_len}; shorten the "
            "output folder name (recon_dir_affixes) or raise max_len")
    buf = torch.zeros(max_len, dtype=torch.uint8)
    buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(group.device)
    dist.broadcast(buf, src=0)
    return buf.cpu().numpy().tobytes().rstrip(b"\x00").decode()


def broadcast_object(obj, group: Optional[DataGroup]):
    """Rank 0's picklable object on every rank (obj itself for group None):
    a hypertune trial's sampled values, the pruner's decision."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass(frozen=True)
class StoreSplit:
    """The measurement store split over ranks (shard_measurements): the
    rank's device store holds ``rows`` rows, global rows [first, first +
    rows) of the store zero-padded to rows x world; ``n_rows`` is the
    unpadded count."""

    rank: int
    world: int
    rows: int
    n_rows: int

    @property
    def first(self) -> int:
        return self.rank * self.rows


def store_split(n_rows: int, group: DataGroup) -> StoreSplit:
    return StoreSplit(rank=group.rank, world=group.size, rows=-(-n_rows // group.size),
                      n_rows=n_rows)


def split_store(meas, split: StoreSplit, device, meas_dtype: str = "float32") -> torch.Tensor:
    """The rank's block of the store ``meas`` (host or device, any layout
    make_model(store_on_host=True) leaves) on ``device`` in meas_dtype; the
    rows past the store's end are zeros."""
    from ptyrad_tpu_torch.models.state import _measurements

    lo, hi = split.first, min(split.first + split.rows, split.n_rows)
    block = meas[lo:max(lo, hi)]
    if not isinstance(block, torch.Tensor):
        block = torch.as_tensor(np.asarray(block, dtype=np.float32))
    pad = split.rows - block.shape[0]
    if pad:
        block = torch.cat([block, block.new_zeros((pad, *block.shape[1:]))])
    return _measurements(block, device, meas_dtype)


def store_rows(meas, idx, like: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a whole store kept on the host (the Initializer's
    measurements, a NumPy array or a tensor), in the type and on the device
    of ``like`` (a split store's block) and converted as split_store
    converts them: the rows a rank that draws a figure reads without an
    exchange."""
    from ptyrad_tpu_torch.models.state import MEAS_DTYPES, _measurements

    idx = np.asarray(idx, dtype=np.int64)
    if isinstance(meas, torch.Tensor):
        rows = meas[torch.as_tensor(idx, device=meas.device)]
    else:
        rows = torch.as_tensor(np.asarray(meas)[idx], dtype=torch.float32)
    name = next(k for k, v in MEAS_DTYPES.items() if v == like.dtype)
    return _measurements(rows, like.device, name)


@dataclasses.dataclass
class ExchangePlan:
    """One batch's row exchange for one rank (exchange_plan)."""

    send: torch.Tensor      # (k,) the rank's store rows to send, grouped by destination
    send_counts: List[int]  # rows sent to each rank
    recv_counts: List[int]  # rows received from each rank
    order: torch.Tensor     # (L/n,) the slice position of each received row


def exchange_plan(idx_batch: np.ndarray, split: StoreSplit, device) -> ExchangePlan:
    """The exchange that gives this rank the rows of its rank_slice of the
    padded batch ``idx_batch`` (global scan indices, length a multiple of
    the world size): to each rank d, this rank's rows among d's slice in
    slice order; from each rank r, the rows of its own slice that r holds.
    Padded slots and repeated indices are rows like any other."""
    idx = np.asarray(idx_batch, dtype=np.int64).reshape(-1)
    n, per = split.world, idx.shape[0] // split.world
    owner = idx // split.rows
    sends, send_counts = [], []
    for d in range(n):
        cut = slice(d * per, (d + 1) * per)
        mine = idx[cut][owner[cut] == split.rank] - split.first
        sends.append(mine)
        send_counts.append(int(mine.shape[0]))
    own = owner[split.rank * per:(split.rank + 1) * per]
    order = np.argsort(own, kind="stable")
    return ExchangePlan(send=torch.as_tensor(np.concatenate(sends), device=device),
                        send_counts=send_counts,
                        recv_counts=np.bincount(own, minlength=n).tolist(),
                        order=torch.as_tensor(order, device=device))


def exchange_rows(store: torch.Tensor, plan: ExchangePlan, group: DataGroup) -> torch.Tensor:
    """The rows of the rank's slice of a batch, (L/n, Ky, Kx) in the store's
    type and in slice order, as store[idx_batch][rank_slice] of the whole
    store: one all_to_all_single over the ranks (every rank calls it with
    its own plan of the same batch)."""
    received = store.new_empty((sum(plan.recv_counts), *store.shape[1:]))
    dist.all_to_all_single(received, store[plan.send], plan.recv_counts, plan.send_counts)
    rows = torch.empty_like(received)
    rows[plan.order] = received
    return rows


def shard_model(params, buffers, group: Optional[DataGroup], shard_measurements: bool = True,
                verbose: bool = True, meas_dtype: str = "float32"):
    """Place the model on the ranks (ptyrad_tpu/parallel/mesh.py:108-158):
    every parameter and every buffer but the measurement store takes rank
    0's values, so a rank whose Initializer drew another random object or
    position jitter cannot drift. The store is built identically on every
    rank, as the JAX package assumes. With ``shard_measurements`` each rank
    keeps its block of it on its device (split_store, in meas_dtype; the
    caller leaves the whole store where it is, make_model(store_on_host=
    True)) and ``buffers.store_split`` says which; rank 0 prints the bytes
    per rank once. Without it the store stays as make_model put it,
    replicated. Returns (params, buffers)."""
    if group is None:
        return params, buffers
    tensors = [t for _, t in params.named()]
    tensors += [getattr(buffers, f.name) for f in dataclasses.fields(buffers)
                if f.name != "measurements" and isinstance(getattr(buffers, f.name), torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(_real_view(t), src=0)
    if not shard_measurements:
        return params, buffers
    split = store_split(int(buffers.measurements.shape[0]), group)
    block = split_store(buffers.measurements, split, group.device, meas_dtype)
    if verbose and group.is_main:
        from ptyrad_tpu_torch.utils.logging import vprint

        row = block[0].numel() * block.element_size()
        vprint(f"recon_params.shard_measurements: the measurement store is split over "
               f"{group.size} ranks, {split.rows} of {split.n_rows} rows on each "
               f"({split.rows * row / 1e9:.3f} GB in {block.dtype}, against "
               f"{split.n_rows * row / 1e9:.3f} GB replicated)")
    return params, dataclasses.replace(buffers, measurements=block, store_split=split)
