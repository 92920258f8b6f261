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

``recon_params.shard_measurements`` (the store split over devices) and
hypertune on more than one rank are ROADMAP item A6b: the store is
replicated on every rank. Canvas sharding (``recon_params.shard_canvas``,
parallel/canvas.py) splits the object and the store into row slabs instead;
it gathers whole canvases with ``all_gather_rows`` and all-reduces only the
replicated tensors' gradients.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

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


def shard_model(params, buffers, group: Optional[DataGroup], shard_measurements: bool = True,
                verbose: bool = True):
    """Place the model on the ranks (ptyrad_tpu/parallel/mesh.py:108-158):
    every parameter and every buffer but the measurement store takes rank
    0's values, so a rank whose Initializer drew another random object or
    position jitter cannot drift. The store is built identically on every
    rank, as the JAX package assumes, and stays replicated:
    ``shard_measurements`` (the JAX package's split of the store over
    devices) is ROADMAP item A6b, and rank 0 says so once. Returns (params,
    buffers)."""
    if group is None:
        return params, buffers
    tensors = [t for _, t in params.named()]
    tensors += [getattr(buffers, f.name) for f in dataclasses.fields(buffers)
                if f.name != "measurements" and getattr(buffers, f.name) is not None]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(_real_view(t), src=0)
    if shard_measurements and verbose and group.is_main:
        from ptyrad_tpu_torch.utils.logging import vprint

        vprint(f"recon_params.shard_measurements: the measurement store is replicated on each "
               f"of the {group.size} ranks (splitting it is ROADMAP item A6b)")
    return params, buffers
