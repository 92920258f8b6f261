"""Batched object-patch extraction (gather) and its scatter-add adjoint.

Counterpart of ptyrad_tpu/ops/patches.py. The forward model crops a
(Ny, Nx) probe-sized window out of the object canvas at each scan position;
under reverse-mode AD the adjoint is a scatter-add of the patch gradients
into the canvas.

On a CUDA tensor, ``gather_patches`` launches kernel B1 and
``scatter_add_patches`` kernel B2 (``csrc/patches.cu``); each launches its
kernel or raises. On a CPU tensor they run their plain PyTorch versions
(``gather_plain`` / ``scatter_add_plain``), which the tests hold against the
JAX package and ``chip_smoke.py`` holds the kernels against on the card.
Corners are clamped as the Pallas kernels clamp them: y to [0, H-Ny], x to
[0, W-Nx]. The JAX package's XLA path (``lax.dynamic_slice``) differs for a
negative corner, which it wraps; the canvas path (parallel/canvas.py) passes
one for a padding slot, whose row is rebased to a later rank's slab, and
its mask is 0.

``extract_patches`` (one canvas) and ``extract_patch_pair`` (obja and objp
at the same corners) are one autograd Function over one or two canvases:
one B1 launch forward, one B2 launch backward for the canvases that need a
gradient. A pair launch counts once in ``gather_cuda.launches`` /
``scatter_add_cuda.launches``. B2 sums each canvas element over its windows
in ascending batch order from zero, as ``scatter_add_plain`` does on the
CPU, so the two agree bit for bit; ``scatter_add_plain`` on a CUDA tensor
(``index_add_``) sums with atomics in no fixed order.
"""

from __future__ import annotations

import torch

from ptyrad_tpu_torch.ops import _build


def _clamped_index(pos: torch.Tensor, hw: tuple[int, int], patch_shape: tuple[int, int]):
    """(B, Ny, 1) row and (B, 1, Nx) column indices of each clamped window."""
    ny, nx = patch_shape
    h, w = hw
    y = pos[:, 0].long().clamp(0, h - ny)
    x = pos[:, 1].long().clamp(0, w - nx)
    iy = y[:, None] + torch.arange(ny, device=pos.device)
    ix = x[:, None] + torch.arange(nx, device=pos.device)
    return iy[:, :, None], ix[:, None, :]


def gather_plain(canvas: torch.Tensor, pos: torch.Tensor, patch_shape) -> torch.Tensor:
    """(..., H, W) canvas, (B, 2) corners -> (B, ..., Ny, Nx) patches (indexing)."""
    iy, ix = _clamped_index(pos, canvas.shape[-2:], patch_shape)
    out = canvas[..., iy, ix]  # (..., B, Ny, Nx)
    return out.movedim(-3, 0)


def scatter_add_plain(canvas_shape, patches: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(B, ..., Ny, Nx) patches added into a zero (..., H, W) canvas
    (``index_add_``)."""
    h, w = canvas_shape[-2:]
    ny, nx = patches.shape[-2:]
    iy, ix = _clamped_index(pos, (h, w), (ny, nx))
    flat_idx = (iy * w + ix).reshape(-1)  # (B*Ny*Nx,)
    lead = canvas_shape[:-2]
    b = patches.shape[0]
    vals = patches.reshape(b, -1, ny * nx).transpose(0, 1).reshape(-1, b * ny * nx)
    out = torch.zeros((vals.shape[0], h * w), dtype=patches.dtype, device=patches.device)
    out.index_add_(1, flat_idx, vals)
    return out.reshape(*lead, h, w)


_MAX_GRID = 65535  # the card's largest grid extent in y and z


def _check_cuda_inputs(name: str, pos: torch.Tensor, tensors) -> None:
    """The corners and `tensors` on one CUDA device, `tensors` contiguous."""
    device = pos.device
    if device.type != "cuda":
        raise ValueError(f"{name}: the corners must be a CUDA tensor, got {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: a tensor is on {t.device}, the corners on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tuple(t.shape)} must be contiguous")


def _ints(shape) -> tuple:
    return tuple(int(v) for v in shape)


def _pos_i32(pos: torch.Tensor, b: int) -> torch.Tensor:
    if pos.shape != (b, 2):
        raise ValueError(f"corners must be (B, 2), got {tuple(pos.shape)}")
    return pos.to(torch.int32).contiguous()


def _gather_launch(canvases: tuple, pos: torch.Tensor, patch_shape) -> tuple:
    """One B1 launch for one or two f32 (..., H, W) canvases of one shape:
    their (B, ..., Ny, Nx) patches."""
    ny, nx = patch_shape
    first = canvases[0]
    h, w = first.shape[-2:]
    for c in canvases:
        if c.dtype != torch.float32:
            raise ValueError(f"gather_cuda: canvas must be float32, got {c.dtype}")
    second = len(canvases) == 2
    if second and canvases[1].shape != first.shape:
        raise ValueError(f"gather_cuda: canvases {tuple(first.shape)} and "
                         f"{tuple(canvases[1].shape)} differ")
    if not (0 < ny <= h and 0 < nx <= w):
        raise ValueError(f"gather_cuda: patch {ny}x{nx} does not fit canvas {h}x{w}")
    lead = first.shape[:-2]
    l = first.numel() // (h * w)
    if l > _MAX_GRID:
        raise ValueError(f"gather_cuda: {l} canvas planes exceed {_MAX_GRID}")
    b = pos.shape[0]
    pos32 = _pos_i32(pos, b)
    _check_cuda_inputs("gather_cuda", pos32, canvases)
    outs = [torch.empty((b, *lead, ny, nx), dtype=c.dtype, device=c.device) for c in canvases]
    _build.launch("ptyrad_gather_patches", first, first.data_ptr(),
                  canvases[1].data_ptr() if second else None, pos32.data_ptr(),
                  outs[0].data_ptr(), outs[1].data_ptr() if second else None,
                  b, l, h, w, ny, nx)
    gather_cuda.launches += 1
    return tuple(outs)


def gather_cuda(canvas: torch.Tensor, pos: torch.Tensor, patch_shape) -> torch.Tensor:
    """Kernel B1 on the card: f32 (..., H, W) canvas -> (B, ..., Ny, Nx)."""
    return _gather_launch((canvas,), pos, _ints(patch_shape))[0]


gather_cuda.launches = 0


def gather_pair_cuda(obja: torch.Tensor, objp: torch.Tensor, pos: torch.Tensor,
                     patch_shape) -> tuple:
    """One B1 launch for two f32 canvases of one shape at the same corners."""
    return _gather_launch((obja, objp), pos, _ints(patch_shape))


def _scatter_launch(canvas_shape: tuple, patches: tuple, pos: torch.Tensor) -> tuple:
    """One B2 launch for one or two f32 (B, ..., Ny, Nx) patch stacks of one
    shape: their (..., H, W) canvases."""
    h, w = canvas_shape[-2:]
    first = patches[0]
    b, ny, nx = first.shape[0], first.shape[-2], first.shape[-1]
    for p in patches:
        if p.dtype != torch.float32:
            raise ValueError(f"scatter_add_cuda: patches must be float32, got {p.dtype}")
    second = len(patches) == 2
    if second and patches[1].shape != first.shape:
        raise ValueError(f"scatter_add_cuda: patches {tuple(first.shape)} and "
                         f"{tuple(patches[1].shape)} differ")
    if tuple(first.shape[1:-2]) != canvas_shape[:-2] or not (ny <= h and nx <= w):
        raise ValueError(f"scatter_add_cuda: patches {tuple(first.shape)} do not fit "
                         f"canvas {canvas_shape}")
    pos32 = _pos_i32(pos, b)
    _check_cuda_inputs("scatter_add_cuda", pos32, patches)
    outs = [torch.empty(canvas_shape, dtype=p.dtype, device=p.device) for p in patches]
    l = outs[0].numel() // (h * w)
    if l * len(patches) > _MAX_GRID:
        raise ValueError(f"scatter_add_cuda: {l} canvas planes exceed {_MAX_GRID}")
    _build.launch("ptyrad_scatter_add_patches", first, first.data_ptr(),
                  patches[1].data_ptr() if second else None, pos32.data_ptr(),
                  outs[0].data_ptr(), outs[1].data_ptr() if second else None,
                  b, l, h, w, ny, nx)
    scatter_add_cuda.launches += 1
    return tuple(outs)


def scatter_add_cuda(canvas_shape, patches: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on the card: (B, ..., Ny, Nx) f32 patches -> (..., H, W)."""
    return _scatter_launch(_ints(canvas_shape), (patches,), pos)[0]


scatter_add_cuda.launches = 0


def scatter_add_pair_cuda(canvas_shape, patches_a: torch.Tensor, patches_p: torch.Tensor,
                          pos: torch.Tensor) -> tuple:
    """One B2 launch for two f32 patch stacks of one shape at the same corners."""
    return _scatter_launch(_ints(canvas_shape), (patches_a, patches_p), pos)


def _gather(canvases: tuple, pos: torch.Tensor, patch_shape: tuple) -> tuple:
    """B1 over one or two canvases: the plain version on CPU tensors, one
    kernel launch on CUDA tensors."""
    if canvases[0].device.type == "cpu":
        return tuple(gather_plain(c, pos, patch_shape) for c in canvases)
    return _gather_launch(canvases, pos, patch_shape)


def _scatter(canvas_shape: tuple, patches: tuple, pos: torch.Tensor) -> tuple:
    """B2 over one or two patch stacks: the plain version on CPU tensors,
    one kernel launch on CUDA tensors."""
    if patches[0].device.type == "cpu":
        return tuple(scatter_add_plain(canvas_shape, p, pos) for p in patches)
    return _scatter_launch(canvas_shape, patches, pos)


def gather_patches(canvas: torch.Tensor, pos: torch.Tensor, patch_shape) -> torch.Tensor:
    """B1: the plain version on a CPU tensor, the kernel on a CUDA tensor."""
    return _gather((canvas,), pos, _ints(patch_shape))[0]


def scatter_add_patches(canvas_shape, patches: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """B2, the explicit adjoint of ``extract_patches``: accumulate
    (B, ..., Ny, Nx) patches into a fresh (..., H, W) canvas."""
    return _scatter(_ints(canvas_shape), (patches,), pos)[0]


class _ExtractPatches(torch.autograd.Function):
    """B1 of one or two canvases of one shape at the same corners; the
    backward is one B2 over the cotangents of the canvases that need a
    gradient. An unused output's cotangent arrives as None (grads are not
    materialised): its canvas gets a zero gradient without a scatter."""

    @staticmethod
    def forward(ctx, pos, patch_shape, *canvases):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pos)
        first = canvases[0]
        ctx.canvas = (tuple(first.shape), first.dtype, first.device)
        return _gather(canvases, pos, patch_shape)

    @staticmethod
    def backward(ctx, *grads):
        (pos,) = ctx.saved_tensors
        shape, dtype, device = ctx.canvas
        need = ctx.needs_input_grad[2:]
        live = tuple(g.contiguous() for g, n in zip(grads, need) if n and g is not None)
        sums = iter(_scatter(shape, live, pos) if live else ())
        out = [(next(sums) if g is not None else torch.zeros(shape, dtype=dtype, device=device))
               if n else None for g, n in zip(grads, need)]
        return None, None, *out


def extract_patches(canvas: torch.Tensor, pos: torch.Tensor, patch_shape) -> torch.Tensor:
    """Gather (B, ..., Ny, Nx) patches from `canvas` at (B, 2) integer
    top-left corners; the gradient is the scatter-add (B2)."""
    return _ExtractPatches.apply(pos, _ints(patch_shape), canvas)[0]


def extract_patch_pair(obja: torch.Tensor, objp: torch.Tensor, pos: torch.Tensor,
                       patch_shape) -> tuple:
    """``extract_patches`` of two canvases of one shape at the same (B, 2)
    corners: one B1 launch forward, one B2 launch backward for the canvases
    that need a gradient.

    Under canvas sharding (parallel/canvas.py) the canvases are a rank's
    halo-extended slab (rows_local + halo rows) and the corners are rebased
    to its first row; B1/B2 take any row count, and a corner below 0 or past
    the last row clamps. This is the counterpart of both extract_patches and
    extract_patches_local (ptyrad_tpu/ops/patches.py:450-475): a rank has no
    mesh to escape, so one function serves both."""
    if obja.shape != objp.shape:
        raise ValueError(f"extract_patch_pair: canvases {tuple(obja.shape)} and "
                         f"{tuple(objp.shape)} differ")
    return _ExtractPatches.apply(pos, _ints(patch_shape), obja, objp)
