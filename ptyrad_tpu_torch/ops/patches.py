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
Corners are clamped like ``lax.dynamic_slice``: y to [0, H-Ny], x to
[0, W-Nx].
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


def _check_cuda_inputs(name: str, tensors: dict) -> None:
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _pos_i32(pos: torch.Tensor, b: int) -> torch.Tensor:
    if pos.shape != (b, 2):
        raise ValueError(f"corners must be (B, 2), got {tuple(pos.shape)}")
    return pos.to(torch.int32).contiguous()


def gather_cuda(canvas: torch.Tensor, pos: torch.Tensor, patch_shape) -> torch.Tensor:
    """Kernel B1 on the card: f32 (..., H, W) canvas -> (B, ..., Ny, Nx)."""
    ny, nx = (int(v) for v in patch_shape)
    h, w = canvas.shape[-2:]
    if canvas.dtype != torch.float32:
        raise ValueError(f"gather_cuda: canvas must be float32, got {canvas.dtype}")
    if not (0 < ny <= h and 0 < nx <= w):
        raise ValueError(f"gather_cuda: patch {ny}x{nx} does not fit canvas {h}x{w}")
    lead = canvas.shape[:-2]
    b = pos.shape[0]
    pos32 = _pos_i32(pos, b)
    _check_cuda_inputs("gather_cuda", {"canvas": canvas, "pos": pos32})
    out = torch.empty((b, *lead, ny, nx), dtype=canvas.dtype, device=canvas.device)
    l = canvas.numel() // (h * w)
    err = _build.lib().ptyrad_gather_patches(
        canvas.data_ptr(), pos32.data_ptr(), out.data_ptr(), b, l, h, w, ny, nx,
        torch.cuda.current_stream(canvas.device).cuda_stream)
    _build.check(err, "gather_patches")
    gather_cuda.launches += 1
    return out


gather_cuda.launches = 0


def scatter_add_cuda(canvas_shape, patches: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on the card: (B, ..., Ny, Nx) f32 patches -> (..., H, W)."""
    canvas_shape = tuple(int(v) for v in canvas_shape)
    h, w = canvas_shape[-2:]
    b, ny, nx = patches.shape[0], patches.shape[-2], patches.shape[-1]
    if patches.dtype != torch.float32:
        raise ValueError(f"scatter_add_cuda: patches must be float32, got {patches.dtype}")
    if tuple(patches.shape[1:-2]) != canvas_shape[:-2] or not (ny <= h and nx <= w):
        raise ValueError(f"scatter_add_cuda: patches {tuple(patches.shape)} do not fit "
                         f"canvas {canvas_shape}")
    pos32 = _pos_i32(pos, b)
    _check_cuda_inputs("scatter_add_cuda", {"patches": patches, "pos": pos32})
    out = torch.empty(canvas_shape, dtype=patches.dtype, device=patches.device)
    l = out.numel() // (h * w)
    err = _build.lib().ptyrad_scatter_add_patches(
        patches.data_ptr(), pos32.data_ptr(), out.data_ptr(), b, l, h, w, ny, nx,
        torch.cuda.current_stream(patches.device).cuda_stream)
    _build.check(err, "scatter_add_patches")
    scatter_add_cuda.launches += 1
    return out


scatter_add_cuda.launches = 0


def gather_patches(canvas: torch.Tensor, pos: torch.Tensor, patch_shape) -> torch.Tensor:
    """B1: the plain version on a CPU tensor, the kernel on a CUDA tensor."""
    if canvas.device.type == "cpu":
        return gather_plain(canvas, pos, patch_shape)
    return gather_cuda(canvas, pos, patch_shape)


def scatter_add_patches(canvas_shape, patches: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """B2, the explicit adjoint of ``extract_patches``: accumulate
    (B, ..., Ny, Nx) patches into a fresh (..., H, W) canvas."""
    if patches.device.type == "cpu":
        return scatter_add_plain(canvas_shape, patches, pos)
    return scatter_add_cuda(canvas_shape, patches, pos)


class _ExtractPatches(torch.autograd.Function):
    @staticmethod
    def forward(ctx, canvas, pos, patch_shape):
        ctx.save_for_backward(pos)
        ctx.canvas_shape = tuple(canvas.shape)
        return gather_patches(canvas, pos, patch_shape)

    @staticmethod
    def backward(ctx, grad):
        (pos,) = ctx.saved_tensors
        return scatter_add_patches(ctx.canvas_shape, grad.contiguous(), pos), None, None


def extract_patches(canvas: torch.Tensor, pos: torch.Tensor, patch_shape) -> torch.Tensor:
    """Gather (B, ..., Ny, Nx) patches from `canvas` at (B, 2) integer
    top-left corners; the gradient is the scatter-add (B2)."""
    return _ExtractPatches.apply(canvas, pos, tuple(int(v) for v in patch_shape))
