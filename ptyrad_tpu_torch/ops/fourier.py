"""2D Fourier transforms with the JAX package's conventions, on torch.fft.

ptyrad_tpu/ops/fourier.py computes these as DFT matrix products because the
TPU has no FFT; here they are plain ``torch.fft`` calls. ``norm=None`` is the
unnormalized forward / 1/N inverse pair (torch's "backward"), ``"ortho"`` the
unitary pair.

``bf16_operands=True`` is the bfloat16 compute policy's transform
(model_params compute_dtype / matmul_dtype 'bfloat16'; the JAX package's
``set_matmul_dtype('bfloat16')``): a sequence of 1-D passes, each of which
rounds its operand to bfloat16 (round to nearest even) and transforms it in
float32, as each DFT pass of the JAX package and of every CUDA kernel does.
Its backward rounds the cotangent the same way before the adjoint pass,
where the kernels' backwards round. The output stays complex64. The 2-D
forms run in the kernels' pass order: ``fft2`` along x (dim -1) then y,
``ifft2`` along y then x (csrc/multislice.cu, csrc/chain.cu). The JAX
package transforms dim -2 first in both; the order moves only which value
is rounded, at the level of the rounding itself.
"""

from __future__ import annotations

import torch


def _norm(norm):
    if norm is None:
        return "backward"
    if norm == "ortho":
        return "ortho"
    raise ValueError(f"unsupported norm {norm!r}; use None or 'ortho'")


def round_bf16_values(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (each of re and im for a complex tensor, round
    to nearest even), in x's own dtype; no autograd."""
    if x.is_complex():
        r = torch.view_as_real(x)
        return torch.view_as_complex(r.to(torch.bfloat16).to(r.dtype))
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundBf16(torch.autograd.Function):
    """Rounding to bfloat16 whose backward rounds the cotangent (the
    autograd of ``.to(torch.bfloat16)`` would pass it through unrounded)."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16_values(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16_values(g)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 in its own dtype; the cotangent is rounded too."""
    return _RoundBf16.apply(x)


# the adjoint of a pass under each norm: the conjugate transform, scaled so
# that <F x, y> = <x, F^H y>
_ADJOINT_NORM = {"backward": "forward", "ortho": "ortho", "forward": "backward"}


class _Bf16Pass(torch.autograd.Function):
    """One 1-D DFT along ``dim`` whose operand is rounded to bfloat16; the
    backward rounds the cotangent, then applies the adjoint transform."""

    @staticmethod
    def forward(ctx, x, dim: int, inverse: bool, norm: str):
        ctx.consts = (dim, inverse, norm, x.is_complex())
        fn = torch.fft.ifft if inverse else torch.fft.fft
        return fn(round_bf16_values(x), dim=dim, norm=norm)

    @staticmethod
    def backward(ctx, g):
        dim, inverse, norm, was_complex = ctx.consts
        adj = torch.fft.fft if inverse else torch.fft.ifft
        d = adj(round_bf16_values(g), dim=dim, norm=_ADJOINT_NORM[norm])
        return (d if was_complex else d.real), None, None, None


def _passes(x: torch.Tensor, dims, inverse: bool, norm: str) -> torch.Tensor:
    for dim in dims:
        x = _Bf16Pass.apply(x, dim, inverse, norm)
    return x


def fft2(x: torch.Tensor, norm: str | None = None, bf16_operands: bool = False) -> torch.Tensor:
    """2D DFT over the last two axes (real input is promoted to complex);
    with ``bf16_operands`` two rounded passes, x then y."""
    if bf16_operands:
        return _passes(x, (-1, -2), False, _norm(norm))
    return torch.fft.fft2(x, norm=_norm(norm))


def ifft2(x: torch.Tensor, norm: str | None = None, bf16_operands: bool = False) -> torch.Tensor:
    """2D inverse DFT over the last two axes; with ``bf16_operands`` two
    rounded passes, y then x."""
    if bf16_operands:
        return _passes(x, (-2, -1), True, _norm(norm))
    return torch.fft.ifft2(x, norm=_norm(norm))


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """fftshift over the last two axes."""
    return torch.roll(x, (x.shape[-2] // 2, x.shape[-1] // 2), dims=(-2, -1))


def ifftshift2(x: torch.Tensor) -> torch.Tensor:
    """ifftshift over the last two axes (differs from fftshift for odd N)."""
    return torch.roll(x, (-(x.shape[-2] // 2), -(x.shape[-1] // 2)), dims=(-2, -1))


def fftn3(x: torch.Tensor, inverse: bool = False, bf16_operands: bool = False) -> torch.Tensor:
    """3D DFT over the last three axes (the kz-filter constraint);
    unnormalized forward, 1/(Nz Ny Nx) inverse. With ``bf16_operands`` three
    rounded passes along z, y, x, the JAX package's order (no kernel runs
    it)."""
    if bf16_operands:
        return _passes(x, (-3, -2, -1), inverse, "backward")
    fn = torch.fft.ifftn if inverse else torch.fft.fftn
    return fn(x, dim=(-3, -2, -1), norm="backward")
