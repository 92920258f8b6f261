"""The fused multislice chain for N <= 128: the plain pair (kernel B4),
whose output is the far-field intensity, and the loss-folded pair (kernel
B3), whose output is the partial sums of the loss_single data term.

Counterpart of ptyrad_tpu/ops/pallas_multislice.py: ``multislice_dp_fused``
(:356) and ``multislice_loss_sums_fused`` (:626). For each sample b and
probe mode p

    psi  = probe[b or 0, p]            (ifft2 of it when probe_kspace)
    for z:  psi *= a_z exp(i phi_z);  between slices psi = ifft2(H fft2(psi))
    dp   = sum_p |fft2(psi)|^2 / N^2   (corner-centred; B4's output)
    s1   = sum_b mask_b sum((dp + eps)^p - meas^p)^2     (B3's outputs)
    s2   = sum_b mask_b sum meas^p

with ``meas`` ifftshifted to the corner-centred order by the caller. s1
carries the gradient; s2 depends on the measurements only. B4 returns the
raw dp: the caller weights object modes, applies fftshift and adds eps
(models/forward.py).

On a CPU tensor each entry point runs its plain version (``multislice_dp_plain``,
``loss_sums_plain``), the torch.fft chain under autograd. On a CUDA tensor it
runs the hand-written kernels of ``csrc/multislice.cu`` through an
autograd.Function whose forward is B4a (B3a) and whose backward is B4b
(B3b), or raises: the kernels take omode 1, a shared propagator and N a
power of two up to 128, and compute no propagator gradient.
"""

from __future__ import annotations

import torch

from ptyrad_tpu_torch.ops import _build
from ptyrad_tpu_torch.ops.fourier import fft2, ifft2

MAX_N = 128  # a 128^2 complex64 wavefield fills 128 KB of a block's shared memory


def _pow(x: torch.Tensor, p: float) -> torch.Tensor:
    if p == 1.0:
        return x
    if p == 0.5:
        return torch.sqrt(x)
    return torch.pow(x, p)


def multislice_dp_plain(obja_p, objp_p, probe, h, probe_kspace: bool = False):
    """The plain PyTorch version of B4 (differentiable through autograd):
    the raw dp (B, N, N), corner-centred, with no occupancy weight, fftshift
    or eps, as ptyrad_tpu/ops/pallas_multislice.py:_fused_fwd_impl returns.

    obja_p, objp_p (B, 1, Nz, N, N) f32; probe (B or 1, pmode, N, N)
    complex64 (a spectrum when probe_kspace); h (B or 1, N, N) complex64.
    """
    n_slices = obja_p.shape[2]
    psi = ifft2(probe) if probe_kspace else probe
    hb = h[:, None]
    for z in range(n_slices):
        a, phi = obja_p[:, 0, z], objp_p[:, 0, z]
        psi = psi * torch.complex(a * torch.cos(phi), a * torch.sin(phi))[:, None]
        if z < n_slices - 1:
            psi = ifft2(hb * fft2(psi))
    y = fft2(psi)
    return (y.real ** 2 + y.imag ** 2).sum(1) / (y.shape[-2] * y.shape[-1])


def loss_sums_plain(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow: float, eps: float,
                    probe_kspace: bool = False):
    """The plain PyTorch version of B3 (differentiable through autograd):
    the operands of multislice_dp_plain plus meas_cc (B, N, N) and mask
    (B,). Returns (s1, s2) scalars.
    """
    dp = multislice_dp_plain(obja_p, objp_p, probe, h, probe_kspace)
    mp = _pow(meas_cc, dp_pow)
    diff = _pow(dp + eps, dp_pow) - mp
    w = mask[:, None, None]
    return (w * diff * diff).sum(), (w * mp).sum()


def fused_applicable_shapes(b, omode, nz, ny, nx, probe_b, pmode, h_b) -> bool:
    """The card's rule for what the fused kernels (B3 and B4) take: square
    N x N with N a power of two, 2 <= N <= MAX_N (the whole wavefield sits
    in one block's shared memory), and a shared or per-position probe. Pure
    shape logic, the counterpart of
    ptyrad_tpu/ops/pallas_multislice.py:fused_applicable_shapes; omode (the
    callers loop object modes), nz, pmode and h_b do not limit the kernels'
    shared memory, and a per-position H or need_dh raise inside the regime
    (ROADMAP queue A, item 2)."""
    return ny == nx and 2 <= nx <= MAX_N and not nx & (nx - 1) and probe_b in (1, b)


def _shape_info(obja_p, probe, h):
    if obja_p.dim() != 5 or obja_p.shape[1] != 1:
        raise ValueError(f"object patches must be (B, 1, Nz, N, N), got {tuple(obja_p.shape)}")
    b, _, nz, ny, nx = obja_p.shape
    if ny != nx or nx > MAX_N or nx < 2 or nx & (nx - 1):
        raise ValueError(f"the fused kernels (B3, B4) take square N x N patches with N a power "
                         f"of two <= {MAX_N}; got {ny}x{nx}")
    if probe.shape[0] not in (1, b) or tuple(probe.shape[2:]) != (ny, nx):
        raise ValueError(f"probe must be (1 or {b}, pmode, {ny}, {nx}), got {tuple(probe.shape)}")
    if tuple(h.shape) != (1, ny, nx):
        raise ValueError(f"propagator must be (1, {ny}, {nx}), got {tuple(h.shape)}")
    return b, nz, nx.bit_length() - 1, probe.shape[1], int(probe.shape[0] == 1)


def _check(name, tensors):
    for key, (t, dtype) in tensors.items():
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous CUDA {dtype} tensor, "
                             f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _inputs(obja_p, objp_p, probe, h, **real):
    """The operands of a launch with their dtypes; the keyword tensors are
    float32."""
    return {"obja_p": (obja_p, torch.float32), "objp_p": (objp_p, torch.float32),
            "probe": (probe, torch.complex64), "h": (h, torch.complex64),
            **{k: (t, torch.float32) for k, t in real.items()}}


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def dp_fwd_cuda(obja_p, objp_p, probe, h, probe_kspace: bool):
    """Kernel B4a (the chain, then the mode sum in mode order): dp (B, N, N),
    corner-centred."""
    b, nz, logn, pmode, shared = _shape_info(obja_p, probe, h)
    n = 1 << logn
    _check("dp_fwd_cuda", _inputs(obja_p, objp_p, probe, h))
    dev = obja_p.device
    inten = torch.empty((b, pmode, n, n), dtype=torch.float32, device=dev)
    dp = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    err = _build.lib().ptyrad_dp_fwd(
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(), inten.data_ptr(),
        dp.data_ptr(), b, pmode, nz, logn, shared, int(bool(probe_kspace)), _stream(obja_p))
    _build.check(err, "dp_fwd")
    dp_fwd_cuda.launches += 1
    return dp


dp_fwd_cuda.launches = 0


def dp_bwd_cuda(obja_p, objp_p, probe, h, g, probe_kspace: bool):
    """Kernel B4b: recomputes the chain and walks it back from g, the
    cotangent of dp (B, N, N). Returns (d obja_p, d objp_p, d probe)."""
    b, nz, logn, pmode, shared = _shape_info(obja_p, probe, h)
    n = 1 << logn
    _check("dp_bwd_cuda", _inputs(obja_p, objp_p, probe, h, g=g))
    if tuple(g.shape) != (b, n, n):
        raise ValueError(f"dp_bwd_cuda: g must be ({b}, {n}, {n}), got {tuple(g.shape)}")
    stack = torch.empty((b, pmode, nz, n, n), dtype=torch.complex64, device=obja_p.device)
    d_obja = torch.empty_like(obja_p)
    d_objp = torch.empty_like(objp_p)
    d_probe = torch.empty_like(probe)
    err = _build.lib().ptyrad_dp_bwd(
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(), g.data_ptr(),
        stack.data_ptr(), d_obja.data_ptr(), d_objp.data_ptr(), d_probe.data_ptr(), b, pmode,
        nz, logn, shared, int(bool(probe_kspace)), _stream(obja_p))
    _build.check(err, "dp_bwd")
    dp_bwd_cuda.launches += 1
    return d_obja, d_objp, d_probe


dp_bwd_cuda.launches = 0


class _DpCuda(torch.autograd.Function):
    """B4a forward, B4b backward; saves only the inputs, as the JAX
    residuals do (pallas_multislice.py:425)."""

    @staticmethod
    def forward(ctx, obja_p, objp_p, probe, h, probe_kspace):
        ctx.save_for_backward(obja_p, objp_p, probe, h)
        ctx.probe_kspace = probe_kspace
        return dp_fwd_cuda(obja_p, objp_p, probe, h, probe_kspace)

    @staticmethod
    def backward(ctx, g):
        obja_p, objp_p, probe, h = ctx.saved_tensors
        d_obja, d_objp, d_probe = dp_bwd_cuda(obja_p, objp_p, probe, h, g.contiguous(),
                                              ctx.probe_kspace)
        return d_obja, d_objp, d_probe, None, None


def _check_regime(need_dh: bool, h) -> None:
    """What the CUDA kernels do not compute yet raises (ROADMAP queue A, item 2)."""
    if need_dh:
        raise NotImplementedError(
            "the CUDA fused kernels (B3, B4) compute no propagator gradient (need_dh): "
            "optimizable slice thickness or tilts wait for ROADMAP queue A, item 2")
    if h.shape[0] != 1:
        raise NotImplementedError(
            "the CUDA fused kernels (B3, B4) take one shared propagator; a per-position H "
            "waits for ROADMAP queue A, item 2")


def multislice_dp_fused(obja_p, objp_p, probe, h, need_dh: bool = False,
                        probe_kspace: bool = False):
    """Raw dp (B, N, N), corner-centred (the caller applies the object-mode
    weight, fftshift and eps); see the module docstring.

    need_dh: H depends on optimizable parameters (slice thickness or tilts),
    so its cotangent is needed. The plain version gets it from autograd; the
    CUDA kernels do not compute it yet and raise. probe_kspace: the probe is
    the shifted spectrum (ops/shift.py:fourier_shift_kspace), transformed
    inside the kernel.
    """
    if obja_p.device.type == "cpu":
        return multislice_dp_plain(obja_p, objp_p, probe, h, probe_kspace)
    _check_regime(need_dh, h)
    return _DpCuda.apply(obja_p.contiguous(), objp_p.contiguous(), probe.contiguous(),
                         h.contiguous(), bool(probe_kspace))


def loss_sums_fwd_cuda(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow: float, eps: float,
                       probe_kspace: bool):
    """Kernel B3a (chain, the per-sample mode reduction, the sum over
    samples). Returns (s1, s2, dp) with dp (B, N, N) the corner-centred
    intensity kept for the backward."""
    b, nz, logn, pmode, shared = _shape_info(obja_p, probe, h)
    n = 1 << logn
    _check("loss_sums_fwd_cuda", _inputs(obja_p, objp_p, probe, h, meas_cc=meas_cc, mask=mask))
    if tuple(meas_cc.shape) != (b, n, n) or tuple(mask.shape) != (b,):
        raise ValueError("loss_sums_fwd_cuda: meas_cc must be (B, N, N) and mask (B,)")
    dev = obja_p.device
    inten = torch.empty((b, pmode, n, n), dtype=torch.float32, device=dev)
    dp = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    partial = torch.empty((b, 2), dtype=torch.float32, device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    err = _build.lib().ptyrad_loss_fwd(
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(),
        meas_cc.data_ptr(), mask.data_ptr(), inten.data_ptr(), dp.data_ptr(),
        partial.data_ptr(), sums.data_ptr(), b, pmode, nz, logn, shared,
        int(bool(probe_kspace)), float(dp_pow), float(eps), _stream(obja_p))
    _build.check(err, "loss_sums_fwd")
    loss_sums_fwd_cuda.launches += 1
    return sums[0], sums[1], dp


loss_sums_fwd_cuda.launches = 0


def loss_sums_bwd_cuda(obja_p, objp_p, probe, h, meas_cc, mask, dp, c, dp_pow: float,
                       eps: float, probe_kspace: bool):
    """Kernel B3b: recomputes the chain and walks it back. c is the upstream
    cotangent of s1 (a device scalar). Returns (d obja_p, d objp_p, d probe)."""
    b, nz, logn, pmode, shared = _shape_info(obja_p, probe, h)
    n = 1 << logn
    _check("loss_sums_bwd_cuda",
           _inputs(obja_p, objp_p, probe, h, meas_cc=meas_cc, mask=mask, dp=dp, c=c))
    if tuple(dp.shape) != (b, n, n) or c.numel() != 1:
        raise ValueError("loss_sums_bwd_cuda: dp must be (B, N, N) and c a scalar")
    stack = torch.empty((b, pmode, nz, n, n), dtype=torch.complex64, device=obja_p.device)
    d_obja = torch.empty_like(obja_p)
    d_objp = torch.empty_like(objp_p)
    d_probe = torch.empty_like(probe)
    err = _build.lib().ptyrad_loss_bwd(
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(),
        meas_cc.data_ptr(), mask.data_ptr(), dp.data_ptr(), c.data_ptr(), stack.data_ptr(),
        d_obja.data_ptr(), d_objp.data_ptr(), d_probe.data_ptr(), b, pmode, nz, logn, shared,
        int(bool(probe_kspace)), float(dp_pow), float(eps), _stream(obja_p))
    _build.check(err, "loss_sums_bwd")
    loss_sums_bwd_cuda.launches += 1
    return d_obja, d_objp, d_probe


loss_sums_bwd_cuda.launches = 0


class _LossSumsCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, obja_p, objp_p, probe, h, meas_cc, mask, dp_pow, eps, probe_kspace):
        s1, s2, dp = loss_sums_fwd_cuda(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow, eps,
                                        probe_kspace)
        ctx.save_for_backward(obja_p, objp_p, probe, h, meas_cc, mask, dp)
        ctx.consts = (dp_pow, eps, probe_kspace)
        ctx.mark_non_differentiable(s2)
        return s1, s2

    @staticmethod
    def backward(ctx, g1, _g2):
        obja_p, objp_p, probe, h, meas_cc, mask, dp = ctx.saved_tensors
        c = g1.reshape(()).to(torch.float32).contiguous()
        d_obja, d_objp, d_probe = loss_sums_bwd_cuda(obja_p, objp_p, probe, h, meas_cc, mask,
                                                     dp, c, *ctx.consts)
        return d_obja, d_objp, d_probe, None, None, None, None, None, None


def multislice_loss_sums_fused(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow: float,
                               eps: float, need_dh: bool = False, probe_kspace: bool = False):
    """(s1, s2) of the loss_single data term; see the module docstring.

    need_dh: H depends on optimizable parameters (slice thickness or tilts),
    so its cotangent is needed. The plain version gets it from autograd; the
    CUDA kernels do not compute it yet and raise.
    """
    if obja_p.device.type == "cpu":
        return loss_sums_plain(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow, eps,
                               probe_kspace)
    _check_regime(need_dh, h)
    return _LossSumsCuda.apply(obja_p.contiguous(), objp_p.contiguous(), probe.contiguous(),
                               h.contiguous(), meas_cc.contiguous(), mask.contiguous(),
                               float(dp_pow), float(eps), bool(probe_kspace))
