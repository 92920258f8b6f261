"""The fused multislice chain for every N <= 128: the plain pair (kernel B4),
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

The propagator H is shared (1, N, N) or per position (B, N, N). When H
depends on optimizable parameters (slice thickness or tilts: need_dh), the
backward also returns its cotangent dH in H's shape.

On a CPU tensor each entry point runs its plain version (``multislice_dp_plain``,
``loss_sums_plain``), the torch.fft chain under autograd. On a CUDA tensor it
runs the hand-written kernels of ``csrc/multislice.cu`` through an
autograd.Function whose forward is B4a (B3a) and whose backward is B4b
(B3b), computing dH only when autograd asks for H's gradient, or raises:
the kernels take omode 1 and any square N from 2 to 128. Each wavefield
stays in one block's shared memory for the whole chain and is transformed
in registers: at N a power of two by the radix-2 pair of
``csrc/reg_fft.cuh`` (the header the chain kernels share), at any other N
by its mixed-radix pair or, at N with a prime factor above 7, its
Bluestein line, with the plan ``ops/fused_plan.py`` chooses for that N,
built into a library of its own at the first use of that N
(``_build.mixed_lib``; ``prepare`` builds it ahead).
tests/test_torch_fused_plan.py emulates the kernels' plans.

``bf16_operands`` (the bfloat16 compute policy, models/state.py) rounds the
operand of every 1-D transform pass to bfloat16, forward and adjoint, as
the JAX kernels' ``gemm_dtype`` does: on the CPU through ops/fourier.py's
rounded passes in the kernels' pass order, on CUDA through the kernels of
``csrc/multislice_bf16.cu`` (multislice.cu compiled with the rounding on;
the ``_bf16`` entry points). Everything else stays float32.
"""

from __future__ import annotations

import torch

from ptyrad_tpu_torch.ops import _build
from ptyrad_tpu_torch.ops.fourier import fft2, ifft2
from ptyrad_tpu_torch.ops.fused_plan import MAX_N, is_pow2


def prepare(device, n: int) -> None:
    """Do the float32 kernels' one-time set-up for N-point fields on a CUDA
    device (at N that is not a power of two the build of its library first,
    then the twiddle tables and the chain kernels' shared-memory limits).
    The first launch at each N does it otherwise (the _bf16 twins' always
    so); after it no launch does any, so call it for every N before
    capturing launches in a CUDA graph."""
    if not 2 <= n <= MAX_N:
        raise ValueError(f"prepare: N must be in [2, {MAX_N}], got {n}")
    _build.launch("ptyrad_fused_prepare", torch.empty(0, device=device), n, stream=False, n=n)


def _pow(x: torch.Tensor, p: float) -> torch.Tensor:
    if p == 1.0:
        return x
    if p == 0.5:
        return torch.sqrt(x)
    return torch.pow(x, p)


def multislice_dp_plain(obja_p, objp_p, probe, h, probe_kspace: bool = False,
                        bf16_operands: bool = False):
    """The plain PyTorch version of B4 (differentiable through autograd):
    the raw dp (B, N, N), corner-centred, with no occupancy weight, fftshift
    or eps, as ptyrad_tpu/ops/pallas_multislice.py:_fused_fwd_impl returns.

    obja_p, objp_p (B, 1, Nz, N, N) f32; probe (B or 1, pmode, N, N)
    complex64 (a spectrum when probe_kspace); h (B or 1, N, N) complex64.
    bf16_operands: every transform pass rounds its operand (and its
    cotangent) to bfloat16, where the kernel rounds.
    """
    ops = bf16_operands
    n_slices = obja_p.shape[2]
    psi = ifft2(probe, bf16_operands=ops) if probe_kspace else probe
    hb = h[:, None]
    for z in range(n_slices):
        a, phi = obja_p[:, 0, z], objp_p[:, 0, z]
        psi = psi * torch.complex(a * torch.cos(phi), a * torch.sin(phi))[:, None]
        if z < n_slices - 1:
            psi = ifft2(hb * fft2(psi, bf16_operands=ops), bf16_operands=ops)
    y = fft2(psi, bf16_operands=ops)
    return (y.real ** 2 + y.imag ** 2).sum(1) / (y.shape[-2] * y.shape[-1])


def loss_sums_plain(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow: float, eps: float,
                    probe_kspace: bool = False, bf16_operands: bool = False):
    """The plain PyTorch version of B3 (differentiable through autograd):
    the operands of multislice_dp_plain plus meas_cc (B, N, N) and mask
    (B,). Returns (s1, s2) scalars.
    """
    dp = multislice_dp_plain(obja_p, objp_p, probe, h, probe_kspace, bf16_operands)
    mp = _pow(meas_cc, dp_pow)
    diff = _pow(dp + eps, dp_pow) - mp
    w = mask[:, None, None]
    return (w * diff * diff).sum(), (w * mp).sum()


def fused_applicable_shapes(b, omode, nz, ny, nx, probe_b, pmode, h_b) -> bool:
    """The card's rule for what the fused kernels (B3 and B4) take: square
    N x N with 2 <= N <= MAX_N (the whole wavefield sits in one block's
    shared memory; the radix-2 pair at a power of two, the mixed-radix pair
    at any other N), and a shared or per-position probe. Pure
    shape logic, the counterpart of
    ptyrad_tpu/ops/pallas_multislice.py:fused_applicable_shapes; omode (the
    callers loop object modes), nz, pmode, h_b and need_dh do not limit the
    kernels' shared memory (dH goes through device scratch), so unlike the
    JAX rule nothing else declines."""
    return ny == nx and 2 <= nx <= MAX_N and probe_b in (1, b)


def _shape_info(obja_p, probe, h):
    if obja_p.dim() != 5 or obja_p.shape[1] != 1:
        raise ValueError(f"object patches must be (B, 1, Nz, N, N), got {tuple(obja_p.shape)}")
    b, _, nz, ny, nx = obja_p.shape
    if ny != nx or nx > MAX_N or nx < 2:
        raise ValueError(f"the fused kernels (B3, B4) take square N x N patches with "
                         f"2 <= N <= {MAX_N}; got {ny}x{nx}")
    if probe.shape[0] not in (1, b) or tuple(probe.shape[2:]) != (ny, nx):
        raise ValueError(f"probe must be (1 or {b}, pmode, {ny}, {nx}), got {tuple(probe.shape)}")
    if h.shape[0] not in (1, b) or tuple(h.shape[1:]) != (ny, nx):
        raise ValueError(f"propagator must be (1 or {b}, {ny}, {nx}), got {tuple(h.shape)}")
    return b, nz, nx, probe.shape[1], int(probe.shape[0] == 1), int(h.shape[0] == 1)


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


def _count(fn, h_shared, nz, dh=None, bf16_operands: bool = False, n: int = 128) -> None:
    """One launch of fn; launches_h_each counts those on a per-position H,
    launches_nz1 those of a single slice (no propagation in the chain),
    launches_dh (backwards) those that computed dH, launches_bf16 those with
    bfloat16 operands and launches_bf16_dh those that computed dH too; at N
    that is not a power of two launches_n<N> counts those at that N (the
    mixed-radix kernels), launches_n<N>_dh those that computed dH and
    launches_n<N>_bf16 those with bfloat16 operands."""
    fn.launches += 1
    if not is_pow2(n):
        keys = [f"launches_n{n}"]
        keys += [f"launches_n{n}_dh"] * (dh is not None) + [f"launches_n{n}_bf16"] * bf16_operands
        for key in keys:
            setattr(fn, key, getattr(fn, key, 0) + 1)
    if bf16_operands:
        fn.launches_bf16 += 1
        if dh is not None:
            fn.launches_bf16_dh += 1
    if nz == 1:
        fn.launches_nz1 += 1
    if not h_shared:
        fn.launches_h_each += 1
    if dh is not None:
        fn.launches_dh += 1


def _dh_scratch(b, pmode, nz, n, h, need_dh):
    """(kstack, dh_part, dh) for a backward launch: the K_z scratch (B,
    pmode, nz - 1, N, N), the per-wavefield partials (B, pmode, N, N) and dH
    in h's shape; three Nones without need_dh."""
    if not need_dh:
        return None, None, None
    dev = h.device
    kstack = torch.empty((b, pmode, max(nz - 1, 1), n, n), dtype=torch.complex64, device=dev)
    dh_part = torch.empty((b, pmode, n, n), dtype=torch.complex64, device=dev)
    return kstack, dh_part, torch.empty_like(h)


def _bwd_scratch(b, pmode, nz, n, probe, shared):
    """(stack, probe_part) for a backward launch: the (B, pmode, nz, N, N)
    slice-entry stack, which the kernel overwrites with each slice's dT for
    the fixed-order mode reduce, and a shared probe's (B, pmode, N, N)
    per-wavefield partials (None for a per-position probe)."""
    dev = probe.device
    stack = torch.empty((b, pmode, nz, n, n), dtype=torch.complex64, device=dev)
    part = torch.empty((b, pmode, n, n), dtype=torch.complex64, device=dev) if shared else None
    return stack, part


def dp_fwd_cuda(obja_p, objp_p, probe, h, probe_kspace: bool, bf16_operands: bool = False):
    """Kernel B4a (the chain, then the mode sum in mode order): dp (B, N, N),
    corner-centred."""
    b, nz, n, pmode, shared, h_shared = _shape_info(obja_p, probe, h)
    _check("dp_fwd_cuda", _inputs(obja_p, objp_p, probe, h))
    dev = obja_p.device
    inten = torch.empty((b, pmode, n, n), dtype=torch.float32, device=dev)
    dp = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    _build.launch(
        "ptyrad_dp_fwd", obja_p,
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(), inten.data_ptr(),
        dp.data_ptr(), b, pmode, nz, n, shared, h_shared, int(bool(probe_kspace)),
        bf16_operands=bf16_operands, n=n)
    _count(dp_fwd_cuda, h_shared, nz, bf16_operands=bf16_operands, n=n)
    return dp


dp_fwd_cuda.launches = dp_fwd_cuda.launches_h_each = dp_fwd_cuda.launches_nz1 = 0
dp_fwd_cuda.launches_bf16 = dp_fwd_cuda.launches_bf16_dh = 0


def dp_bwd_cuda(obja_p, objp_p, probe, h, g, probe_kspace: bool, need_dh: bool = False,
                bf16_operands: bool = False):
    """Kernel B4b: recomputes the chain and walks it back from g, the
    cotangent of dp (B, N, N). Returns (d obja_p, d objp_p, d probe, d h),
    d h None unless need_dh."""
    b, nz, n, pmode, shared, h_shared = _shape_info(obja_p, probe, h)
    _check("dp_bwd_cuda", _inputs(obja_p, objp_p, probe, h, g=g))
    if tuple(g.shape) != (b, n, n):
        raise ValueError(f"dp_bwd_cuda: g must be ({b}, {n}, {n}), got {tuple(g.shape)}")
    stack, probe_part = _bwd_scratch(b, pmode, nz, n, probe, shared)
    d_obja = torch.empty_like(obja_p)
    d_objp = torch.empty_like(objp_p)
    d_probe = torch.empty_like(probe)
    kstack, dh_part, d_h = _dh_scratch(b, pmode, nz, n, h, need_dh)
    _build.launch(
        "ptyrad_dp_bwd", obja_p,
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(), g.data_ptr(),
        stack.data_ptr(), _build.ptr(kstack), _build.ptr(dh_part), _build.ptr(d_h),
        d_obja.data_ptr(), d_objp.data_ptr(), d_probe.data_ptr(), _build.ptr(probe_part), b,
        pmode, nz, n, shared, h_shared, int(bool(probe_kspace)),
        bf16_operands=bf16_operands, n=n)
    _count(dp_bwd_cuda, h_shared, nz, d_h, bf16_operands, n)
    return d_obja, d_objp, d_probe, d_h


dp_bwd_cuda.launches = dp_bwd_cuda.launches_h_each = dp_bwd_cuda.launches_dh = 0
dp_bwd_cuda.launches_nz1 = dp_bwd_cuda.launches_bf16 = dp_bwd_cuda.launches_bf16_dh = 0


class _DpCuda(torch.autograd.Function):
    """B4a forward, B4b backward; saves only the inputs, as the JAX
    residuals do (pallas_multislice.py:425). dH is computed only when
    autograd asks for H's gradient."""

    @staticmethod
    def forward(ctx, obja_p, objp_p, probe, h, probe_kspace, bf16_operands):
        ctx.save_for_backward(obja_p, objp_p, probe, h)
        ctx.consts = (probe_kspace, bf16_operands)
        return dp_fwd_cuda(obja_p, objp_p, probe, h, probe_kspace, bf16_operands)

    @staticmethod
    def backward(ctx, g):
        obja_p, objp_p, probe, h = ctx.saved_tensors
        probe_kspace, bf16_operands = ctx.consts
        d_obja, d_objp, d_probe, d_h = dp_bwd_cuda(obja_p, objp_p, probe, h, g.contiguous(),
                                                   probe_kspace, ctx.needs_input_grad[3],
                                                   bf16_operands)
        return d_obja, d_objp, d_probe, d_h, None, None


def multislice_dp_fused(obja_p, objp_p, probe, h, probe_kspace: bool = False,
                        bf16_operands: bool = False):
    """Raw dp (B, N, N), corner-centred (the caller applies the object-mode
    weight, fftshift and eps); see the module docstring.

    When h requires a gradient (optimizable slice thickness or tilts: the
    JAX package's need_dh), both versions give its cotangent: the plain one
    through autograd, the kernels through B4b's dH half. probe_kspace: the
    probe is the shifted spectrum (ops/shift.py:fourier_shift_kspace),
    transformed inside the kernel. bf16_operands: the bfloat16 compute
    policy (the module docstring).
    """
    if obja_p.device.type == "cpu":
        return multislice_dp_plain(obja_p, objp_p, probe, h, probe_kspace, bf16_operands)
    return _DpCuda.apply(obja_p.contiguous(), objp_p.contiguous(), probe.contiguous(),
                         h.contiguous(), bool(probe_kspace), bool(bf16_operands))


def loss_sums_fwd_cuda(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow: float, eps: float,
                       probe_kspace: bool, bf16_operands: bool = False):
    """Kernel B3a (chain, the mode reduction in min(N, 16) blocks a sample,
    the sum of their partials in a fixed order). Returns (s1, s2, dp) with
    dp (B, N, N) the corner-centred intensity kept for the backward."""
    b, nz, n, pmode, shared, h_shared = _shape_info(obja_p, probe, h)
    _check("loss_sums_fwd_cuda", _inputs(obja_p, objp_p, probe, h, meas_cc=meas_cc, mask=mask))
    if tuple(meas_cc.shape) != (b, n, n) or tuple(mask.shape) != (b,):
        raise ValueError("loss_sums_fwd_cuda: meas_cc must be (B, N, N) and mask (B,)")
    dev = obja_p.device
    inten = torch.empty((b, pmode, n, n), dtype=torch.float32, device=dev)
    dp = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    # per-block partial sums of B3a's epilogue: min(N, 16) blocks a sample
    partial = torch.empty((b, min(n, 16), 2), dtype=torch.float32, device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    _build.launch(
        "ptyrad_loss_fwd", obja_p,
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(),
        meas_cc.data_ptr(), mask.data_ptr(), inten.data_ptr(), dp.data_ptr(),
        partial.data_ptr(), sums.data_ptr(), b, pmode, nz, n, shared, h_shared,
        int(bool(probe_kspace)), float(dp_pow), float(eps),
        bf16_operands=bf16_operands, n=n)
    _count(loss_sums_fwd_cuda, h_shared, nz, bf16_operands=bf16_operands, n=n)
    return sums[0], sums[1], dp


loss_sums_fwd_cuda.launches = loss_sums_fwd_cuda.launches_h_each = 0
loss_sums_fwd_cuda.launches_nz1 = 0
loss_sums_fwd_cuda.launches_bf16 = loss_sums_fwd_cuda.launches_bf16_dh = 0


def loss_sums_bwd_cuda(obja_p, objp_p, probe, h, meas_cc, mask, dp, c, dp_pow: float,
                       eps: float, probe_kspace: bool, need_dh: bool = False,
                       bf16_operands: bool = False):
    """Kernel B3b: recomputes the chain and walks it back. c is the upstream
    cotangent of s1 (a device scalar). Returns (d obja_p, d objp_p, d probe,
    d h), d h None unless need_dh."""
    b, nz, n, pmode, shared, h_shared = _shape_info(obja_p, probe, h)
    _check("loss_sums_bwd_cuda",
           _inputs(obja_p, objp_p, probe, h, meas_cc=meas_cc, mask=mask, dp=dp, c=c))
    if tuple(dp.shape) != (b, n, n) or c.numel() != 1:
        raise ValueError("loss_sums_bwd_cuda: dp must be (B, N, N) and c a scalar")
    stack, probe_part = _bwd_scratch(b, pmode, nz, n, probe, shared)
    d_obja = torch.empty_like(obja_p)
    d_objp = torch.empty_like(objp_p)
    d_probe = torch.empty_like(probe)
    kstack, dh_part, d_h = _dh_scratch(b, pmode, nz, n, h, need_dh)
    _build.launch(
        "ptyrad_loss_bwd", obja_p,
        obja_p.data_ptr(), objp_p.data_ptr(), probe.data_ptr(), h.data_ptr(),
        meas_cc.data_ptr(), mask.data_ptr(), dp.data_ptr(), c.data_ptr(), stack.data_ptr(),
        _build.ptr(kstack), _build.ptr(dh_part), _build.ptr(d_h), d_obja.data_ptr(),
        d_objp.data_ptr(), d_probe.data_ptr(), _build.ptr(probe_part), b, pmode, nz, n,
        shared, h_shared, int(bool(probe_kspace)), float(dp_pow), float(eps),
        bf16_operands=bf16_operands, n=n)
    _count(loss_sums_bwd_cuda, h_shared, nz, d_h, bf16_operands, n)
    return d_obja, d_objp, d_probe, d_h


loss_sums_bwd_cuda.launches = loss_sums_bwd_cuda.launches_h_each = 0
loss_sums_bwd_cuda.launches_dh = loss_sums_bwd_cuda.launches_nz1 = 0
loss_sums_bwd_cuda.launches_bf16 = loss_sums_bwd_cuda.launches_bf16_dh = 0


class _LossSumsCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, obja_p, objp_p, probe, h, meas_cc, mask, dp_pow, eps, probe_kspace,
                bf16_operands):
        s1, s2, dp = loss_sums_fwd_cuda(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow, eps,
                                        probe_kspace, bf16_operands)
        ctx.save_for_backward(obja_p, objp_p, probe, h, meas_cc, mask, dp)
        ctx.consts = (dp_pow, eps, probe_kspace)
        ctx.bf16_operands = bf16_operands
        ctx.mark_non_differentiable(s2)
        return s1, s2

    @staticmethod
    def backward(ctx, g1, _g2):
        obja_p, objp_p, probe, h, meas_cc, mask, dp = ctx.saved_tensors
        c = g1.reshape(()).to(torch.float32).contiguous()
        d_obja, d_objp, d_probe, d_h = loss_sums_bwd_cuda(
            obja_p, objp_p, probe, h, meas_cc, mask, dp, c, *ctx.consts,
            need_dh=ctx.needs_input_grad[3], bf16_operands=ctx.bf16_operands)
        return d_obja, d_objp, d_probe, d_h, None, None, None, None, None, None


def multislice_loss_sums_fused(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow: float,
                               eps: float, probe_kspace: bool = False,
                               bf16_operands: bool = False):
    """(s1, s2) of the loss_single data term; see the module docstring.

    As for multislice_dp_fused, both versions give h's cotangent when h
    requires a gradient (B3b's dH half on CUDA).
    """
    if obja_p.device.type == "cpu":
        return loss_sums_plain(obja_p, objp_p, probe, h, meas_cc, mask, dp_pow, eps,
                               probe_kspace, bf16_operands)
    return _LossSumsCuda.apply(obja_p.contiguous(), objp_p.contiguous(), probe.contiguous(),
                               h.contiguous(), meas_cc.contiguous(), mask.contiguous(),
                               float(dp_pow), float(eps), bool(probe_kspace),
                               bool(bf16_operands))
