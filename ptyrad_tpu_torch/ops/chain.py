"""Segmented multislice chain: the wavefield walks the object slices in
segments of Sg slices (kernels B5 and B6).

Counterpart of ptyrad_tpu/ops/pallas_chain.py, the path for patches too
large for the loss-folded chain (B3 holds a whole wavefield in one block's
shared memory, N <= 128): the PSO regime, 256^2 patches and 21 slices. For
each sample b and probe mode p, slice z of a segment does

    chi = psi * a_z exp(i phi_z);   psi = ifft2(H fft2(chi))

except that the chain's final slice does not propagate (``last`` /
``last_mega``).

- ``chain_segment`` (B5): one segment. Its backward rebuilds the segment's
  slice-entry states from the saved entry wavefield and walks back. With
  ``far_field`` (needs ``last``) the kernel ends in the detector-plane
  transform: its exit is fftshift(fft2(chi)), unnormalised, and its backward
  starts with that transform's adjoint.
- ``chain_stack`` (B6): S uniform segments in one call per direction. The
  forward keeps only the segment-entry wavefields; the backward walks the
  segments in reverse, rebuilding each from its stacked entry. With no
  gradient wanted it runs B5 segment by segment and keeps no stack.
- ``multislice_dp_chain``: the composition, B6 over the uniform segments and B5
  for the tail, then the far-field intensity: through torch.fft by default,
  through B5's own exit after ``set_far_field(True)``.

H is shared (1, N, N) or per position (B, N, N). When H requires a
gradient (optimizable slice thickness or tilts: need_dh), each backward
also returns its cotangent dH in H's shape; autograd sums the calls'.

On a CPU tensor every wrapper runs its plain version (torch.fft under
autograd). On a CUDA tensor it launches the hand-written kernels of
``csrc/chain.cu`` (B5b and B6b compute dH only when autograd asks for it)
or raises. The kernels take every square N that is a power of two up to
512 (chain.cu's Stockham plans, in the main library) or lies in (128, 512]
(the mixed-radix pair with the plan of ``ops/chain_plan.py``, a library of
its own per N, built at its first use or by ``prepare``). They move the
field through device memory in a row pass and a column pass per slice;
tests/test_torch_chain_plan.py and tests/test_torch_chain_mixed_plan.py
emulate how each pass transforms its lines. At a mixed N the mixed-radix
transforms leave the spectra in the plan's digit-reversed order, so the
kernels take H gathered with its permutation on both axes (``kernel_h``,
under autograd: dH comes back in natural order through the gather's
adjoint); a Bluestein plan (N with a prime factor above 7 where its cost
wins) leaves them in natural order and takes H as it is.

``bf16_operands`` (the bfloat16 compute policy, models/state.py) rounds the
operand of every 1-D transform pass to bfloat16, forward and adjoint, the
far-field exit's and multislice_dp_chain's torch.fft far field included, as
the JAX chain's ``gemm_dtype`` does: on the CPU through ops/fourier.py's
rounded passes in the kernels' order, on CUDA through the kernels of
``csrc/chain_bf16.cu`` (chain.cu compiled with the rounding on; the
``_bf16`` entry points). Everything else stays float32.
"""

from __future__ import annotations

import torch

from ptyrad_tpu_torch.ops import _build, chain_plan
from ptyrad_tpu_torch.ops.fourier import fft2, fftshift2, ifft2
from ptyrad_tpu_torch.ops.fused_plan import is_pow2

MAX_N = 512   # the power-of-two plans go up to three passes of 16, 16, 2; the mixed ones to 511
MAX_SG = 8    # the JAX planner's search range (pallas_chain.py:1236)


def takes_n(n: int) -> bool:
    """Whether the kernels take N-point lines: N a power of two in [2, 512]
    or any N in (128, 512]."""
    return (2 <= n <= MAX_N and is_pow2(n)) or chain_plan.takes(n)


def _size_error(what: str, n: int) -> ValueError:
    return ValueError(f"{what}: N must be a power of two in [2, {MAX_N}] or lie in "
                      f"({chain_plan.MIN_N - 1}, {MAX_N}], got {n}")


def prepare(device, n: int) -> None:
    """Do the float32 kernels' one-time set-up for N-point fields on a CUDA
    device (the twiddle tables and the blocks' shared-memory limits; at a
    mixed N first the build of its library). The first launch at each N
    does it otherwise (the _bf16 twins' always so); after it no launch does
    any, so call it for every N before capturing launches in a CUDA graph."""
    if not takes_n(n):
        raise _size_error("prepare", n)
    _build.launch("ptyrad_chain_prepare", torch.empty(0, device=device), n, stream=False, n=n)


_PERMS = {}  # (N, device) -> the mixed plan's permutation on the device


def kernel_h(h):
    """H (1 or B, N, N) as the kernels take it: as given at N a power of two
    or with a Bluestein plan (natural order in and out of every transform);
    at any other mixed N gathered with the plan's permutation on both axes,
    H[:, perm][:, :, perm], where the transforms leave frequency perm[p] at
    position p. Differentiable: the gather's adjoint puts the kernels' dH
    back in natural order."""
    n = h.shape[-1]
    if is_pow2(n) or chain_plan.chain_plan(n).bluestein:
        return h
    key = (n, h.device)
    if key not in _PERMS:
        _PERMS[key] = torch.as_tensor(chain_plan.chain_plan(n).perm, device=h.device)
    perm = _PERMS[key]
    return h.index_select(-2, perm).index_select(-1, perm)


# In-kernel far-field exit of the chain's tail (pallas_chain.py:734). Off by
# default, as in the JAX package, whose reason is a TPU measurement; PERF.md
# holds what the exit costs on the card.
_FAR_FIELD = False


def set_far_field(flag: bool, silent: bool = False) -> None:
    """Switch the in-kernel far-field exit of the chain's tail on or off
    (pallas_chain.py:738). multislice_dp_chain reads the flag at every call:
    eager PyTorch traces nothing, so a toggle always takes effect and never
    warns. ``silent`` is kept for the JAX signature only."""
    global _FAR_FIELD
    _FAR_FIELD = bool(flag)


def chain_applicable_shapes(b, omode, nz, ny, nx, pmode, h_b) -> bool:
    """The card's rule for what the chain kernels take: square N x N with N
    a power of two up to 512 or any N in (128, 512] (takes_n), and a shared
    or per-position propagator. Any omode (multislice_dp_chain loops object
    modes), any nz (that is the point), any pmode. N <= 128 that is not a
    power of two is left out: no route reaches it, since the fused kernels
    take every square N up to 128 first."""
    return ny == nx and takes_n(nx) and h_b in (1, b)


def best_sg(nz: int) -> int:
    """Segment length: the largest sg <= 8, the JAX planner's search range.
    On this card device memory bounds nothing at PSO (the backward's
    rebuilt states are 8 x 64 MiB), so no planner is needed. At nz = 21 it
    gives 21 = 2 x 8 + 5: B6 covers 16 slices and B5 the 5-slice tail, and
    all four kernels run in every training step."""
    return min(nz, MAX_SG)


def _check_far_field(far_field: bool, last: bool) -> None:
    if far_field and not last:
        raise ValueError("far_field requires last=True")


def chain_segment_plain(psi, a_seg, p_seg, h, last: bool, far_field: bool = False,
                        bf16_operands: bool = False):
    """The plain version of B5: psi (B, pmode, N, N) complex64; a_seg, p_seg
    (B, Sg, N, N) float32; h (1 or B, N, N) complex64 corner-centred.
    Returns the exit wavefield (B, pmode, N, N), or with ``far_field`` its
    centred spectrum fftshift(fft2(.)), unnormalised. bf16_operands: every
    transform pass rounds its operand (and its cotangent) to bfloat16."""
    _check_far_field(far_field, last)
    ops = bf16_operands
    hb = h[:, None]
    sg = a_seg.shape[1]
    for s in range(sg):
        psi = psi * torch.polar(a_seg[:, s], p_seg[:, s])[:, None]
        if not (last and s == sg - 1):
            psi = ifft2(hb * fft2(psi, bf16_operands=ops), bf16_operands=ops)
    return fftshift2(fft2(psi, bf16_operands=ops)) if far_field else psi


def chain_stack_plain(psi0, a_main, p_main, h, sg: int, last_mega: bool,
                      bf16_operands: bool = False):
    """The plain version of B6: nz_main / sg segments of sg slices."""
    nz_main = a_main.shape[1]
    _check_uniform(nz_main, sg)
    psi = psi0
    for z0 in range(0, nz_main, sg):
        psi = chain_segment_plain(psi, a_main[:, z0:z0 + sg], p_main[:, z0:z0 + sg], h,
                                  last_mega and z0 + sg >= nz_main,
                                  bf16_operands=bf16_operands)
    return psi


def _check_uniform(nz_main: int, sg: int) -> None:
    if sg < 1 or nz_main % sg:
        raise ValueError(f"chain_stack: nz_main ({nz_main}) must be a multiple of sg ({sg}); "
                         "route the ragged tail through chain_segment")


# -- the CUDA kernels ---------------------------------------------------------

def _dims(psi, a, p, h, nslices):
    """Validate the kernels' operands; returns (B, pmode, N, h_shared)."""
    if psi.dim() != 4 or psi.shape[-1] != psi.shape[-2]:
        raise ValueError(f"psi must be (B, pmode, N, N), got {tuple(psi.shape)}")
    b, pmode, n, _ = psi.shape
    if not takes_n(n):
        raise _size_error("the chain kernels", n)
    for name, t, dtype in (("psi", psi, torch.complex64), ("h", h, torch.complex64),
                           ("a", a, torch.float32), ("phi", p, torch.float32)):
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"chain kernels: {name} must be a CUDA {dtype} tensor, "
                             f"got {t.dtype} on {t.device}")
    if not psi.is_contiguous() or not h.is_contiguous():
        raise ValueError("chain kernels: psi and h must be contiguous")
    if tuple(h.shape) not in ((1, n, n), (b, n, n)):
        raise ValueError(f"h must be (1 or {b}, {n}, {n}), got {tuple(h.shape)}")
    for name, t in (("a", a), ("phi", p)):
        # slices of a (B, omode, Nz, N, N) patch tensor: any batch stride, the
        # slices adjacent and each N x N plane contiguous
        if (tuple(t.shape) != (b, nslices, n, n) or t.stride()[2:] != (n, 1)
                or (nslices > 1 and t.stride(1) != n * n) or t.stride(0) != a.stride(0)):
            raise ValueError(f"chain kernels: {name} must be (B, {nslices}, N, N) with "
                             f"contiguous slices and a's batch stride, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    return b, pmode, n, int(h.shape[0] == 1)


def _bwd_scratch(g, sg, h, need_dh):
    """(scratch, work, kscr, dh_part, dh) of a backward launch: the rebuilt
    slice-entry states (sg - 1 fields like g) and one working field; with
    need_dh the K of each slice (sg fields), the per-(sample, mode) dH
    partials (one field) and dH in h's shape, else three Nones."""
    field = lambda k: torch.empty((k, *g.shape), dtype=g.dtype, device=g.device)  # noqa: E731
    scratch, work = field(sg - 1), torch.empty_like(g)
    if not need_dh:
        return scratch, work, None, None, None
    return scratch, work, field(sg), torch.empty_like(g), torch.empty_like(h)


def _count_n(fn, n: int, **flags) -> None:
    """At a mixed N, launches_n<N> counts fn's launches at that N (its own
    library's kernels) and launches_n<N>_<flag> those with each flag set
    (dh, ff, bf16)."""
    if is_pow2(n):
        return
    for key in [f"launches_n{n}"] + [f"launches_n{n}_{k}" for k, on in flags.items() if on]:
        setattr(fn, key, getattr(fn, key, 0) + 1)


def _count_bwd(fn, d_h, bf16_operands: bool, n: int, far_field: bool = False) -> None:
    """One launch of a backward; launches_dh counts those that computed dH,
    launches_bf16 those with bfloat16 operands, launches_bf16_dh both; per
    mixed N as _count_n."""
    fn.launches += 1
    if d_h is not None:
        fn.launches_dh += 1
    if bf16_operands:
        fn.launches_bf16 += 1
        fn.launches_bf16_dh += d_h is not None
    _count_n(fn, n, dh=d_h is not None, ff=far_field, bf16=bf16_operands)


def segment_fwd_cuda(psi, a_seg, p_seg, h, last: bool, far_field: bool = False,
                     bf16_operands: bool = False):
    """Kernel B5a: the segment's exit wavefield, or with ``far_field`` its
    centred spectrum; h as kernel_h gives it. launches_ff counts the
    launches that took the exit, launches_bf16 those with bfloat16 operands,
    launches_ff_bf16 both; per mixed N as _count_n."""
    _check_far_field(far_field, last)
    sg = a_seg.shape[1]
    b, pmode, n, h_shared = _dims(psi, a_seg, p_seg, h, sg)
    out = torch.empty_like(psi)
    _build.launch(
        "ptyrad_chain_segment_fwd", psi,
        psi.data_ptr(), a_seg.data_ptr(), p_seg.data_ptr(), a_seg.stride(0), h.data_ptr(),
        out.data_ptr(), b, pmode, sg, n, h_shared, int(bool(last)), int(bool(far_field)),
        bf16_operands=bf16_operands, n=n)
    segment_fwd_cuda.launches += 1
    segment_fwd_cuda.launches_ff += bool(far_field)
    segment_fwd_cuda.launches_bf16 += bool(bf16_operands)
    segment_fwd_cuda.launches_ff_bf16 += bool(far_field and bf16_operands)
    _count_n(segment_fwd_cuda, n, ff=far_field, bf16=bf16_operands)
    return out


segment_fwd_cuda.launches = segment_fwd_cuda.launches_ff = 0
segment_fwd_cuda.launches_bf16 = segment_fwd_cuda.launches_ff_bf16 = 0


def segment_bwd_cuda(g, psi, a_seg, p_seg, h, last: bool, need_dh: bool = False,
                     far_field: bool = False, bf16_operands: bool = False):
    """Kernel B5b: from the exit cotangent g (of the centred spectrum with
    ``far_field``), (d psi, d a_seg, d p_seg, d h), d h None unless need_dh
    (in h's order: h as kernel_h gives it)."""
    _check_far_field(far_field, last)
    sg = a_seg.shape[1]
    b, pmode, n, h_shared = _dims(psi, a_seg, p_seg, h, sg)
    if tuple(g.shape) != tuple(psi.shape) or g.dtype != psi.dtype or not g.is_contiguous():
        raise ValueError("segment_bwd_cuda: g must be a contiguous tensor like psi")
    scratch, work, kscr, dh_part, d_h = _bwd_scratch(g, sg, h, need_dh)
    d_psi = torch.empty_like(psi)
    d_a = torch.empty(a_seg.shape, dtype=torch.float32, device=psi.device)
    d_p = torch.empty_like(d_a)
    _build.launch(
        "ptyrad_chain_segment_bwd", g,
        g.data_ptr(), psi.data_ptr(), a_seg.data_ptr(), p_seg.data_ptr(), a_seg.stride(0),
        h.data_ptr(), scratch.data_ptr(), work.data_ptr(), _build.ptr(kscr),
        _build.ptr(dh_part), _build.ptr(d_h), d_a.data_ptr(), d_p.data_ptr(), d_psi.data_ptr(),
        b, pmode, sg, n, h_shared, int(bool(last)), int(bool(far_field)),
        bf16_operands=bf16_operands, n=n)
    _count_bwd(segment_bwd_cuda, d_h, bf16_operands, n, far_field)
    if far_field:  # launches_ff: the exit's adjoint ran; launches_ff_dh: with dH too
        segment_bwd_cuda.launches_ff += 1
        segment_bwd_cuda.launches_ff_dh += d_h is not None
    return d_psi, d_a, d_p, d_h


segment_bwd_cuda.launches = segment_bwd_cuda.launches_dh = 0
segment_bwd_cuda.launches_ff = segment_bwd_cuda.launches_ff_dh = 0
segment_bwd_cuda.launches_bf16 = segment_bwd_cuda.launches_bf16_dh = 0


def stack_fwd_cuda(psi0, a_main, p_main, h, sg: int, last_mega: bool,
                   bf16_operands: bool = False):
    """Kernel B6a: (exit wavefield, segment-entry stack (B, S, pmode, N, N));
    h as kernel_h gives it."""
    nz_main = a_main.shape[1]
    _check_uniform(nz_main, sg)
    b, pmode, n, h_shared = _dims(psi0, a_main, p_main, h, nz_main)
    n_seg = nz_main // sg
    stack = torch.empty((b, n_seg, *psi0.shape[1:]), dtype=psi0.dtype, device=psi0.device)
    out = torch.empty_like(psi0)
    _build.launch(
        "ptyrad_chain_stack_fwd", psi0,
        psi0.data_ptr(), a_main.data_ptr(), p_main.data_ptr(), a_main.stride(0), h.data_ptr(),
        stack.data_ptr(), out.data_ptr(), b, pmode, n_seg, sg, n, h_shared,
        int(bool(last_mega)),
        bf16_operands=bf16_operands, n=n)
    stack_fwd_cuda.launches += 1
    stack_fwd_cuda.launches_bf16 += bool(bf16_operands)
    _count_n(stack_fwd_cuda, n, bf16=bf16_operands)
    return out, stack


stack_fwd_cuda.launches = stack_fwd_cuda.launches_bf16 = 0


def stack_bwd_cuda(g, stack, a_main, p_main, h, sg: int, last_mega: bool,
                   need_dh: bool = False, bf16_operands: bool = False):
    """Kernel B6b: from the exit cotangent g and B6a's stack,
    (d psi0, d a_main, d p_main, d h), d h None unless need_dh."""
    nz_main = a_main.shape[1]
    _check_uniform(nz_main, sg)
    n_seg = nz_main // sg
    if stack.dim() != 5 or stack.shape[1] != n_seg or not stack.is_contiguous():
        raise ValueError(f"stack_bwd_cuda: stack must be a contiguous (B, {n_seg}, pmode, N, N)")
    b, pmode, n, h_shared = _dims(g, a_main, p_main, h, nz_main)
    if tuple(stack[:, 0].shape) != tuple(g.shape) or stack.dtype != g.dtype:
        raise ValueError("stack_bwd_cuda: each stack entry must be shaped like g")
    scratch, work, kscr, dh_part, d_h = _bwd_scratch(g, sg, h, need_dh)
    d_psi0 = torch.empty_like(g)
    d_a = torch.empty(a_main.shape, dtype=torch.float32, device=g.device)
    d_p = torch.empty_like(d_a)
    _build.launch(
        "ptyrad_chain_stack_bwd", g,
        g.data_ptr(), stack.data_ptr(), a_main.data_ptr(), p_main.data_ptr(), a_main.stride(0),
        h.data_ptr(), scratch.data_ptr(), work.data_ptr(), _build.ptr(kscr),
        _build.ptr(dh_part), _build.ptr(d_h), d_a.data_ptr(), d_p.data_ptr(), d_psi0.data_ptr(),
        b, pmode, n_seg, sg, n, h_shared, int(bool(last_mega)),
        bf16_operands=bf16_operands, n=n)
    _count_bwd(stack_bwd_cuda, d_h, bf16_operands, n)
    return d_psi0, d_a, d_p, d_h


stack_bwd_cuda.launches = stack_bwd_cuda.launches_dh = 0
stack_bwd_cuda.launches_bf16 = stack_bwd_cuda.launches_bf16_dh = 0


class _SegmentCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi, a_seg, p_seg, h, last, far_field, bf16_operands):
        ctx.save_for_backward(psi, a_seg, p_seg, h)
        ctx.consts = (last, far_field, bf16_operands)
        return segment_fwd_cuda(psi, a_seg, p_seg, h, last, far_field, bf16_operands)

    @staticmethod
    def backward(ctx, g):
        psi, a_seg, p_seg, h = ctx.saved_tensors
        last, far_field, bf16_operands = ctx.consts
        d_psi, d_a, d_p, d_h = segment_bwd_cuda(g.contiguous(), psi, a_seg, p_seg, h, last,
                                                ctx.needs_input_grad[3], far_field,
                                                bf16_operands)
        return d_psi, d_a, d_p, d_h, None, None, None


class _StackCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi0, a_main, p_main, h, sg, last_mega, bf16_operands):
        out, stack = stack_fwd_cuda(psi0, a_main, p_main, h, sg, last_mega, bf16_operands)
        ctx.save_for_backward(stack, a_main, p_main, h)
        ctx.consts = (sg, last_mega)
        ctx.bf16_operands = bf16_operands
        return out

    @staticmethod
    def backward(ctx, g):
        stack, a_main, p_main, h = ctx.saved_tensors
        d_psi0, d_a, d_p, d_h = stack_bwd_cuda(g.contiguous(), stack, a_main, p_main, h,
                                               *ctx.consts, need_dh=ctx.needs_input_grad[3],
                                               bf16_operands=ctx.bf16_operands)
        return d_psi0, d_a, d_p, d_h, None, None, None


def chain_segment(psi, a_seg, p_seg, h, last: bool, far_field: bool = False,
                  bf16_operands: bool = False):
    """Advance psi (B, pmode, N, N) through one segment of Sg slices (a_seg,
    p_seg (B, Sg, N, N)); see the module docstring. B5 on CUDA. With
    ``far_field`` (needs ``last``) the exit is the centred detector-plane
    spectrum, unnormalised."""
    _check_far_field(far_field, last)
    if psi.device.type == "cpu":
        return chain_segment_plain(psi, a_seg, p_seg, h, last, far_field, bf16_operands)
    return _SegmentCuda.apply(psi.contiguous(), a_seg, p_seg, kernel_h(h.contiguous()),
                              bool(last), bool(far_field), bool(bf16_operands))


def chain_stack(psi0, a_main, p_main, h, sg: int, last_mega: bool,
                bf16_operands: bool = False):
    """Advance psi0 through nz_main / sg uniform segments; B6 on CUDA when a
    gradient is wanted. ``last_mega`` is False when a ragged chain_segment
    tail follows. With no gradient wanted this runs chain_segment segment by
    segment: B6's forward writes the backward's stack, which nothing would
    read."""
    _check_uniform(a_main.shape[1], sg)
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (psi0, a_main, p_main, h))
    if not wants_grad:
        nz_main = a_main.shape[1]
        psi = psi0
        for z0 in range(0, nz_main, sg):
            psi = chain_segment(psi, a_main[:, z0:z0 + sg], p_main[:, z0:z0 + sg], h,
                                last_mega and z0 + sg >= nz_main, bf16_operands=bf16_operands)
        return psi
    if psi0.device.type == "cpu":
        return chain_stack_plain(psi0, a_main, p_main, h, sg, last_mega, bf16_operands)
    return _StackCuda.apply(psi0.contiguous(), a_main, p_main, kernel_h(h.contiguous()),
                            int(sg), bool(last_mega), bool(bf16_operands))


def multislice_dp_chain(obja_patches, objp_patches, probes, H, omode_occu, eps: float,
                        seg_override: int | None = None, bf16_operands: bool = False):
    """Far-field intensity (B, N, N), centred, with the omode_occu weights
    and eps, through the segmented chain: a drop-in for multislice_dp.

    obja/objp_patches (B, omode, Nz, N, N); probes (1 or B, pmode, N, N);
    H (1 or B, N, N). Object modes are independent chains summed
    incoherently; the uniform segments run as chain_stack, the ragged tail
    as chain_segment; the far-field fft2, the mode sum and fftshift are
    plain torch, as in the JAX package where they sit outside the kernels.
    After set_far_field(True) the chain always ends in a chain_segment whose
    kernel does the detector transform itself (a full segment is carved off
    chain_stack when nz is a multiple of sg), and only |Y|^2 / N^2 and the
    mode sums stay in torch.
    When H requires a gradient (the JAX package's need_dh), both versions
    give its cotangent: the plain one through autograd, B5b/B6b through
    their dH halves. bf16_operands: the bfloat16 compute policy, in the
    kernels and in the torch.fft far field (pallas_chain.py:1345).
    """
    b, omode, nz, n, _ = obja_patches.shape
    sg = seg_override or best_sg(nz)
    psi0 = probes.expand(b, *probes.shape[1:])
    n_seg_uniform = nz // sg
    nz_main = n_seg_uniform * sg if n_seg_uniform >= 2 else 0
    use_ff = _FAR_FIELD
    if use_ff and nz_main == nz:
        nz_main -= sg  # keep a full tail segment for the exit (chain_stack may run S = 1)

    dp = None
    for om in range(omode):
        psi, z0 = psi0, 0
        if nz_main:
            psi = chain_stack(psi, obja_patches[:, om, :nz_main], objp_patches[:, om, :nz_main],
                              H, sg, nz_main == nz, bf16_operands)
            z0 = nz_main
        while z0 < nz:
            z1 = min(z0 + sg, nz)
            psi = chain_segment(psi, obja_patches[:, om, z0:z1], objp_patches[:, om, z0:z1], H,
                                z1 == nz, use_ff and z1 == nz, bf16_operands)
            z0 = z1
        if use_ff:  # psi is the centred spectrum, unnormalised
            inten = (psi.real ** 2 + psi.imag ** 2).sum(1) * (1.0 / (n * n))
        else:
            y = fft2(psi, norm="ortho", bf16_operands=bf16_operands)
            inten = (y.real ** 2 + y.imag ** 2).sum(1)
        contrib = omode_occu[om] * inten
        dp = contrib if dp is None else dp + contrib
    if not use_ff:
        # fftshift is a fixed permutation: one roll of the mode sum
        dp = fftshift2(dp)
    return dp + eps
