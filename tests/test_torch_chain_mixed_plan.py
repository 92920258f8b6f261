"""The mixed-radix plans of the segmented chain kernels (B5/B6 at N in
(128, 512] that is not a power of two: ``csrc/chain.cu`` built with
``ops/chain_plan.py``'s plan), checked on the CPU at every such N.

``ChainPlan.reported`` restates what the library compiles; the card-only
suite holds the two equal through its ``ptyrad_chain_plan``. The card runs
the plan; here NumPy follows it. For every N: the row-pass and column-pass
blocks fit an H100 (threads, shared memory, T <= 32 threads a line so that
a row stays inside one warp, at most 32 registers a thread); every element
of a (B, pmode, N, N) field is covered once by each pass in each layout a
thread loads or stores (its points, the spectrum's), for pmode 1 to 8,
lanes past a warp's rows and rows or columns past N idle; every exchange of
a line transform writes each slot once and reads only written slots, the
row pass's padded slots inside the row's line. Then one propagation and
the far-field exit as the kernels order them, line by line in the plan's
layouts: the row pass (T, the forward row transform ``line_dif_mr``, the
spectrum stored where it leaves it), the column pass (the forward column
transform, H gathered with the plan's permutation on both axes over N^2,
the inverse column transform ``line_dit_mr``), the next row pass (the
inverse row transform from the stored spectrum); the exit's row transform
storing frequency f at column (f + N // 2) % N and its column pass storing
row f there too. Each equals NumPy's ifft2(H fft2(.)) and
fftshift(fft2(.)) at rtol 1e-5 of the largest entry (double precision
arithmetic; the only float32 rounding is the twiddle table's
exp(-2 pi i e / N)); at three odd N (135, 243, 509) the exit's adjoint too,
loaded through the same map. Register passes run stage by stage as
mr_stages does, sum passes as mr_sum's direct sums (as matrix products).

Last, with torch: H gathered with the permutation (``kernel_h``) and the
kernels' dH accumulated in that order, returned through the gather's
adjoint, give the natural-order propagation and its dH.
"""

import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ptyrad_tpu_torch.ops import chain as C
from ptyrad_tpu_torch.ops import chain_plan as CP
from ptyrad_tpu_torch.ops.fused_plan import digitrev, pad

NS = [n for n in range(CP.MIN_N, CP.MAX_N + 1) if CP.takes(n)]
ODD_ADJOINT = [135, 243, 509]
PMODES = range(1, 9)
COL_THREAD_LIMIT, ROW_THREAD_LIMIT = 1024, 1024


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The emulation's matrix products in one BLAS thread: parallel test
    workers share the cores, and these products are small."""
    with threadpool_limits(limits=1):
        yield


def _layouts(mp):
    """pos, ok: (passes, T, E) line positions and validity of each pass's
    layout (layout 0 holds a thread's points, the last the spectrum)."""
    lays = [[mp.layout(k, t) for t in range(mp.line_threads)] for k in range(len(mp.passes))]
    return (np.array([[p for p, _ in lay] for lay in lays]),
            np.array([[o for _, o in lay] for lay in lays], bool))


def _table(n):
    """The mixed pair's twiddles as the kernels hold them:
    exp(-2 pi i e / N) for e < N, stored as float32."""
    return np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64).astype(complex)


class Emulator:
    """chain.cu's mixed line transforms for every line of a phase at once.
    Registers are (T, E, lines), a register that holds no point at zero;
    a phase's lines go in and come out as (lines, N)."""

    def __init__(self, n):
        self.plan = CP.chain_plan(n)
        self.mp = self.plan.line
        self.n = n
        self.pos, self.ok = _layouts(self.mp)
        self.table = _table(n)
        self.freq = np.vectorize(lambda p: digitrev(p, self.mp.radices))(self.pos[-1])
        self._maps = {}

    def tw(self, e):
        e = np.asarray(e)
        assert e.min() >= 0 and e.max() < self.n, "a twiddle outside the table"
        return self.table[e]

    def _map(self, pos, ok):
        """(gather, scatter) of a layout: register (t, m) reads line position
        gather[t E + m] (N: the zero pad), position p is held by register
        scatter[p]; each position held by exactly one register."""
        key = (pos.tobytes(), ok.tobytes())
        if key not in self._maps:
            flat_ok = ok.ravel()
            p = pos.ravel()[flat_ok]
            assert np.bincount(p, minlength=self.n).tolist() == [1] * self.n, \
                "a line position held twice or never"
            scatter = np.empty(self.n, int)
            scatter[p] = np.flatnonzero(flat_ok)
            self._maps[key] = (np.where(flat_ok, pos.ravel(), 0), np.flatnonzero(~flat_ok),
                               scatter)
        return self._maps[key]

    def to_regs(self, cols, pos, ok):
        """cols (N, lines) -> registers (T, E, lines) in the layout."""
        gather, empty, _ = self._map(pos, ok)
        v = cols[gather]
        v[empty] = 0.0
        return v.reshape(*pos.shape, cols.shape[1])

    def from_regs(self, v, pos, ok):
        """registers (T, E, lines) -> cols (N, lines)."""
        _, _, scatter = self._map(pos, ok)
        return v.reshape(-1, v.shape[-1])[scatter]

    def store(self, v, k):
        """An exchange's store of layout k into the line's slots (natural
        positions), each slot written once (_map); the row pass's padded
        slot addresses stay distinct and inside the padded row."""
        a = pad(self.pos[k][self.ok[k]], self.mp.pad_shift)
        assert len(np.unique(a)) == self.n and a.max() < self.mp.line
        return self.from_regs(v, self.pos[k], self.ok[k])

    def load(self, slots, k):
        return self.to_regs(slots, self.pos[k], self.ok[k])

    def _stages(self, k, inverse):
        """mr_stages of register pass k on one coset per offset below its
        span, applied to the identity: (span, R, R), the pass's linear map
        of a coset's R points for each offset. Stage s of radix r splits a
        point's index D into (hi, d, lo); forward, the r-point DFT over d,
        then the twiddles W_N^(j q step), j = lo * span + offset; inverse,
        conjugate twiddles first, then the conjugate DFT, stages backwards."""
        mp, n = self.mp, self.n
        r_all, _, span, _, _ = mp.geometry(k)
        radices = mp.passes[k].radices
        x = np.broadcast_to(np.eye(r_all, dtype=complex), (span, r_all, r_all)).copy()
        below = np.arange(span)
        for s in (reversed(range(len(radices))) if inverse else range(len(radices))):
            r, big_s = radices[s], math.prod(radices[s + 1:])
            step = n // (r * big_s * span)
            # (offset, column, hi, d, lo)
            y = x.reshape(span, r_all, r_all // (r * big_s), r, big_s)
            j = np.arange(big_s)[None, :] * span + below[:, None]           # (offset, lo)
            tw = self.tw(j[:, None, :] * np.arange(r)[None, :, None] * step)  # (offset, q, lo)
            tw = tw[:, None, None]
            q = np.arange(r)
            if inverse:
                y = np.einsum("...dl,dq->...ql", y * np.conj(tw),
                              np.exp(2j * np.pi * np.outer(q, q) / r))
            else:
                y = np.einsum("...dl,dq->...ql", y, np.exp(-2j * np.pi * np.outer(q, q) / r)) * tw
            x = y.reshape(span, r_all, r_all)
        return x.transpose(0, 2, 1)  # (offset, output point, input point)

    def reg_pass(self, v, k, inverse):
        """mr_stages on every thread's cosets: coset slot u of thread t
        (coset t + T u, while below the pass's cosets) holds its point D in
        register u + c D; the coset's points go through its offset's map."""
        mp = self.mp
        r_all, _, span, cosets, c = mp.geometry(k)
        tl, e = mp.line_threads, v.shape[1]
        t, u = np.arange(tl), np.arange(c)
        kappa = t[:, None] + tl * u[None, :]
        live = kappa < cosets
        regs = (t[:, None, None] * e + u[None, :, None]
                + c * np.arange(r_all)[None, None, :])[live]           # (live cosets, R)
        maps = self._stages(k, inverse)[kappa[live] % span]            # (live cosets, R, R)
        flat = v.reshape(tl * e, -1).copy()
        flat[regs] = maps @ flat[regs]
        return flat.reshape(v.shape)

    def sum_pass(self, slots, k, inverse):
        """mr_sum: output (h, q, w) of the prime p over span l is
        W_{p l}^(w q) sum_i x(h, i, w) w_p^(q i) (inverse: the conjugate
        transpose), its inputs read from the slots at base + i * span;
        thread t computes positions t + T j."""
        n = self.n
        p, _, span, _, _ = self.mp.geometry(k)
        step, wstep = n // p, n // (p * span)
        y = slots.reshape(n // (p * span), p, span, -1)                 # (h, i, w, lines)
        q, w = np.arange(p), np.arange(span)
        m = self.tw((np.outer(q, q) % p) * step)                        # (q, i)
        tw = self.tw(np.outer(q, w) * wstep)[:, :, None]               # (q, w, 1)
        if inverse:
            out = np.matmul(np.conj(m), (y * np.conj(tw)).reshape(y.shape[0], p, -1))
        else:
            out = np.matmul(m, y.reshape(y.shape[0], p, -1)).reshape(y.shape) * tw
        return self.load(out.reshape(n, -1), k)

    def dif(self, v):
        """line_dif_mr: points layout in, spectrum layout out."""
        passes, slots = self.mp.passes, None
        for k in range(len(passes)):
            if k > 0 or passes[0].sum:
                slots = self.store(v, k - 1 if k > 0 else 0)
                if not passes[k].sum:
                    v = self.load(slots, k)
            v = self.sum_pass(slots, k, False) if passes[k].sum else self.reg_pass(v, k, False)
        return v

    def dit(self, v):
        """line_dit_mr, the conjugate transpose: spectrum layout in, points out."""
        passes, last, slots = self.mp.passes, len(self.mp.passes) - 1, None
        for k in range(last, -1, -1):
            if k < last or passes[k].sum:
                slots = self.store(v, k + 1 if k < last else k)
                if not passes[k].sum:
                    v = self.load(slots, k)
            v = self.sum_pass(slots, k, True) if passes[k].sum else self.reg_pass(v, k, True)
        return v

    # a phase's loads and stores of its lines (lines, N): the points'
    # layout, the spectrum's, or the spectrum's at the far-field exit's
    # places (f + N // 2) % N
    def points(self, lines):
        return self.to_regs(lines.T, self.pos[0], self.ok[0])

    def from_points(self, v):
        return self.from_regs(v, self.pos[0], self.ok[0]).T

    def spectrum(self, lines):
        return self.to_regs(lines.T, self.pos[-1], self.ok[-1])

    def from_spectrum(self, v):
        return self.from_regs(v, self.pos[-1], self.ok[-1]).T

    def shifted(self):
        return (self.freq + self.n // 2) % self.n

    def from_shifted(self, v):
        return self.from_regs(v, self.shifted(), self.ok[-1]).T

    def shifted_regs(self, lines):
        return self.to_regs(lines.T, self.shifted(), self.ok[-1])


def _assert_close(actual, expected):
    scale = float(np.abs(expected).max())
    err = float(np.abs(actual - expected).max())
    assert err <= 1e-5 * scale, f"max abs error {err} > 1e-5 x {scale}"


@pytest.mark.parametrize("n", NS)
def test_plan_fits_the_card(n):
    plan = CP.chain_plan(n)
    mp = plan.line
    assert math.prod(mp.radices) == n
    assert 2 <= plan.line_threads <= 32 and plan.elems <= CP.MAX_ELEMS
    assert mp.exchanges >= 1  # every transform syncs between its loads and its stores
    assert mp.line >= pad(n - 1, mp.pad_shift) + 1
    for pmode in PMODES:
        assert plan.row_threads(pmode) == 32 * min(pmode, 4) <= ROW_THREAD_LIMIT
        assert plan.row_smem(pmode) <= CP.SMEM_LIMIT
    assert plan.col_threads <= COL_THREAD_LIMIT and plan.col_smem <= CP.SMEM_LIMIT
    assert plan.reported(3)[:7] == (n, plan.elems, plan.line_threads, len(mp.passes),
                                    len(mp.radices), 32 // plan.line_threads, 16)


@pytest.mark.parametrize("n", NS)
def test_passes_cover_the_field_once(n):
    """Row pass: block (bx, b), warp g (mode group) walking modes g, g + G,
    ..., lane -> (row line // T, thread t), live while line < rows and the
    row is below N. Column pass: block (cx, p, b), thread -> (column c =
    tid % 16, t = tid // 16), live while the column is below N. In each
    layout every (y, x) is held once; every mode once for pmode 1 ... 8."""
    plan = CP.chain_plan(n)
    pos, ok = _layouts(plan.line)
    tl, rows = plan.line_threads, plan.rows
    lane = np.arange(32)
    line, t = lane // tl, lane % tl
    y = np.arange(plan.row_blocks)[:, None] * rows + line[None, :]       # (bx, lane)
    live = (line[None, :] < rows) & (y < n)
    tid = np.arange(plan.col_threads)
    c, tc = tid % CP.COLS, tid // CP.COLS
    x = np.arange(plan.col_blocks)[:, None] * CP.COLS + c[None, :]       # (cx, tid)
    clive = x < n
    for k in (0, len(plan.line.passes) - 1):
        # rows: (bx, lane, E)
        use = live[..., None] & ok[k][t][None]
        yy = np.broadcast_to(y[..., None], use.shape)[use]
        xx = np.broadcast_to(pos[k][t][None], use.shape)[use]
        assert (np.bincount(yy * n + xx, minlength=n * n) == 1).all()
        # columns: (cx, tid, E)
        use = clive[..., None] & ok[k][tc][None]
        xx = np.broadcast_to(x[..., None], use.shape)[use]
        yy = np.broadcast_to(pos[k][tc][None], use.shape)[use]
        assert (np.bincount(yy * n + xx, minlength=n * n) == 1).all()
    for pmode in PMODES:
        groups = plan.groups(pmode)
        modes = [p for g in range(groups) for p in range(g, pmode, groups)]
        assert sorted(modes) == list(range(pmode))


@pytest.mark.parametrize("n", NS)
def test_emulated_passes_match_numpy(n):
    """One propagation as the kernels order it, with H gathered with the
    plan's permutation, and the far-field exit (module docstring)."""
    em = Emulator(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    tmul = np.exp(1j * rng.uniform(0, 6, (n, n)))
    h = np.exp(1j * rng.uniform(0, 6, (n, n)))
    perm = em.plan.perm
    h_k = h[perm][:, perm]  # kernel_h's gather

    rows = em.dif(em.points(x) * em.points(tmul))           # the row pass, T and the row FFT
    spec = em.from_spectrum(rows)                           # x-spectrum where the FFT left it
    v = em.dif(em.points(spec.T))                           # the column pass: columns as lines
    v = v * em.spectrum(h_k.T) / (n * n)
    field = em.from_points(em.dit(v)).T
    psi = em.from_points(em.dit(em.spectrum(field)))       # the next row pass's pending IFFT
    spec_ref = np.fft.fft2(x * tmul)
    _assert_close(psi, np.fft.ifft2(h * spec_ref))

    exit_rows = em.from_shifted(rows)                       # the exit: kx at (kx + N // 2) % N
    exit_ = em.from_shifted(em.dif(em.points(exit_rows.T))).T
    _assert_close(exit_, np.fft.fftshift(spec_ref))
    if n in ODD_ADJOINT:
        # the exit's adjoint: rows loaded through the same map, the inverse
        # column transform, then the row load through the x map and the
        # inverse row transform
        g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        back = em.from_points(em.dit(em.shifted_regs(g.T))).T
        back = em.from_points(em.dit(em.shifted_regs(back)))
        _assert_close(back, np.conj(np.fft.fft2(np.conj(np.fft.ifftshift(g)))))


@pytest.mark.parametrize("n", NS)
def test_plan_source_and_permutation(n):
    """The spectrum holds every frequency once (perm is a permutation), and
    the generated source names the plan's line, row and padding."""
    plan = CP.chain_plan(n)
    em_freq = [digitrev(p, plan.line.radices) for p in range(n)]
    assert sorted(em_freq) == list(range(n)) and plan.perm.tolist() == em_freq
    src = CP.plan_source(n).splitlines()
    passes = ", ".join(f"regfft::Pass<{str(p.sum).lower()}, {', '.join(map(str, p.radices))}>"
                       for p in plan.line.passes)
    assert src[1] == (f"#define PTYRAD_MIXED_LINE regfft::MixedLine<{n}, {plan.line_threads}, "
                      f"{passes}>")
    assert src[2:] == [f"#define PTYRAD_MIXED_ROW {plan.line.line}",
                       f"#define PTYRAD_MIXED_PAD {plan.line.pad_shift}", '#include "chain.cu"']
    assert CP.plan_source(n, bf16_operands=True).splitlines()[1] == "#define PTYRAD_BF16_OPERANDS 1"


class _PermutedPropagation(torch.autograd.Function):
    """The kernels' propagation ifft2(H fft2(psi)) in their order: the
    spectra at the plan's positions on both axes, H taken as kernel_h gives
    it, dH accumulated in that order as (1/N^2) sum U conj(K) (the column
    pass's sum), psi's cotangent the adjoint propagation with conj(H)."""

    @staticmethod
    def forward(ctx, psi, h_k, perm):
        inv = torch.argsort(perm)
        k = torch.fft.fft2(psi)[..., perm, :][..., perm]            # K at the kernels' positions
        out = torch.fft.ifft2((h_k[:, None] * k)[..., inv, :][..., inv])
        ctx.save_for_backward(k, h_k, perm)
        return out

    @staticmethod
    def backward(ctx, g):
        k, h_k, perm = ctx.saved_tensors
        inv = torch.argsort(perm)
        n = g.shape[-1]
        u = torch.fft.fft2(g)[..., perm, :][..., perm] / (n * n)   # ifft2's adjoint, in order
        d_h = (u * k.conj()).sum(dim=(0, 1) if h_k.shape[0] == 1 else 1)  # modes (and samples)
        d_psi = torch.fft.ifft2((h_k[:, None].conj() * u * n * n)[..., inv, :][..., inv])
        return d_psi, d_h.reshape(h_k.shape), None


@pytest.mark.parametrize("n,h_b", [(135, 1), (136, 2), (192, 2), (509, 1)])
def test_permuted_h_and_dh_match_natural_order(n, h_b):
    """H gathered by kernel_h, the propagation and its dH computed in the
    kernels' order, dH returned through the gather's adjoint: the same
    values and the same dH (and d psi) as the natural-order computation."""
    gen = torch.Generator().manual_seed(n)
    psi = torch.randn((2, 3, n, n), dtype=torch.complex128, generator=gen)
    h = torch.exp(1j * 6 * torch.rand((h_b, n, n), dtype=torch.float64, generator=gen))
    g = torch.randn((2, 3, n, n), dtype=torch.complex128, generator=gen)
    perm = torch.as_tensor(CP.chain_plan(n).perm)

    leaves = [psi.clone().requires_grad_(True), h.clone().requires_grad_(True)]
    out = _PermutedPropagation.apply(leaves[0], C.kernel_h(leaves[1]), perm)
    d_psi, d_h = torch.autograd.grad(out, leaves, grad_outputs=g)
    ref_leaves = [psi.clone().requires_grad_(True), h.clone().requires_grad_(True)]
    ref = torch.fft.ifft2(ref_leaves[1][:, None] * torch.fft.fft2(ref_leaves[0]))
    r_psi, r_h = torch.autograd.grad(ref, ref_leaves, grad_outputs=g)
    for a, b in ((out, ref), (d_psi, r_psi), (d_h, r_h)):
        a, b = a.detach(), b.detach()
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * float(b.abs().max()))
    assert torch.equal(C.kernel_h(h), h[:, perm][:, :, perm])


def test_plan_rejects_other_sizes():
    """The mixed plan serves (128, 512] without the powers of two; the
    kernels' rule and set-up take those N and the powers of two, and refuse
    any other before they touch a device."""
    for n in (64, 96, 128, 256, 512, 513, 1024):
        with pytest.raises(ValueError, match="not a power of two"):
            CP.chain_plan(n)
    for n in (96, 127, 513, 640):
        assert not C.takes_n(n)
        with pytest.raises(ValueError, match=r"or lie in \(128, 512\]"):
            C.prepare("cpu", n)
    assert all(C.takes_n(n) for n in [2, 64, 256, 512] + NS)
