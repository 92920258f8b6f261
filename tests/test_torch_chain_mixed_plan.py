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
mr_stages does.

Last, with torch: H gathered with the permutation (``kernel_h``) and the
kernels' dH accumulated in that order, returned through the gather's
adjoint, give the natural-order propagation and its dH.
"""

import hashlib
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


def _f32(z):
    """A table rounded once to float32, as the library uploads it."""
    return np.asarray(z).astype(np.complex64).astype(complex)


class LineEmulator:
    """The mixed-radix pair of a MixedPlan (its own size: N, or a Bluestein
    line's M) for every line of a phase at once. Registers are (T, E,
    lines), a register that holds no point at zero."""

    def __init__(self, mp):
        self.mp = mp
        self.n = mp.n
        self.pos, self.ok = _layouts(mp)
        self.table = _table(self.n)
        self._maps = {}

    def tw(self, e):
        e = np.asarray(e)
        assert e.min() >= 0 and e.max() < self.n, "a twiddle outside the table"
        return self.table[e]

    def _map(self, pos, ok, size):
        """(gather, scatter) of a layout of ``size`` positions: register
        (t, m) reads line position gather[t E + m] (N: the zero pad),
        position p is held by register scatter[p]; each position held by
        exactly one register."""
        key = (pos.tobytes(), ok.tobytes(), size)
        if key not in self._maps:
            flat_ok = ok.ravel()
            p = pos.ravel()[flat_ok]
            assert np.bincount(p, minlength=size).tolist() == [1] * size, \
                "a line position held twice or never"
            scatter = np.empty(size, int)
            scatter[p] = np.flatnonzero(flat_ok)
            self._maps[key] = (np.where(flat_ok, pos.ravel(), 0), np.flatnonzero(~flat_ok),
                               scatter)
        return self._maps[key]

    def to_regs(self, cols, pos, ok):
        """cols (size, lines) -> registers (T, E, lines) in the layout."""
        gather, empty, _ = self._map(pos, ok, cols.shape[0])
        v = cols[gather]
        v[empty] = 0.0
        return v.reshape(*pos.shape, cols.shape[1])

    def from_regs(self, v, pos, ok, size=None):
        """registers (T, E, lines) -> cols (size, lines)."""
        _, _, scatter = self._map(pos, ok, size or self.n)
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

    def dif(self, v):
        """line_dif_mr: points layout in, spectrum layout out."""
        for k in range(len(self.mp.passes)):
            if k > 0:
                v = self.load(self.store(v, k - 1), k)
            v = self.reg_pass(v, k, False)
        return v

    def dit(self, v):
        """line_dit_mr, the conjugate transpose: spectrum layout in, points out."""
        last = len(self.mp.passes) - 1
        for k in range(last, -1, -1):
            if k < last:
                v = self.load(self.store(v, k + 1), k)
            v = self.reg_pass(v, k, True)
        return v


class Emulator:
    """chain.cu's line transforms at N for every line of a phase at once:
    the mixed-radix pair (LineEmulator), or the Bluestein line (the chirp,
    the M-point forward, the filter, the M-point inverse, the chirp; the
    tables of chain_plan.bluestein_tables rounded to float32, the inverse
    with their conjugates). A phase's lines go in and come out as (lines,
    N), through the plan's layouts of the points and of the spectrum."""

    def __init__(self, n):
        self.plan = CP.chain_plan(n)
        self.line = LineEmulator(self.plan.line)
        self.n = n
        (self.pos0, self.spos), (self.ok0, self.sok) = self.plan.layouts()
        if self.plan.bluestein:
            chirp, filt = (_f32(t) for t in CP.bluestein_tables(n))
            self.chirp = np.where(self.ok0, chirp[np.where(self.ok0, self.pos0, 0)], 0)[..., None]
            lpos, lok = self.line.pos[-1], self.line.ok[-1]
            self.filter = np.where(lok, filt[lpos], 0)[..., None]
            self.freq = self.spos
        else:
            self.freq = np.vectorize(lambda p: digitrev(p, self.plan.line.radices))(self.spos)

    def _bluestein(self, v, inverse):
        chirp = np.conj(self.chirp) if inverse else self.chirp
        filt = np.conj(self.filter) if inverse else self.filter
        v = self.line.dit(self.line.dif(v * chirp) * filt)
        return v * chirp

    def dif(self, v):
        """The forward: points layout in, spectrum layout out."""
        return self._bluestein(v, False) if self.plan.bluestein else self.line.dif(v)

    def dit(self, v):
        """The inverse, the conjugate transpose: spectrum layout in, points out."""
        return self._bluestein(v, True) if self.plan.bluestein else self.line.dit(v)

    # a phase's loads and stores of its lines (lines, N): the points'
    # layout, the spectrum's, or the spectrum's at the far-field exit's
    # places (f + N // 2) % N
    def points(self, lines):
        return self.line.to_regs(lines.T, self.pos0, self.ok0)

    def from_points(self, v):
        return self.line.from_regs(v, self.pos0, self.ok0, self.n).T

    def spectrum(self, lines):
        return self.line.to_regs(lines.T, self.spos, self.sok)

    def from_spectrum(self, v):
        return self.line.from_regs(v, self.spos, self.sok, self.n).T

    def shifted(self):
        return (self.freq + self.n // 2) % self.n

    def from_shifted(self, v):
        return self.line.from_regs(v, self.shifted(), self.sok, self.n).T

    def shifted_regs(self, lines):
        return self.line.to_regs(lines.T, self.shifted(), self.sok)


def _assert_close(actual, expected):
    scale = float(np.abs(expected).max())
    err = float(np.abs(actual - expected).max())
    assert err <= 1e-5 * scale, f"max abs error {err} > 1e-5 x {scale}"


@pytest.mark.parametrize("n", NS)
def test_plan_fits_the_card(n):
    plan = CP.chain_plan(n)
    mp = plan.line
    assert math.prod(mp.radices) == plan.slots and CP.smooth(plan.slots)
    if plan.bluestein:  # a cyclic convolution of 2 N - 1 points or more
        assert plan.slots >= 2 * n - 1 and CP.smooth(plan.slots) and plan.slots <= 1024
    else:
        assert plan.slots == n
    assert plan.bluestein != CP.smooth(n)
    assert 2 <= plan.line_threads <= 32 and plan.elems <= CP.MAX_ELEMS
    assert mp.exchanges >= 1  # every transform syncs between its loads and its stores
    assert mp.line >= pad(plan.slots - 1, mp.pad_shift) + 1
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
    pos, ok = plan.layouts()
    tl, rows = plan.line_threads, plan.rows
    lane = np.arange(32)
    line, t = lane // tl, lane % tl
    y = np.arange(plan.row_blocks)[:, None] * rows + line[None, :]       # (bx, lane)
    live = (line[None, :] < rows) & (y < n)
    tid = np.arange(plan.col_threads)
    c, tc = tid % CP.COLS, tid // CP.COLS
    x = np.arange(plan.col_blocks)[:, None] * CP.COLS + c[None, :]       # (cx, tid)
    clive = x < n
    for k in (0, 1):  # the points' layout, the spectrum's
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


# sha256 of plan_source(N)[:12] for every 7-smooth N in (128, 512] that is
# not a power of two, as they were before the Bluestein candidate: those
# plans, and so their machine code, stay what they were
SMOOTH_SOURCES = {
    135: "024a7defd838", 140: "e0482ce73625", 144: "e2c471589636", 147: "3d702158c4ec",
    150: "6fa7aadc7930", 160: "b3ad3d01acac", 162: "f05012a122d1", 168: "897d3246244f",
    175: "fcdb23595c70", 180: "33dbcfca4351", 189: "9b84435f9524", 192: "be82372cbfdb",
    196: "b83da6250059", 200: "8ab66b74c48e", 210: "c18374aeea96", 216: "80408bab97fb",
    224: "acd484989fa6", 225: "bd60cb51ce59", 240: "7ff48dbdd040", 243: "63b1d354f4e4",
    245: "4643a6f1ee49", 250: "2fcc6dda7e8a", 252: "aae698413a0b", 270: "79a8335f25f0",
    280: "d722e166afd2", 288: "c675cf3683d1", 294: "7175c8efdabb", 300: "01a5067449c3",
    315: "a713e21617dd", 320: "ee13a7e60c55", 324: "02cfd1bb049e", 336: "1ad5e4357a29",
    343: "edd9ca39fcc4", 350: "226269a47b88", 360: "fa888252de7f", 375: "7c6fb25869b0",
    378: "e9d1855b2830", 384: "37b9eef1fa79", 392: "60df3a34251a", 400: "123d75210230",
    405: "fe42f12e35d6", 420: "a73218dcb3e4", 432: "e926799b9a7b", 441: "9d949dfbac3f",
    448: "46d97377a503", 450: "2e042c82187d", 480: "ce06815522f2", 486: "269aaa668589",
    490: "bc743b0148b9", 500: "bfc33530a55c", 504: "5352493a7000",
}


@pytest.mark.parametrize("n", NS)
def test_plan_source_and_permutation(n):
    """The spectrum holds every frequency once (perm is a permutation; a
    Bluestein line's the identity), and the generated source names the
    plan's line, row and padding; a 7-smooth N's source is the one it had
    before the Bluestein candidate."""
    plan = CP.chain_plan(n)
    mp = plan.line
    em_freq = list(range(n)) if plan.bluestein else [digitrev(p, mp.radices) for p in range(n)]
    assert sorted(em_freq) == list(range(n)) and plan.perm.tolist() == em_freq
    src = CP.plan_source(n).splitlines()
    passes = ", ".join(f"regfft::Pass<false, {', '.join(map(str, p.radices))}>"
                       for p in mp.passes)
    line = f"regfft::MixedLine<{mp.n}, {plan.line_threads}, {passes}>"
    if plan.bluestein:
        assert src[1] == "#define PTYRAD_BLUESTEIN 1"
        line = f"regfft::BluesteinLine<{n}, {line}>"
        src = src[:1] + src[2:]
    assert src[1] == f"#define PTYRAD_MIXED_LINE {line}"
    assert src[2:] == [f"#define PTYRAD_MIXED_ROW {mp.line}",
                       f"#define PTYRAD_MIXED_PAD {mp.pad_shift}", '#include "chain.cu"']
    assert CP.plan_source(n, bf16_operands=True).splitlines()[1] == "#define PTYRAD_BF16_OPERANDS 1"
    if CP.smooth(n):
        assert hashlib.sha256(CP.plan_source(n).encode()).hexdigest()[:12] == SMOOTH_SOURCES[n]
    assert (n in SMOOTH_SOURCES) == CP.smooth(n)


@pytest.mark.parametrize("n", [135, 176, 254, 384, 385, 509])
def test_line_adjoint(n):
    """The inverse line transform is the forward's conjugate transpose:
    <F x, y> = <x, F^H y> to 1e-12 in float64 (the float32 tables alike
    in both), at 135 (two register passes), 384 (three), and Bluestein
    lines over three register passes (176 over 360 points, 254 over 512)
    and over two (385 over 784, 509 over 1,024)."""
    em = Emulator(n)
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    y = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    fx = em.from_spectrum(em.dif(em.points(x)))
    fhy = em.from_points(em.dit(em.spectrum(y)))
    lhs, rhs = np.vdot(y, fx), np.vdot(fhy, x)
    assert abs(lhs - rhs) <= 1e-12 * np.linalg.norm(x) * np.linalg.norm(y) * n
    _assert_close(fx, np.fft.fft(x, axis=1)[:, em.plan.perm])


def test_bluestein_plans_and_tables():
    """chain_plan takes the Bluestein line at every N with a prime above
    7, over the least 7-smooth M >= 2 N - 1 that fits (509, a prime, and
    254 = 2 x 127 over 1,024 and 512; 176 = 16 x 11 over 360; 495 over
    1,024, since 1,000 and 1,008 fit no plan), and has no other candidate
    there; the chirp at 509 is exp(-i pi (j^2 mod 2N) / N) rounded once to
    float32, its angle never taken from a float j^2; the filter is the
    spectrum of the conjugate chirp over M, divided by M, in the inner
    forward's digit-reversed order."""
    for n, m in ((509, 1024), (254, 512), (176, 360), (495, 1024)):
        plan = CP.chain_plan(n)
        assert plan.bluestein and plan.slots == m
        assert all(c.bluestein and c.slots == m for c in CP._candidates(n))
    assert all(CP.chain_plan(n).bluestein for n in NS if not CP.smooth(n))
    n = 509
    chirp, filt = CP.bluestein_tables(n)
    j = np.arange(n)
    exact = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    assert np.array_equal(chirp.astype(np.complex64), exact.astype(np.complex64))
    assert np.abs(chirp - np.exp(-1j * np.pi * j.astype(float) ** 2 / n)).max() < 1e-9
    m = CP.chain_plan(n).slots
    g = np.zeros(m, complex)
    g[:n], g[m - n + 1:] = np.conj(exact), np.conj(exact[1:][::-1])
    order = [digitrev(p, CP.chain_plan(n).line.radices) for p in range(m)]
    np.testing.assert_allclose(filt, np.fft.fft(g)[order] / m, rtol=0, atol=1e-12)


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
