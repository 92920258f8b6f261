"""The plans of the fused chain kernels (B3/B4, ``csrc/multislice.cu``),
checked on the CPU at every N = 2 ... 128.

``fused_plan`` restates the plan multislice.cu compiles for N; the
card-only suite holds the two equal through the library's
``ptyrad_fused_plan``. A block holds one (sample, mode) wavefield in shared
memory for the whole chain, its rows padded (element (y, x) at
y * line + pad(x)), and transforms it in a row phase and a column phase.

At N a power of two the radix-2 pair of ``csrc/reg_fft.cuh`` (``line_dif``,
``line_dit``): TL = N / E threads a line, E points each at t + TL * m; the
decimation-in-frequency stages of span N/2 ... TL in registers, one
exchange on the line's own slots of the field (the points stored at
t + TL * m, thread t loading positions E * t + i), the stages of span
TL/2 ... 1; the forward leaves frequency bitrev(E * t + i) in register i
(``dif_freq``), and the inverse, its conjugate transpose, runs the same way
back. In the row phase a row's threads are adjacent lanes of one warp; in
the column phase a warp holds 32 adjacent columns with one t, and a
column's TL warps wait on a named barrier of their own.

At any other 7-smooth N the mixed-radix pair (``line_dif_mr``,
``line_dit_mr``) with the plan of ``ops/fused_plan.py`` (its module
docstring): one stage per prime factor, register passes of radix 2, 3, 5
and 7 on whole cosets, an exchange between passes, frequency
digitrev(position) after the forward; a warp holds 32 // T rows, a column
group T warps, and lanes or lines past N idle. At every N with a prime
factor above 7 a Bluestein line (``BluesteinPlan``): the chirp, an M-point forward
of the same pair, the filter, its inverse, the chirp (the tables of
``fused_plan.bluestein_tables`` rounded to float32; the inverse with their
conjugates), the M-point line's exchanges in a scratch region beside the
field (a padded line for each row in flight, M slots interleaved by column
for each column of a group), the spectrum in natural order in the points'
own layout.

Here, for every N and both blocks: the block fits the card (field and
scratch); each phase covers every element of the field once, in each
layout a thread uses (its points, each pass's layout, its frequencies);
the row phase's warp accesses take the least number of shared-memory
wavefronts (8-byte accesses: one per half-warp that has any, 32 banks of 4
bytes) at every power of two and at N = 96, 120 and 127, and at every other
N the count the plan states (``fused_plan.wavefronts``, the fewest of the
paddings it could take), the scratch's likewise
(``fused_plan.scratch_wavefronts``); the column phase's always take the
least. A thread-by-thread NumPy emulation of one propagation
ifft2(H fft2(.)), its column phase fused (column transform, H / N^2,
inverse column transform), and of the far field fft2(.) equals NumPy's at
rtol 1e-5 of the largest entry (double precision arithmetic; the only
float32 rounding is the tables'): at every power of two, at N = 3, 5, 6, 7,
12, 15, 24, 96, 98, 100, 120 and 125, and at every N with a prime factor
above 7 (104 among them); each exchange writes each of its line's slots once, reads
only what it wrote and touches no other line, a scratch exchange inside
the block's scratch and apart from every other line in flight. The
inverse line is the forward's conjugate transpose to 1e-12, and every
N that takes no Bluestein line has the generated source it had before it.
"""

import dataclasses
import hashlib
import math

import numpy as np
import pytest

from ptyrad_tpu_torch.ops import fused_multislice as M
from ptyrad_tpu_torch.ops import fused_plan as FP

POW2 = [2 ** k for k in range(1, 8)]
NS = list(range(2, M.MAX_N + 1))
LARGE_PRIME = [n for n in NS if not FP.smooth(n)]  # a prime factor above 7
EMULATED = POW2 + [3, 5, 6, 7, 12, 15, 24, 96, 98, 100, 120, 125] + LARGE_PRIME
LEAST_WAVEFRONTS = [96, 120, 127]
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
# multislice.cu kFwdThreads, kBwdThreads: the chain blocks' threads at N = 128
FWD_THREADS, BWD_THREADS = 1024, 512


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How a chain block of multislice.cu holds and transforms an N x N field."""

    n: int
    elems: int          # E: registers of a line a thread holds
    line_threads: int   # TL (T): threads a line
    line: int           # a padded row of the field, in elements
    pad_shift: int      # a row's element a sits at a + (a >> pad_shift)
    threads: int        # the block's threads
    row_sweeps: int     # rows a thread takes in the row phase
    col_sweeps: int     # columns a thread takes in the column phase
    bwd_threads: int    # the same for the backward's block
    bwd_row_sweeps: int
    bwd_col_sweeps: int
    group_threads: int  # a column group (32 adjacent columns): its named barrier's count
    smem: int           # bytes: the padded field (and a Bluestein plan's scratch), forward block
    chunks: int         # B3a's epilogue blocks per sample
    mixed: FP.MixedPlan | FP.BluesteinPlan | None = None  # N not a power of two: the plan

    @property
    def bluestein(self) -> bool:
        return isinstance(self.mixed, FP.BluesteinPlan)


def fused_plan(n: int, backward: bool = False) -> FusedPlan:
    """multislice.cu's plan for N from 2 to M.MAX_N: the forward chain
    block's (threads, sweeps), or with ``backward`` the backward's in their
    place."""
    if not 2 <= n <= M.MAX_N:
        raise ValueError(f"fused_plan: N must be in [2, {M.MAX_N}], got {n}")
    if FP.is_pow2(n):
        elems = min(n, 16)
        line_threads = n // elems
        slots = n * line_threads
        fwd, bwd = min(slots, FWD_THREADS), min(slots, BWD_THREADS)
        line = n + (n // 16 if n >= 16 else 1)
        threads, sweeps = (bwd, slots // bwd) if backward else (fwd, slots // fwd)
        return FusedPlan(
            n=n, elems=elems, line_threads=line_threads, line=line, pad_shift=4,
            threads=threads, row_sweeps=sweeps, col_sweeps=sweeps, bwd_threads=bwd,
            bwd_row_sweeps=slots // bwd, bwd_col_sweeps=slots // bwd,
            group_threads=32 * line_threads, smem=8 * n * line, chunks=min(n, 16))
    mp = FP.mixed_plan(n)
    fwd, bwd = mp.block(FWD_THREADS), mp.block(BWD_THREADS)
    blk = bwd if backward else fwd
    return FusedPlan(
        n=n, elems=mp.elems, line_threads=mp.line_threads, line=mp.line, pad_shift=mp.pad_shift,
        threads=blk.threads, row_sweeps=blk.row_sweeps, col_sweeps=blk.col_sweeps,
        bwd_threads=bwd.threads, bwd_row_sweeps=bwd.row_sweeps, bwd_col_sweeps=bwd.col_sweeps,
        group_threads=32 * mp.line_threads, smem=mp.smem, chunks=min(n, 16), mixed=mp)


def pad(plan, a):
    return a + (np.asarray(a) >> plan.pad_shift)


def bitrev(k, bits):
    return int(format(int(k), f"0{bits}b")[::-1], 2) if bits else 0


def dif_freq(plan, t, i):
    """reg_fft.cuh dif_freq: the frequency line_dif leaves in register i of
    thread t, bitrev(E t + i)."""
    e_bits, t_bits = plan.elems.bit_length() - 1, plan.line_threads.bit_length() - 1
    return bitrev(i, e_bits) * plan.line_threads + bitrev(t, t_bits)


def layouts(plan, t):
    """Thread t's registers in each layout: {kind: (line positions, valid)}.
    A power of two: its points, its exchange positions, its frequencies; a
    mixed plan: its points, each pass's layout, its frequencies."""
    j = np.arange(plan.elems)
    if plan.mixed is None:
        ok = np.ones(plan.elems, bool)
        return {"points": (t + plan.line_threads * j, ok), "exchange": (plan.elems * t + j, ok),
                "frequencies": (np.array([dif_freq(plan, t, i) for i in j]), ok)}
    mp = plan.mixed
    out = {"points": mp.points(t)}
    if not plan.bluestein:  # a Bluestein line's passes exchange in the scratch
        for k in range(len(mp.passes)):
            out[f"pass {k}"] = mp.layout(k, t)
    out["frequencies"] = mp.frequencies(t)
    return {k: (np.array(p), np.array(v, bool)) for k, (p, v) in out.items()}


def row_threads(plan):
    """(sweep, thread) -> (row y, t, live) of the row phase."""
    tid = np.arange(plan.threads)
    sweep = np.arange(plan.row_sweeps)[:, None]
    if plan.mixed is None:
        per = plan.threads // plan.line_threads
        y = sweep * per + tid[None, :] // plan.line_threads
        t = np.broadcast_to(tid % plan.line_threads, y.shape)
        return y, t, np.ones(y.shape, bool)
    tl, rpw = plan.line_threads, 32 // plan.line_threads
    lane, warp = tid % 32, tid // 32
    r = lane // tl
    y = (sweep * (plan.threads // 32) + warp[None, :]) * rpw + r[None, :]
    live = (r[None, :] < rpw) & (y < plan.n)
    return y, np.broadcast_to(lane % tl, y.shape), live


def col_threads(plan):
    """(sweep, thread) -> (column x, t, group, live) of the column phase."""
    tid = np.arange(plan.threads)
    warp, lane = tid // 32, tid % 32
    group, t = warp // plan.line_threads, warp % plan.line_threads
    groups = plan.threads // 32 // plan.line_threads
    x = (np.arange(plan.col_sweeps)[:, None] * groups + group[None, :]) * 32 + lane[None, :]
    return (x, np.broadcast_to(t, x.shape), np.broadcast_to(group, x.shape), x < plan.n)


def row_addr(plan, y, a):
    """Field address of element a of row y."""
    return y * plan.line + pad(plan, a)


def col_addr(plan, x, a):
    """Field address of element a of column x."""
    return pad(plan, x) + a * plan.line


def scratch_elems(plan):
    """A Bluestein block's scratch, in elements: a padded line for each row
    of a row sweep, M slots for each column of a column sweep."""
    mp = plan.mixed
    return max(plan.threads // 32 * (32 // plan.line_threads) * mp.inner.line,
               plan.threads // plan.group_threads * 32 * mp.slots)


def row_scratch_addr(plan, y, a):
    """Scratch address of inner position a of row y's line, offset by its
    row sweep's whole scratch so that lines of different sweeps (which
    reuse the region one after another) stay apart: the row's line in
    flight (warp * rows a warp + r) at that times the scratch row, element
    a at a + (a >> the scratch's shift)."""
    inner = plan.mixed.inner
    per = plan.threads // 32 * (32 // plan.line_threads)
    sweep, line = np.divmod(y, per)
    slot = line * inner.line + a + (np.asarray(a) >> inner.pad_shift)
    assert (slot < scratch_elems(plan)).all(), "a row's scratch line past the scratch"
    return sweep * scratch_elems(plan) + slot


def col_scratch_addr(plan, x, a):
    """Scratch address of inner position a of column x's line (offset by
    its sweep as in row_scratch_addr): group g's 32 columns hold M slots
    each, slot a of column c at g * 32 * M + a * 32 + c."""
    groups = plan.threads // plan.group_threads
    sweep, rest = np.divmod(x, 32 * groups)
    group, c = np.divmod(rest, 32)
    slot = group * 32 * plan.mixed.slots + np.asarray(a) * 32 + c
    assert (slot < scratch_elems(plan)).all(), "a column's scratch slots past the scratch"
    return sweep * scratch_elems(plan) + slot


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("n", NS)
def test_plan_fits_the_card(n, backward):
    plan = fused_plan(n, backward)
    assert 1 <= plan.threads <= 1024 and plan.smem <= SMEM_LIMIT
    assert plan.smem == 8 * n * plan.line or plan.bluestein
    assert plan.line >= pad(plan, n - 1) + 1
    assert n * n % plan.chunks == 0 or plan.mixed is not None
    if plan.mixed is None:
        assert plan.elems * plan.line_threads == n
        assert plan.line_threads <= plan.elems  # the exchange's blocks of TL stay in a thread
        assert plan.row_sweeps * plan.threads == n * plan.line_threads
        if plan.line_threads > 1:  # the phases exchange: whole warps, rows within one
            assert plan.threads % 32 == 0 and 32 % plan.line_threads == 0
            assert plan.threads % plan.group_threads == 0 and plan.group_threads % 32 == 0
            assert plan.threads // plan.group_threads <= 15  # named barriers 1 ... 15
        return
    mp = plan.mixed
    if plan.bluestein:
        # a cyclic convolution over a 7-smooth M >= 2 N - 1, at most the power
        # of two at or above it, two M-point lines of register passes; field
        # and scratch fit
        inner, m = mp.inner, mp.slots
        assert not FP.smooth(n) and m >= 2 * n - 1 and FP.smooth(m)
        assert m <= 1 << (2 * n - 2).bit_length()
        assert math.prod(inner.radices) == m
        assert all(set(p.radices) <= set(FP.SMALL) for p in inner.passes)
        assert plan.elems == inner.elems <= 32 and plan.line_threads <= FP.MAX_LINE_THREADS
        assert inner.line >= m - 1 + ((m - 1) >> inner.pad_shift) + 1
        assert plan.threads <= mp.max_threads and plan.smem == mp.block_smem(FP.FWD_THREADS)
        assert 8 * (n * plan.line + scratch_elems(plan)) == \
            mp.block_smem(FP.BWD_THREADS if backward else FP.FWD_THREADS) <= SMEM_LIMIT
    else:
        assert math.prod(mp.radices) == n and all(FP.primes(r) == [r] for r in mp.radices)
        assert FP.smooth(n) and all(set(p.radices) <= set(FP.SMALL) for p in mp.passes)
        assert plan.elems <= 32 and plan.line_threads <= FP.MAX_LINE_THREADS
    assert plan.threads % 32 == 0 and plan.threads % plan.group_threads == 0
    assert plan.line_threads == 1 or plan.threads // plan.group_threads <= 15
    assert plan.row_sweeps * (plan.threads // 32) * (32 // plan.line_threads) >= n
    assert plan.col_sweeps * 32 * (plan.threads // plan.group_threads) >= n


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("n", NS)
def test_phases_cover_the_field_once(n, backward):
    plan = fused_plan(n, backward)
    ry, rt, rlive = row_threads(plan)
    cx, ct, group, clive = col_threads(plan)
    for kind in layouts(plan, 0):
        pos = np.array([layouts(plan, t)[kind][0] for t in range(plan.line_threads)])
        ok = np.array([layouts(plan, t)[kind][1] for t in range(plan.line_threads)])
        for lines, ts, live, index in ((ry, rt, rlive, lambda ln, p: (ln, p)),
                                       (cx, ct, clive, lambda ln, p: (p, ln))):
            hits = np.zeros((n, n), int)
            use = live[..., None] & ok[ts]
            ln = np.broadcast_to(lines[..., None], use.shape)[use]
            np.add.at(hits, index(ln, pos[ts][use]), 1)
            assert (hits == 1).all(), kind
    # a column's threads all sit in one group (one named barrier)
    for col in range(n):
        assert len(set(group[(cx == col) & clive].tolist())) == 1


def _count(addrs):
    """(wavefronts, least) of warp accesses of 8-byte elements at element
    addresses addrs (..., 32 lanes; -1 for an idle lane): a half-warp at a
    time, as many as the most distinct elements that share a bank pair,
    against one per half-warp that has any."""
    half = np.sort(np.asarray(addrs).reshape(-1, 16), axis=1)
    first = half >= 0
    first[:, 1:] &= half[:, 1:] != half[:, :-1]
    banks = np.zeros((half.shape[0], 16), int)
    rows = np.broadcast_to(np.arange(half.shape[0])[:, None], half.shape)
    np.add.at(banks, (rows[first], half[first] % 16), 1)
    return int(banks.max(axis=1).sum()), int(first.any(axis=1).sum())


def _phase_wavefronts(plan, phase):
    """(wavefronts, least) of every warp access of one phase's first
    sweep: each register's load or store in each layout."""
    lays = [layouts(plan, t) for t in range(plan.line_threads)]
    if phase == "row":
        lines, ts, live = (a[0] for a in row_threads(plan))
        addr = row_addr
    else:
        lines, ts, _, live = (a[0] for a in col_threads(plan))
        addr = col_addr
    total = least = 0
    for kind in lays[0]:
        pos = np.array([lk[kind][0] for lk in lays])[ts]  # (threads, E)
        ok = np.array([lk[kind][1] for lk in lays])[ts] & live[:, None]
        a = np.where(ok, addr(plan, lines[:, None], pos), -1).T  # (E, threads)
        a = np.pad(a, ((0, 0), (0, -a.shape[1] % 32)), constant_values=-1)
        got = _count(a.reshape(-1, 32))
        total, least = total + got[0], least + got[1]
    return total, least


def _scratch_wavefronts(plan, phase):
    """(wavefronts, least) of every warp access of a Bluestein plan's
    scratch in one phase's first sweep: each register's store or load in
    each of the inner line's pass layouts."""
    inner = plan.mixed.inner
    lays = [[inner.layout(k, t) for t in range(plan.line_threads)]
            for k in range(len(inner.passes))]
    if phase == "row":
        lines, ts, live = (a[0] for a in row_threads(plan))
        addr = row_scratch_addr
    else:
        lines, ts, _, live = (a[0] for a in col_threads(plan))
        addr = col_scratch_addr
    total = least = 0
    for lay in lays:
        pos = np.array([p for p, _ in lay])[ts]  # (threads, E)
        ok = np.array([o for _, o in lay], bool)[ts] & live[:, None]
        a = np.where(ok, addr(plan, lines[:, None], pos), -1).T  # (E, threads)
        a = np.pad(a, ((0, 0), (0, -a.shape[1] % 32)), constant_values=-1)
        got = _count(a.reshape(-1, 32))
        total, least = total + got[0], least + got[1]
    return total, least


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("n", NS)
def test_accesses_take_the_least_wavefronts(n, backward):
    """Every warp-wide shared-memory access of both phases: each register's
    load or store in each layout. The column phase always takes the least;
    the row phase the least at every power of two and LEAST_WAVEFRONTS,
    else the count the plan states (for the forward's block, which chose
    the padding); a Bluestein plan's scratch likewise."""
    plan = fused_plan(n, backward)
    total, least = _phase_wavefronts(plan, "column")
    assert total == least
    total, least = _phase_wavefronts(plan, "row")
    if plan.mixed is None or n in LEAST_WAVEFRONTS:
        assert total == least
    if plan.mixed is not None and not backward:
        assert (total, least) == FP.wavefronts(plan.mixed)
    if plan.bluestein:
        total, least = _scratch_wavefronts(plan, "column")
        assert total == least
        total, least = _scratch_wavefronts(plan, "row")
        if n in LEAST_WAVEFRONTS:
            assert total == least
        if not backward:
            assert (total, least) == FP.scratch_wavefronts(plan.mixed)


def _table(plan, e):
    """The kernels' twiddle tables as float32: the radix-2 pair's unit table
    exp(-2 pi i e / 128) (e = 32 exact), the mixed pair's exp(-2 pi i e / N)."""
    e = np.asarray(e)
    if plan.mixed is None:
        w = np.exp(-2j * np.pi * e / 128).astype(np.complex64).astype(complex)
        return np.where(e == 32, -1j, w)
    return np.exp(-2j * np.pi * e / plan.n).astype(np.complex64).astype(complex)


def _w16(k):
    """The radix-2 pair's constant twiddles exp(-2 pi i k / 16), as float32."""
    return np.exp(-2j * np.pi * np.asarray(k) / 16).astype(np.complex64).astype(complex)


def _exchange_store(field, v, ok, addr, store, own):
    """Each thread's valid registers to their line positions store[t, j] on
    the line's own slots: every slot of a line written once, no other."""
    field[own.ravel()] = np.nan  # whatever the lines held is overwritten
    counts = np.zeros(field.shape, int)
    a = addr(store[None])
    use = np.broadcast_to(ok[None], a.shape)
    np.add.at(counts, a[use], 1)
    field[a[use]] = v[use]
    assert (counts[own.ravel()] == 1).all(), "an exchange slot written twice or never"
    assert counts.sum() == own.size, "an exchange wrote outside its lines"


def _exchange_load(field, v, ok, addr, load):
    a = addr(load[None])
    use = np.broadcast_to(ok[None], a.shape)
    out = v.copy()
    out[use] = field[a[use]]
    assert not np.isnan(out[use]).any(), "an exchange read a slot no thread wrote"
    return out


def _register_stages(v, plan, inverse):
    """The radix-2 pair's stages of span N/2 ... TL on the thread's points
    (line_dif's first part; line_dit's last, run backwards with conjugate
    twiddles)."""
    tl, e = plan.line_threads, plan.elems
    t = np.arange(tl)
    spans = [e >> (s + 1) for s in range(e.bit_length() - 1)]
    for hm in reversed(spans) if inverse else spans:
        for m in range(e):
            if m & hm == 0:
                w = _table(plan, (t + tl * (m & (2 * hm - 1))) * (64 // (hm * tl)))
                a, b = v[:, :, m].copy(), v[:, :, m + hm].copy()
                if inverse:
                    b = b * np.conj(w)
                    v[:, :, m], v[:, :, m + hm] = a + b, a - b
                else:
                    v[:, :, m], v[:, :, m + hm] = a + b, (a - b) * w
    return v


def _block_stages(v, plan, inverse):
    """The radix-2 pair's stages of span TL/2 ... 1 on positions E t + i
    (line_dif's last part; line_dit's first, backwards with conjugate
    twiddles)."""
    tl, e = plan.line_threads, plan.elems
    spans = [tl >> (s + 1) for s in range(tl.bit_length() - 1)]
    for h in reversed(spans) if inverse else spans:
        for i in range(e):
            if i & h == 0:
                w = _w16((i & (h - 1)) * (8 // h))
                a, b = v[:, :, i].copy(), v[:, :, i + h].copy()
                if inverse:
                    b = b * np.conj(w)
                    v[:, :, i], v[:, :, i + h] = a + b, a - b
                else:
                    v[:, :, i], v[:, :, i + h] = a + b, (a - b) * w
    return v


def _line_pow2(field, v, plan, addr, inverse, own):
    """Emulate reg_fft.cuh line_dif (inverse: line_dit) for every line of a
    phase. v: (lines, TL, E); the forward takes point t + TL * j in
    v[:, t, j] and leaves frequency dif_freq(t, j) there, the inverse the
    other way round."""
    tl, e = plan.line_threads, plan.elems
    v = v.copy()
    t, j = np.arange(tl)[:, None], np.arange(e)[None, :]
    points, exchange = t + tl * j, e * t + j
    ok = np.ones((tl, e), bool)
    if inverse:
        if tl > 1:
            v = _block_stages(v, plan, True)
            _exchange_store(field, v, ok, addr, exchange, own)
            v = _exchange_load(field, v, ok, addr, points)
        return _register_stages(v, plan, True)
    v = _register_stages(v, plan, False)
    if tl > 1:
        _exchange_store(field, v, ok, addr, points, own)
        v = _exchange_load(field, v, ok, addr, exchange)
        v = _block_stages(v, plan, False)
    return v


def _dft(x, inverse):
    """Unnormalised DFT over the last axis (its conjugate with inverse),
    exact: the butterflies' float32 constants are within rounding."""
    r = x.shape[-1]
    w = np.exp((2j if inverse else -2j) * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    return x @ w


def _mixed_pass(v, plan, k, inverse):
    """Pass k of the mixed-radix pair on every line's threads (line_dif_mr's
    mr_stages): v (lines, T, E) in pass k's layout."""
    mp = plan.mixed
    r_all, _, span, cosets, c = mp.geometry(k)
    tl, n = mp.line_threads, mp.n
    t = np.arange(tl)
    radices = mp.passes[k].radices
    out = v.copy()
    for u in range(c):
        kappa = t + tl * u
        live = kappa < cosets
        below = kappa % span
        order = range(len(radices) - 1, -1, -1) if inverse else range(len(radices))
        for s in order:
            r, big_s = radices[s], math.prod(radices[s + 1:])
            step = n // (r * big_s * span)
            for hi in range(r_all // (r * big_s)):
                for lo in range(big_s):
                    d0 = hi * r * big_s + lo
                    regs = [u + c * (d0 + d * big_s) for d in range(r)]
                    x = out[:, :, regs]  # (lines, T, r)
                    j = lo * span + below  # (T,)
                    tw = _table(plan, (j[:, None] * np.arange(r)[None, :] * step) % n)
                    if inverse:
                        x = _dft(x * np.conj(tw), True)
                    else:
                        x = _dft(x, False) * tw
                    out[:, :, regs] = np.where(live[None, :, None], x, out[:, :, regs])
    return out


def _line_mixed(field, v, plan, addr, inverse, own):
    """Emulate line_dif_mr (inverse: line_dit_mr) for every line of a
    phase: v (lines, T, E) in the points layout (the inverse: the
    frequencies' layout), the passes with their exchanges on the lines'
    own slots."""
    mp = plan.mixed
    tl, last = mp.line_threads, len(mp.passes) - 1
    lay = [[mp.layout(k, t) for t in range(tl)] for k in range(last + 1)]
    pos = [np.array([p for p, _ in lk]) for lk in lay]
    ok = [np.array([o for _, o in lk], bool) for lk in lay]

    v = v.copy()
    order = range(last, -1, -1) if inverse else range(last + 1)
    for k in order:
        if k < last if inverse else k > 0:
            src = k + 1 if inverse else k - 1
            _exchange_store(field, v, ok[src], addr, pos[src], own)
            v = _exchange_load(field, v, ok[k], addr, pos[k])
        v = _mixed_pass(v, plan, k, inverse)
    return v


def _f32(z):
    """A table rounded once to float32, as the library uploads it."""
    return np.asarray(z).astype(np.complex64).astype(complex)


def _line_bluestein(scratch, v, plan, saddr, inverse, own):
    """Emulate line_dif_bl (inverse: line_dit_bl) for every line of a
    phase: v (lines, T, E) in the points' layout (the spectrum's is the
    same); the chirp, the inner forward (line_dif_mr at M, its exchanges in
    the scratch through saddr), the filter at the inner forward's
    frequencies, the inner inverse, the chirp; the inverse with the tables'
    conjugates. Registers past N end as zero."""
    bp = plan.mixed
    inner = FusedPlan(n=bp.slots, elems=bp.elems, line_threads=bp.line_threads, line=0,
                      pad_shift=0, threads=0, row_sweeps=0, col_sweeps=0, bwd_threads=0,
                      bwd_row_sweeps=0, bwd_col_sweeps=0, group_threads=0, smem=0, chunks=0,
                      mixed=bp.inner)
    chirp, filt = (_f32(t) for t in FP.bluestein_tables(bp.n, bp.inner))
    tl = bp.line_threads
    pos0 = np.array([bp.points(t)[0] for t in range(tl)])
    ok0 = np.array([bp.points(t)[1] for t in range(tl)], bool)
    last = len(bp.inner.passes) - 1
    pos_l = np.array([bp.inner.layout(last, t)[0] for t in range(tl)])
    ok_l = np.array([bp.inner.layout(last, t)[1] for t in range(tl)], bool)
    c = chirp[np.where(ok0, pos0, 0)][None]
    f = filt[pos_l][None]
    if inverse:
        c, f = np.conj(c), np.conj(f)
    v = _line_mixed(scratch, np.where(ok0, v * c, 0), inner, saddr, False, own)
    v = _line_mixed(scratch, np.where(ok_l, v * f, v), inner, saddr, True, own)
    return np.where(ok0, v * c, 0)


def _phase(field, plan, addr_of, steps, load="points", store="points", src=None,
           scratch_of=None, scratch=None):
    """One phase over every line: load the thread's registers in layout
    ``load`` (from src, (lines, N), else the field), run the steps ("dif",
    "dit", or f(v, line, position): elementwise work, with each register's
    line position in the layout it then holds) and store them in layout
    ``store``. Returns the lines, (lines, N), in natural order. A Bluestein
    plan's lines exchange in ``scratch`` at scratch_of(line, position)."""
    n, tl = plan.n, plan.line_threads
    lines = np.arange(n)[:, None, None]
    lay = [layouts(plan, t) for t in range(tl)]
    pos = {kind: np.array([lk[kind][0] for lk in lay])[None] for kind in ("points", "frequencies")}
    ok = {kind: np.array([lk[kind][1] for lk in lay])[None] for kind in ("points", "frequencies")}

    def addr(a):
        return addr_of(lines[:, :, 0] if a.ndim == 2 else lines, a)

    own = np.sort(addr(np.arange(n)[None, :]).reshape(n, n), axis=1)
    if plan.bluestein:
        m = plan.mixed.slots

        def saddr(a):
            return scratch_of(lines[:, :, 0] if a.ndim == 2 else lines, a)

        own_s = np.sort(saddr(np.arange(m)[None, :]).reshape(n, m), axis=1)
        assert len(np.unique(own_s)) == own_s.size, "two lines in flight share a scratch slot"
    held = load
    use = np.broadcast_to(ok[held], (n, tl, plan.elems))
    p = np.broadcast_to(pos[held], use.shape)
    v = np.full(use.shape, np.nan + 0j)
    v[use] = (src[np.broadcast_to(lines, use.shape)[use], p[use]] if src is not None
              else field[addr(np.where(ok[held], pos[held], 0))][use])
    for step in steps:
        if step in ("dif", "dit") and plan.bluestein:
            v = _line_bluestein(scratch, v, plan, saddr, step == "dit", own_s)
            held = "points" if step == "dit" else "frequencies"
        elif step in ("dif", "dit"):
            line = _line_pow2 if plan.mixed is None else _line_mixed
            v = line(field, v, plan, addr, step == "dit", own)
            held = "points" if step == "dit" else "frequencies"
        else:
            v = step(v, lines, np.where(ok[held], pos[held], 0))
    assert held == store
    use = np.broadcast_to(ok[store], v.shape)
    a = addr(pos[store])
    field[a[use]] = v[use]
    out = np.full((n, n), np.nan + 0j)
    out[np.broadcast_to(lines, use.shape)[use], np.broadcast_to(pos[store], use.shape)[use]] = \
        v[use]
    assert not np.isnan(out).any(), "a line element no thread held"
    return out


def _scratch(plan):
    """A Bluestein plan's scratch for every sweep of a phase (else None)."""
    if not plan.bluestein:
        return None
    sweeps = max(plan.row_sweeps, plan.col_sweeps)
    return np.full(sweeps * scratch_elems(plan), np.nan + 0j)


def _rows(field, plan, steps, **kw):
    return _phase(field, plan, lambda y, a: row_addr(plan, y, a), steps,
                  scratch_of=lambda y, a: row_scratch_addr(plan, y, a), scratch=_scratch(plan),
                  **kw)


def _cols(field, plan, steps, **kw):
    """As _rows for the columns; returns the field (ky, x)."""
    return _phase(field, plan, lambda x, a: col_addr(plan, x, a), steps,
                  scratch_of=lambda x, a: col_scratch_addr(plan, x, a), scratch=_scratch(plan),
                  **kw).T


def _assert_close(actual, expected):
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n", EMULATED)
def test_emulated_chain_matches_numpy(n):
    """One slice as the kernels run it: the row phase (T, the forward row
    transform, stored by frequency), the propagation's column phase
    (forward column transform, H / N^2 by frequency, inverse column
    transform), the next row phase (inverse row transform from the
    frequencies), then the far field (forward rows, forward columns)."""
    plan = fused_plan(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    tmul = np.exp(1j * rng.uniform(0, 6, (n, n)))
    h = np.exp(1j * rng.uniform(0, 6, (n, n)))
    field = np.full(n * plan.line, np.nan + 0j)

    _rows(field, plan, [lambda v, y, x_: v * tmul[y, x_], "dif"], src=x, store="frequencies")
    _cols(field, plan, ["dif", lambda v, kx, ky: v * h[ky, kx] / (n * n), "dit"])
    psi = _rows(field, plan, ["dit"], load="frequencies")
    _assert_close(psi, np.fft.ifft2(h * np.fft.fft2(x * tmul)))

    _rows(field, plan, ["dif"], store="frequencies")
    far = _cols(field, plan, ["dif"], store="frequencies")
    _assert_close(far, np.fft.fft2(psi))
    # the padding slots are never touched
    used = np.zeros(field.shape, bool)
    used[row_addr(plan, np.arange(n)[:, None], np.arange(n)[None, :]).ravel()] = True
    assert np.isnan(field[~used]).all()


# sha256 of plan_source(N)[:12] for every N in [2, 128] that is not a power
# of two and takes no Bluestein line (7-smooth), as they were before the
# Bluestein line: those plans, and so their machine code,
# stay what they were
MIXED_SOURCES = {
    3: "100c77a44490", 5: "3e9b9c52140a", 6: "09ca825fa7ac", 7: "ae3a6bac25ac",
    9: "6555b3c43ed6", 10: "876d6915eeaf", 12: "bff31546447d", 14: "a17f08cf9c5f",
    15: "6aaccb8348a7", 18: "212ffeae6888", 20: "821164422af2", 21: "338960ae31d1",
    24: "d7fc6265d29f", 25: "b76e3486a13b", 27: "5bc0ef6c14b5", 28: "670b4d80009c",
    30: "9eb9ced4cd73", 35: "f8810c5e3ca2", 36: "020639909266", 40: "32766dd52358",
    42: "61b655fd7cd0", 45: "78bff2939690", 48: "8dce2c9d9060", 49: "ebe6d646d36b",
    50: "016d45c8273b", 54: "925d33ba0436", 56: "3202b4b44e0e", 60: "c7fc36aae541",
    63: "197c351ce40b", 70: "85201ada21b1", 72: "addb4b2fb4fd", 75: "d7aa82747af8",
    80: "990e17f85e51", 81: "5215f386a639", 84: "03b6ac9f62f1", 90: "b75ba6c1cc2b",
    96: "09ffe541e80c", 98: "704b5142ef3f", 100: "0d51f3049d6a", 105: "17cb0bb7332a",
    108: "af32031d51c8", 112: "fd4b3a3e96b4", 120: "b8330b7563c8", 125: "df26a0db022e",
    126: "5be95b21c744",
}


@pytest.mark.parametrize("n", [n for n in NS if not FP.is_pow2(n)])
def test_mixed_plan_frequencies_are_the_digit_reversal(n):
    """The forward's frequency layout holds every frequency once: the digit
    reversal of its position (a Bluestein line's: the position itself), and
    the generated source names the plan's line, row and padding (and a
    Bluestein plan's scratch row and thread cap); any other N's source is
    the one it had before the Bluestein line."""
    mp = FP.mixed_plan(n)
    blue = isinstance(mp, FP.BluesteinPlan)
    held = [f for t in range(mp.line_threads)
            for f, ok in zip(*mp.frequencies(t)) if ok]
    assert sorted(held) == list(range(n))
    src = FP.plan_source(n).splitlines()
    if blue:
        assert held == [p for t in range(mp.line_threads) for p, ok in zip(*mp.points(t)) if ok]
        assert src[1] == "#define PTYRAD_BLUESTEIN 1"
        assert src[2].startswith(f"#define PTYRAD_MIXED_LINE regfft::BluesteinLine<{n}, "
                                 f"regfft::MixedLine<{mp.slots}, {mp.line_threads}, ")
        assert src[5:8] == [f"#define PTYRAD_SCRATCH_ROW {mp.inner.line}",
                            f"#define PTYRAD_SCRATCH_PAD {mp.inner.pad_shift}",
                            f"#define PTYRAD_BLOCK_THREADS {mp.max_threads}"]
        src = src[:1] + src[2:5] + src[8:]
    else:
        assert sorted(FP.digitrev(p, mp.radices) for p in range(n)) == list(range(n))
        assert src[1].startswith(f"#define PTYRAD_MIXED_LINE regfft::MixedLine<{n}, "
                                 f"{mp.line_threads}, ")
        assert hashlib.sha256(FP.plan_source(n).encode()).hexdigest()[:12] == MIXED_SOURCES[n]
    assert (n in MIXED_SOURCES) == (not blue) == FP.smooth(n)
    assert src[2:] == [f"#define PTYRAD_MIXED_ROW {mp.line}",
                       f"#define PTYRAD_MIXED_PAD {mp.pad_shift}", '#include "multislice.cu"']
    assert FP.plan_source(n, bf16_operands=True).splitlines()[1] == "#define PTYRAD_BF16_OPERANDS 1"


@pytest.mark.parametrize("n", [11, 26, 110, 122, 127])
def test_line_adjoint(n):
    """The inverse line transform is the forward's conjugate transpose,
    step by step (a Bluestein line's: the conjugate chirp, the pad as the
    crop's adjoint, each inner transform's adjoint, the conjugate filter):
    <F x, y> = <x, F^H y> to 1e-12 in float64 over a
    row phase's lines, the float32 tables alike in both; and F is the DFT
    (rtol 1e-5 of the largest entry)."""
    plan = fused_plan(n)
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    y = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    field = np.full(n * plan.line, np.nan + 0j)
    fx = _rows(field, plan, ["dif"], src=x, store="frequencies")
    fhy = _rows(field, plan, ["dit"], src=y, load="frequencies")
    lhs, rhs = np.vdot(y, fx), np.vdot(fhy, x)
    assert abs(lhs - rhs) <= 1e-12 * np.linalg.norm(x) * np.linalg.norm(y) * n
    _assert_close(fx, np.fft.fft(x, axis=1))


def test_plan_and_prepare_reject_other_sizes():
    """The plan and the kernels' set-up take N from 2 to 128 and refuse any
    other before they touch a device."""
    for n in (0, 1, 129, 256):
        with pytest.raises(ValueError, match=r"N must be in \[2, 128\]"):
            fused_plan(n)
        with pytest.raises(ValueError, match=r"N must be in \[2, 128\]"):
            M.prepare("cpu", n)
    for n in (1, 64, 129):
        with pytest.raises(ValueError, match="not a power of two"):
            FP.mixed_plan(n)
