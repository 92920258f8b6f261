"""The plan of the fused chain kernels (B3/B4, ``csrc/multislice.cu``),
checked on the CPU.

``fused_plan`` restates multislice.cu's compile-time ``FPlan``; the
card-only suite holds the two equal through the library's
``ptyrad_fused_plan``. A block holds one (sample, mode) wavefield in shared
memory for the whole chain, its rows padded (element (y, x) at
y * line + x + x // 16), and transforms it in a row phase and a column
phase with the radix-2 pair of ``csrc/reg_fft.cuh`` (``line_dif``,
``line_dit``): TL = N / E threads a line, E points each at t + TL * m; the
decimation-in-frequency stages of span N/2 ... TL in registers, one
exchange on the line's own slots of the field (the points stored at
t + TL * m, thread t loading positions E * t + i), the stages of span
TL/2 ... 1; the forward leaves frequency bitrev(E * t + i) in register i
(``dif_freq``), and the inverse, its conjugate transpose, runs the same
way back. In the row phase a row's threads are adjacent lanes of one warp;
in the column phase a warp holds 32 adjacent columns with one t, and a
column's TL warps wait on a named barrier of their own.

Here, for every N = 2 ... 128 and both blocks: the block fits the card;
each phase covers every element of the field once, in each of the three
layouts a thread uses (its points, its exchange positions, its
frequencies); every warp access of both phases (loads and stores in each
layout) takes the least number of shared-memory wavefronts (8-byte
accesses: one per half-warp that has any, 32 banks of 4 bytes). For every
N: each exchange writes each of its line's slots once, reads only what it
wrote and touches no other line, and a thread-by-thread NumPy emulation of
one propagation ifft2(H fft2(.)), its column phase fused (column
transform, H / N^2, inverse column transform), and of the far field
fft2(.) equals NumPy's at rtol 1e-5 of the largest entry (double precision
arithmetic; the only float32 rounding is the twiddles').
"""

import dataclasses

import numpy as np
import pytest

from ptyrad_tpu_torch.ops import fused_multislice as M

NS = [2 ** k for k in range(1, 8)]
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
# multislice.cu kFwdThreads, kBwdThreads: the chain blocks' threads at N = 128
FWD_THREADS, BWD_THREADS = 1024, 512


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How a chain block of multislice.cu holds and transforms an N x N field."""

    n: int
    elems: int          # E: points of a line a thread holds
    line_threads: int   # TL: threads a line
    line: int           # a padded row of the field, in elements
    threads: int        # the block's threads
    sweeps: int         # lines a thread takes in a phase
    bwd_threads: int    # the same for the backward's block
    bwd_sweeps: int
    group_threads: int  # a column group (32 adjacent columns): its named barrier's count
    smem: int           # bytes: the padded field
    chunks: int         # B3a's epilogue blocks per sample


def fused_plan(n: int, backward: bool = False) -> FusedPlan:
    """multislice.cu's FPlan for N a power of two from 2 to M.MAX_N: the
    forward chain block's (threads, sweeps), or with ``backward`` the
    backward's in their place."""
    if not (2 <= n <= M.MAX_N and not n & (n - 1)):
        raise ValueError(f"fused_plan: N must be a power of two in [2, {M.MAX_N}], got {n}")
    elems = min(n, 16)
    line_threads = n // elems
    slots = n * line_threads
    fwd, bwd = min(slots, FWD_THREADS), min(slots, BWD_THREADS)
    threads = bwd if backward else fwd
    line = n + (n // 16 if n >= 16 else 1)
    return FusedPlan(
        n=n, elems=elems, line_threads=line_threads, line=line, threads=threads,
        sweeps=slots // threads, bwd_threads=bwd, bwd_sweeps=slots // bwd,
        group_threads=32 * line_threads, smem=8 * n * line, chunks=min(n, 16))


def pad(a):
    return a + a // 16


def bitrev(k, bits):
    return int(format(int(k), f"0{bits}b")[::-1], 2) if bits else 0


def dif_freq(plan, t, i):
    """reg_fft.cuh dif_freq: the frequency line_dif leaves in register i of
    thread t, bitrev(E t + i)."""
    e_bits, t_bits = plan.elems.bit_length() - 1, plan.line_threads.bit_length() - 1
    return bitrev(i, e_bits) * plan.line_threads + bitrev(t, t_bits)


def layouts(plan, t):
    """The line positions thread t holds in register j, in each layout:
    its points, its exchange positions, its frequencies."""
    j = np.arange(plan.elems)
    return {"points": t + plan.line_threads * j, "exchange": plan.elems * t + j,
            "frequencies": np.array([dif_freq(plan, t, i) for i in j])}


def row_threads(plan):
    """(sweep, thread) -> (row y, t) of the row phase."""
    tid = np.arange(plan.threads)
    per = plan.threads // plan.line_threads
    sweep = np.arange(plan.sweeps)[:, None]
    return sweep * per + tid[None, :] // plan.line_threads, np.broadcast_to(
        tid % plan.line_threads, (plan.sweeps, plan.threads))


def col_threads(plan):
    """(sweep, thread) -> (column x, t, group) of the column phase."""
    tid = np.arange(plan.threads)
    warp, lane = tid // 32, tid % 32
    group, t = warp // plan.line_threads, warp % plan.line_threads
    per = plan.threads // plan.line_threads
    x = np.arange(plan.sweeps)[:, None] * per + (group * 32 + lane)[None, :]
    return x, np.broadcast_to(t, x.shape), np.broadcast_to(group, x.shape)


def row_addr(plan, y, a):
    """Field address of element a of row y."""
    return y * plan.line + pad(a)


def col_addr(plan, x, a):
    """Field address of element a of column x."""
    return pad(x) + a * plan.line


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("n", NS)
def test_plan_fits_the_card(n, backward):
    plan = fused_plan(n, backward)
    assert plan.elems * plan.line_threads == n
    assert plan.line_threads <= plan.elems  # the exchange's blocks of TL stay in a thread
    assert 1 <= plan.threads <= 1024 and plan.sweeps * plan.threads == n * plan.line_threads
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == 8 * n * plan.line and plan.line > n
    if plan.line_threads > 1:  # the phases exchange: whole warps, rows within one
        assert plan.threads % 32 == 0 and 32 % plan.line_threads == 0
        assert plan.threads % plan.group_threads == 0 and plan.group_threads % 32 == 0
        assert plan.threads // plan.group_threads <= 15  # named barriers 1 ... 15
    assert n * n % plan.chunks == 0


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("n", NS)
def test_phases_cover_the_field_once(n, backward):
    plan = fused_plan(n, backward)
    for kind in ("points", "exchange", "frequencies"):
        pos = np.array([layouts(plan, t)[kind] for t in range(plan.line_threads)])
        hits = np.zeros((n, n), int)
        y, t = row_threads(plan)
        np.add.at(hits, (y[..., None], pos[t]), 1)
        assert (hits == 1).all(), f"row phase, {kind}"
        hits[:] = 0
        x, t, group = col_threads(plan)
        np.add.at(hits, (pos[t], x[..., None]), 1)
        assert (hits == 1).all(), f"column phase, {kind}"
    # a column's threads all sit in one group (one named barrier)
    for col in range(n):
        assert len(set(group[x == col].tolist())) == 1


def _wavefronts(addrs):
    """Shared-memory wavefronts of one warp access of 8-byte elements at
    element addresses addrs (lane order, None for an idle lane): a
    half-warp at a time, as many as the most distinct elements that share a
    bank pair."""
    total = 0
    for half in (addrs[:16], addrs[16:]):
        live = {a for a in half if a is not None}
        if live:
            pairs = {}
            for a in live:
                pairs.setdefault(a % 16, set()).add(a)
            total += max(len(v) for v in pairs.values())
    return total


def _least(addrs):
    return sum(1 for half in (addrs[:16], addrs[16:]) if any(a is not None for a in half))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("n", NS)
def test_accesses_take_the_least_wavefronts(n, backward):
    """Every warp-wide shared-memory access of both phases: each register's
    load or store in each of the three layouts."""
    plan = fused_plan(n, backward)
    pos = {kind: np.array([layouts(plan, t)[kind] for t in range(plan.line_threads)])
           for kind in ("points", "exchange", "frequencies")}
    ry, rt = row_threads(plan)
    cx, ct, _ = col_threads(plan)
    for sweep in range(plan.sweeps):
        for phase, (lines, ts, addr) in {"row": (ry[sweep], rt[sweep], row_addr),
                                         "column": (cx[sweep], ct[sweep], col_addr)}.items():
            for kind, p in pos.items():
                for j in range(plan.elems):
                    for w0 in range(0, plan.threads, 32):
                        lanes = range(w0, min(w0 + 32, plan.threads))
                        addrs = [int(addr(plan, lines[i], p[ts[i], j])) for i in lanes]
                        addrs += [None] * (32 - len(addrs))
                        assert _wavefronts(addrs) == _least(addrs), (phase, kind, j, w0)


def _unit(e):
    """The kernels' unit twiddle table (reg_fft.cuh, kUnit):
    exp(-2 pi i e / 128) stored as complex64, e = 32 exact."""
    e = np.asarray(e)
    w = np.exp(-2j * np.pi * e / 128).astype(np.complex64).astype(complex)
    return np.where(e == 32, -1j, w)


def _w16(k):
    """The radix-2 pair's constant twiddles exp(-2 pi i k / 16), as float32."""
    return np.exp(-2j * np.pi * np.asarray(k) / 16).astype(np.complex64).astype(complex)


def _exchange(field, v, addr, store, load, own):
    """One exchange of a phase's lines on their own slots: each thread
    stores register j at line position store[t, j], then loads position
    load[t, j]; every slot of a line is written once and only written
    slots are read."""
    field[own.ravel()] = np.nan  # whatever the lines held is overwritten
    counts = np.zeros(field.shape, int)
    a = addr(store[None])
    np.add.at(counts, a.ravel(), 1)
    field[a] = v
    assert (counts[own.ravel()] == 1).all(), "an exchange slot written twice or never"
    assert counts.sum() == own.size, "an exchange wrote outside its lines"
    out = field[addr(load[None])]
    assert not np.isnan(out).any(), "an exchange read a slot no thread wrote"
    return out


def _register_stages(v, plan, inverse):
    """The stages of span N/2 ... TL on the thread's points (line_dif's
    first part; line_dit's last, run backwards with conjugate twiddles)."""
    tl, e = plan.line_threads, plan.elems
    t = np.arange(tl)
    spans = [e >> (s + 1) for s in range(e.bit_length() - 1)]
    for hm in reversed(spans) if inverse else spans:
        for m in range(e):
            if m & hm == 0:
                w = _unit((t + tl * (m & (2 * hm - 1))) * (64 // (hm * tl)))
                a, b = v[:, :, m].copy(), v[:, :, m + hm].copy()
                if inverse:
                    b = b * np.conj(w)
                    v[:, :, m], v[:, :, m + hm] = a + b, a - b
                else:
                    v[:, :, m], v[:, :, m + hm] = a + b, (a - b) * w
    return v


def _block_stages(v, plan, inverse):
    """The stages of span TL/2 ... 1 on positions E t + i (line_dif's last
    part; line_dit's first, backwards with conjugate twiddles)."""
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


def _line(field, v, plan, addr, inverse):
    """Emulate reg_fft.cuh line_dif (inverse: line_dit) for every line of a
    phase. v: (lines, TL, E); the forward takes point t + TL * j in
    v[:, t, j] and leaves frequency dif_freq(t, j) there, the inverse the
    other way round."""
    n, tl, e = plan.n, plan.line_threads, plan.elems
    v = v.copy()
    t, j = np.arange(tl)[:, None], np.arange(e)[None, :]
    points, exchange = t + tl * j, e * t + j
    own = np.sort(addr(np.arange(n)[None, :]).reshape(v.shape[0], n), axis=1)
    if inverse:
        if tl > 1:
            v = _block_stages(v, plan, True)
            v = _exchange(field, v, addr, exchange, points, own)
        return _register_stages(v, plan, True)
    v = _register_stages(v, plan, False)
    if tl > 1:
        v = _exchange(field, v, addr, points, exchange, own)
        v = _block_stages(v, plan, False)
    return v


def _phase(field, plan, addr_of, steps, load="points", store="points", src=None):
    """One phase over every line: load the thread's registers in layout
    ``load`` (from src, (lines, N), else the field), run the steps ("dif",
    "dit", or f(v, line, position): elementwise work, with each register's
    line position in the layout it then holds) and store them in layout
    ``store``. Returns the lines, (lines, N), in natural order."""
    n, tl = plan.n, plan.line_threads
    lines = np.arange(n)[:, None, None]
    pos = {kind: np.array([layouts(plan, t)[kind] for t in range(tl)])[None]
           for kind in ("points", "frequencies")}

    def addr(a):
        return addr_of(lines[:, :, 0] if a.ndim == 2 else lines, a)

    held = load
    v = src[:, pos[held][0]] if src is not None else field[addr(pos[held])]
    for step in steps:
        if step in ("dif", "dit"):
            v = _line(field, v, plan, addr, step == "dit")
            held = "points" if step == "dit" else "frequencies"
        else:
            v = step(v, lines, pos[held])
    assert held == store
    field[addr(pos[store])] = v
    out = np.empty((n, n), complex)
    out[lines, pos[store]] = v
    return out


def _rows(field, plan, steps, **kw):
    return _phase(field, plan, lambda y, a: row_addr(plan, y, a), steps, **kw)


def _cols(field, plan, steps, **kw):
    """As _rows for the columns; returns the field (ky, x)."""
    return _phase(field, plan, lambda x, a: col_addr(plan, x, a), steps, **kw).T


def _assert_close(actual, expected):
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n", NS)
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


def test_plan_and_prepare_reject_other_sizes():
    """The plan and the kernels' set-up take N a power of two up to 128 and
    refuse any other before they touch a device."""
    for n in (1, 96, 256):
        with pytest.raises(ValueError, match="power of two"):
            fused_plan(n)
        with pytest.raises(ValueError, match="power of two"):
            M.prepare("cpu", n)
