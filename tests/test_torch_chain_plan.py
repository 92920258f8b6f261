"""The pass plan of the chain kernels (B5/B6, ``csrc/chain.cu``), checked on
the CPU.

``pass_plan`` restates chain.cu's compile-time ``Plan``; the card-only
suite holds the two equal through the library's ``ptyrad_chain_plan``. The
card runs the plan; here a NumPy emulation follows it thread by thread:
each thread's points of a line at t + line_threads * m, the Stockham passes
(twiddles from the kernels' table, stored as float32), each exchange
through shared memory at the kernels' addresses (padded a + a // 16 for
rows, interleaved by column for the column tile), the H multiply in natural
order, and the far-field exit's stores. Nothing here runs CUDA: the
card-only suite holds the kernels themselves against their plain versions.

For every N = 2 ... 512 and pmode 1 ... 8: the blocks fit the card (shared
memory, threads) and every element of a (B, pmode, N, N) field is covered
by exactly one block of each pass. For every N (the line transforms do not
depend on pmode): every exchange writes each address once and reads only
written ones, and the emulated propagation ifft2(H fft2(.)) and far-field
exit fftshift(fft2(.)) equal NumPy's at rtol 1e-5 of the largest entry
(double precision arithmetic; the only float32 rounding is the twiddle
table's, about 6e-8).
"""

import dataclasses

import numpy as np
import pytest

from ptyrad_tpu_torch.ops import chain as C

NS = [2 ** k for k in range(1, 10)]
PMODES = list(range(1, 9))
B = 3  # odd on purpose
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """How the kernels' row and column passes transform an N-point line.

    Each of ``line_threads`` threads holds ``elems`` points of a line in
    registers, at positions t + line_threads * m (m < elems), and runs the
    Stockham passes of ``radices`` there; between two passes the line goes
    once through shared memory. Both transforms take and give the line in
    natural order, so no permutation sits between the passes. A row-pass
    block holds ``rows`` rows of one sample for ``groups`` mode groups of
    rows * line_threads threads each; group g takes modes g, g + groups, ...
    """

    n: int
    radices: tuple
    elems: int
    line_threads: int
    rows: int          # rows per row-pass block
    groups: int        # mode groups per row-pass block: min(pmode, 4)
    cols: int          # adjacent columns per column-pass block
    row_threads: int
    col_threads: int
    row_smem: int      # bytes: the T tile, one padded line (a at a + a // 16) per row and group
    col_smem: int      # bytes: the block's columns, interleaved


def pass_plan(n: int, pmode: int = 1) -> PassPlan:
    """chain.cu's Plan for N-point lines, N a power of two from 2 to
    C.MAX_N, and pmode probe modes: 16 points a thread (N itself below 16),
    radix-16 passes and a last pass of what remains (N = 512: 16, 16, 2), a
    warp's worth of rows per mode group in a row-pass block, and 16 columns
    a column-pass block."""
    if not (2 <= n <= C.MAX_N and not n & (n - 1)) or pmode < 1:
        raise ValueError(f"pass_plan: N must be a power of two in [2, {C.MAX_N}], got {n}")
    elems = min(n, 16)
    line_threads = n // elems
    radices, rest = [], n
    while rest > 16:
        radices.append(16)
        rest //= 16
    radices.append(rest)
    rows = min(n, 32 // line_threads)
    groups = min(pmode, 4)
    cols = min(n, 16)
    return PassPlan(
        n=n, radices=tuple(radices), elems=elems, line_threads=line_threads, rows=rows,
        groups=groups, cols=cols, row_threads=rows * line_threads * groups,
        col_threads=cols * line_threads,
        row_smem=8 * (rows * n + groups * rows * (n + n // 16)),
        col_smem=cols * n * 8 if len(radices) > 1 else 0)


def _twiddle_table():
    """The kernels' pass twiddles (chain.cu g_twiddle), stored as float32:
    for M = NS R = 32 ... 512, entry (r, k) = exp(-2 pi i r k / M) at
    M - 32 + r NS + k, NS = 16 below M = 512 and 256 at it."""
    table = np.full(2 * 512 - 32, np.nan + 0j)
    for m in (32, 64, 128, 256, 512):
        ns = 256 if m == 512 else 16
        r, k = np.meshgrid(np.arange(m // ns), np.arange(ns), indexing="ij")
        table[m - 32 + r * ns + k] = np.exp(-2j * np.pi * r * k / m)
    return table.astype(np.complex64).astype(complex)


TWIDDLES = _twiddle_table()


def _line_transform(v, plan, inverse, pad_row):
    """Emulate the kernels' line transform. v: (L, line_threads, elems),
    thread t holding position t + line_threads * m in v[:, t, m]; returns the
    same layout after the unnormalised forward (or inverse) DFT. pad_row:
    the row pass's padded exchange addresses (else the column tile's,
    where an address is a line position)."""
    lines, tl, e = v.shape
    n = plan.n
    t = np.arange(tl)
    ns = 1
    out = np.empty_like(v)
    for i, r in enumerate(plan.radices):
        last = i == len(plan.radices) - 1
        q_count = e // r
        assert q_count * r == e
        width = n + n // 16 if pad_row else n
        s = np.full((lines, width), np.nan + 0j)
        written = np.zeros(width, int)
        for q in range(q_count):
            u = v[:, :, q + q_count * np.arange(r)]            # (L, TL, R)
            j = t + q * tl
            k = j % ns
            if ns > 1:
                w = TWIDDLES[(ns * r - 32) + np.arange(r)[None, :] * ns + k[:, None]]
                assert not np.isnan(w).any(), "a twiddle outside the kernels' table"
                u = u * (np.conj(w) if inverse else w)
            u = np.fft.ifft(u, axis=-1) * r if inverse else np.fft.fft(u, axis=-1)
            if last:
                out[:, :, q + q_count * np.arange(r)] = u
            else:
                addr = ((j // ns) * ns * r + k)[:, None] + ns * np.arange(r)[None, :]
                assert addr.max() < n
                a = addr + addr // 16 if pad_row else addr
                np.add.at(written, a.ravel(), 1)
                s[:, a] = u
        if not last:
            assert written.sum() == n and written.max() == 1, "an exchange address written twice"
            pos = t[:, None] + tl * np.arange(e)[None, :]
            v = s[:, pos + pos // 16 if pad_row else pos]
            assert not np.isnan(v).any(), "an exchange read an address no thread wrote"
        ns *= r
    return out


def _to_threads(lines, plan):
    """(L, N) lines in natural order -> (L, line_threads, elems)."""
    return lines.reshape(len(lines), plan.elems, plan.line_threads).transpose(0, 2, 1)


def _from_threads(v):
    return v.transpose(0, 2, 1).reshape(v.shape[0], -1)


def _rows(field, plan, inverse, xperm=None):
    """Transform every row of a (..., N, N) field as a row pass does; xperm:
    the far-field store's permutation of a thread's points (m -> m ^ E/2)."""
    shape = field.shape
    v = _line_transform(_to_threads(field.reshape(-1, plan.n), plan), plan, inverse, True)
    if xperm is not None:
        v = v[:, :, xperm]
    return _from_threads(v).reshape(shape)


def _cols(field, plan, inverse, yperm=None):
    return np.swapaxes(_rows_as_cols(np.swapaxes(field, -1, -2), plan, inverse, yperm), -1, -2)


def _rows_as_cols(field_t, plan, inverse, yperm):
    shape = field_t.shape
    v = _line_transform(_to_threads(field_t.reshape(-1, plan.n), plan), plan, inverse, False)
    if yperm is not None:
        v = v[:, :, yperm]
    return _from_threads(v).reshape(shape)


@pytest.mark.parametrize("pmode", PMODES)
@pytest.mark.parametrize("n", NS)
def test_plan_fits_the_card(n, pmode):
    plan = pass_plan(n, pmode)
    assert int(np.prod(plan.radices)) == n
    assert all(plan.elems % r == 0 for r in plan.radices)
    assert plan.elems * plan.line_threads == n
    for threads, smem in ((plan.row_threads, plan.row_smem), (plan.col_threads, plan.col_smem)):
        assert 1 <= threads <= 1024
        assert 0 <= smem <= SMEM_LIMIT
    # a row's exchange stays inside one warp (__syncwarp), whole warps per group
    assert plan.line_threads <= 32 and 32 % plan.line_threads == 0
    assert plan.groups == min(pmode, 4)
    if len(plan.radices) > 1:
        assert plan.row_threads == 32 * plan.groups
    assert n % plan.rows == 0 and n % plan.cols == 0


@pytest.mark.parametrize("pmode", PMODES)
@pytest.mark.parametrize("n", NS)
def test_blocks_cover_the_field_once(n, pmode):
    plan = pass_plan(n, pmode)
    tl, e = plan.line_threads, plan.elems
    m = np.arange(e)
    # row pass: block (bx, b), thread (group, line, t); group g takes modes
    # g, g + groups, ...
    hits = np.zeros((B, pmode, n, n), int)
    gx, gb = n // plan.rows, B
    group_threads = plan.row_threads // plan.groups
    tid = np.arange(plan.row_threads)
    group, line, t = tid // group_threads, (tid % group_threads) // tl, tid % tl
    for bx in range(gx):
        y = bx * plan.rows + line
        x = t[:, None] + tl * m[None, :]
        for b in range(gb):
            for g in range(plan.groups):
                mine = group == g
                for p in range(g, pmode, plan.groups):
                    np.add.at(hits[b, p], (np.broadcast_to(y[mine, None], x[mine].shape),
                                           x[mine]), 1)
    assert (hits == 1).all()
    # column pass: block (cx, p, b), thread (column c, t)
    hits[:] = 0
    gx, gp, gb = n // plan.cols, pmode, B
    tid = np.arange(plan.col_threads)
    c, t = tid % plan.cols, tid // plan.cols
    for cx in range(gx):
        x = cx * plan.cols + c
        y = t[:, None] + tl * m[None, :]
        for p in range(gp):
            for b in range(gb):
                np.add.at(hits[b, p], (y, np.broadcast_to(x[:, None], y.shape)), 1)
    assert (hits == 1).all()


def _assert_close(actual, expected):
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n", NS)
def test_emulated_passes_match_numpy(n):
    """One propagation as the kernels order it: the row pass's row FFT, the
    column pass's column FFT, H / N^2 in natural order, the column IFFT, and
    the next row pass's row IFFT; then the far-field exit: the row FFT
    stored with x at (k + N/2) % N and the exit's column pass storing row ky
    at (ky + N/2) % N. Two modes: a line's transform is the same for any."""
    pmode = 2
    plan = pass_plan(n, pmode)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((pmode, n, n)) + 1j * rng.standard_normal((pmode, n, n))
    h = np.exp(1j * rng.uniform(0, 6, (n, n)))

    field = _rows(x, plan, False)
    field = _cols(field, plan, False)
    field = field * h / (n * n)  # position (y, x) holds frequency (ky, kx)
    field = _cols(field, plan, True)
    field = _rows(field, plan, True)
    _assert_close(field, np.fft.ifft2(h * np.fft.fft2(x)))

    half = np.arange(plan.elems) ^ (plan.elems // 2)
    exit_ = _cols(_rows(x, plan, False, xperm=half), plan, False, yperm=half)
    _assert_close(exit_, np.fft.fftshift(np.fft.fft2(x), axes=(-2, -1)))
    # the exit's adjoint: rows loaded through the same map, inverse column
    # transform, the row load through the x map and the inverse row transform
    g = rng.standard_normal((pmode, n, n)) + 1j * rng.standard_normal((pmode, n, n))
    back = _cols(np.swapaxes(np.swapaxes(g, -1, -2)[..., _load_map(plan)], -1, -2), plan, True)
    back = _rows(back[..., _load_map(plan)], plan, True)
    _assert_close(back, np.conj(np.fft.fft2(np.conj(np.fft.ifftshift(g, axes=(-2, -1))))))


def _load_map(plan):
    """Positions a thread loads for the exit's adjoint: its point m from
    position t + line_threads * (m ^ E/2), as an index over a whole line."""
    tl, e = plan.line_threads, plan.elems
    t, m = np.meshgrid(np.arange(tl), np.arange(e), indexing="ij")
    src = (t + tl * (m ^ (e // 2))).ravel()
    dst = (t + tl * m).ravel()
    idx = np.empty(plan.n, int)
    idx[dst] = src
    return idx


def test_pass_plan_rejects_other_sizes():
    """The plan and the kernels' set-up take N a power of two up to 512 and
    refuse any other before they touch a device."""
    for n in (1, 96, 1024):
        with pytest.raises(ValueError, match="power of two"):
            pass_plan(n)
        with pytest.raises(ValueError, match="power of two"):
            C.prepare("cpu", n)
