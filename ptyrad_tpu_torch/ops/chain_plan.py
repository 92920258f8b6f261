"""The line plans of the segmented chain kernels (B5/B6, ``csrc/chain.cu``)
at N in (128, 512] that is not a power of two, and the source that builds
them.

A power of two N keeps chain.cu's own Stockham plan (``Plan<LOGN>``). Every
other N in (128, 512] runs the mixed-radix pair of ``csrc/reg_fft.cuh``
(``line_dif_mr`` forward, ``line_dit_mr`` its conjugate transpose) that
``ops/fused_plan.py`` describes for the fused kernels: one in-place stage
per prime factor, register passes of radix 2, 3, 5 and 7 on whole cosets
and sum passes of a larger prime, an exchange through shared memory between
passes. Its candidates and its layouts are fused_plan's (``Pass``,
``_passes_of``, ``MixedPlan``); what differs is the chain's pass structure.
The field is too large for one block, so it moves through device memory in
a row pass and a column pass per slice:

- a row-pass block holds ``rows = 32 // T`` rows of one sample for each of
  G = min(pmode, 4) mode groups, a warp each; a row's T threads are
  adjacent lanes and its exchange waits on ``__syncwarp`` (T <= 32, lanes
  past rows * T idle), on a padded line of shared memory per row (element
  a at a + (a >> pad_shift));
- a column-pass block holds 16 adjacent columns (16 x 8 B = 128 B of a row)
  with T threads each, the column fastest across threads; its exchange is
  the tile interleaved by column and waits on ``__syncthreads``.

The forward leaves frequency ``digitrev(position)`` at each position of a
line, on both axes, and the field between passes stays in that order along
x and in natural order along y; the column pass multiplies H where the
transforms leave it, so the kernels take H gathered with ``perm`` on both
axes (as the JAX chain pre-permutes H for its radix passes,
``ptyrad_tpu/ops/pallas_chain.py:1287-1294``), and the dH they return is in
that order (its gather's adjoint puts it back). The far-field exit stores
frequency f at (f + N // 2) % N on both axes, fftshift's roll at any N.

``chain_plan`` chooses the plan, ``plan_source`` hands it to nvcc as macros
(a library per N, ``ops/_build.mixed_lib``), and ``ptyrad_chain_plan``
reports what the library compiled. Python and NumPy alone: the tests import
it without a card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ptyrad_tpu_torch.ops.fused_plan import (PAD_SHIFTS, SMALL, MixedPlan, Pass, _passes_of,
                                             bank_wavefronts, digitrev, is_pow2, pad, primes)

MIN_N, MAX_N = 129, 512  # below, the fused kernels' mixed pair takes every N
MAX_LINE_THREADS = 32    # a row's line stays inside one warp
MAX_ELEMS = 32           # reg_fft.cuh MixedLine's register budget
MAX_GROUPS = 4           # chain.cu: mode groups (warps) of a row-pass block
COLS = 16                # adjacent columns of a column-pass block
SMEM_LIMIT = 232_448     # bytes of shared memory one block may use on an H100


def takes(n: int) -> bool:
    """Whether the mixed build serves N: (128, 512] and not a power of two."""
    return MIN_N <= n <= MAX_N and not is_pow2(n)


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How chain.cu's mixed build transforms the N-point lines of its row
    and column passes: ``line`` is the line transform (T threads, the
    passes, the padded row of the row pass's exchange and its shift)."""

    line: MixedPlan

    @property
    def n(self) -> int:
        return self.line.n

    @property
    def elems(self) -> int:
        return self.line.elems

    @property
    def line_threads(self) -> int:
        return self.line.line_threads

    @property
    def rows(self) -> int:
        """Rows a row-pass block holds (one warp's worth of lines)."""
        return 32 // self.line_threads

    @staticmethod
    def groups(pmode: int) -> int:
        return min(pmode, MAX_GROUPS)

    def row_threads(self, pmode: int) -> int:
        return 32 * self.groups(pmode)

    def row_smem(self, pmode: int) -> int:
        """Bytes: the block's T tile, then one padded line per row and group."""
        return 8 * (self.rows * self.n + self.groups(pmode) * self.rows * self.line.line)

    @property
    def col_threads(self) -> int:
        return COLS * self.line_threads

    @property
    def col_smem(self) -> int:
        """Bytes: the column tile, element a of column c at a * COLS + c."""
        return 8 * COLS * self.n

    @property
    def row_blocks(self) -> int:
        return -(-self.n // self.rows)

    @property
    def col_blocks(self) -> int:
        return -(-self.n // COLS)

    @property
    def perm(self) -> np.ndarray:
        """perm[p] = the frequency the forward leaves at position p: H is
        handed to the kernels as H[perm][:, perm]."""
        return np.array([digitrev(p, self.line.radices) for p in range(self.n)])

    def reported(self, pmode: int) -> tuple:
        """What ptyrad_chain_plan writes for pmode probe modes."""
        return (self.n, self.elems, self.line_threads, len(self.line.passes),
                len(self.line.radices), self.rows, COLS, self.row_threads(pmode),
                self.col_threads, self.row_smem(pmode), self.col_smem, self.line.line,
                self.line.pad_shift)


def _passes(n: int):
    """fused_plan's candidate pass sequences for N, and where N has a prime
    above 7, its 7-smooth part split into two register passes too (before,
    after or around the sum passes): at 385 = 7 * 5 * 11 one register pass
    of 35 would hold 35 points a thread."""
    yield from _passes_of(n)
    small = sorted((p for p in primes(n) if p in SMALL), reverse=True)
    sums = tuple(Pass((p,), True) for p in primes(n) if p not in SMALL)
    if not sums:
        return
    for cut in range(1, len(small)):
        a, b = Pass(tuple(small[:cut])), Pass(tuple(small[cut:]))
        yield (a, b) + sums
        yield sums + (a, b)
        yield (a,) + sums + (b,)


def _cost(plan: MixedPlan) -> tuple:
    """Registers above 16 first, then exchanges, then the thread-registers
    of both passes a line takes (a row pass's warp spends 32 lanes on 32 // T
    lines), then fewer threads a line."""
    e, t = plan.elems, plan.line_threads
    work = plan.n * e * (32 / (32 // t) + t)
    return (max(e - 16, 0), plan.exchanges, work, t)


def _layouts(plan: MixedPlan):
    """(positions, valid), each (layouts, T, E): every layout a row thread
    uses (its points, each pass's layout, the frequencies' which is the last
    pass's)."""
    tl, k = plan.line_threads, len(plan.passes)
    lays = [[plan.layout(j, t) for t in range(tl)] for j in range(k)]
    pos = np.array([[p for p, _ in lay] for lay in lays])
    ok = np.array([[o for _, o in lay] for lay in lays], bool)
    return pos, ok


def wavefronts(plan: MixedPlan, layouts=None) -> tuple:
    """(wavefronts, least) of one row-pass warp's shared-memory accesses
    (fused_plan.bank_wavefronts): each register's store or load in each
    layout of its exchanges, its rows' lines at row * line + pad(position).
    Every warp of a block is alike up to a constant offset, which moves no
    element to another bank pair's share."""
    pos, ok = layouts if layouts is not None else _layouts(plan)
    tl = plan.line_threads
    lane = np.arange(32)
    row, t = lane // tl, lane % tl
    live = row < 32 // tl
    p = pos[:, t, :].transpose(0, 2, 1)      # (layouts, E, 32)
    use = ok[:, t, :].transpose(0, 2, 1) & live[None, None]
    addr = row[None, None] * plan.line + pad(p, plan.pad_shift)
    return bank_wavefronts(np.where(use, addr, -1))


@functools.lru_cache(maxsize=None)
def chain_plan(n: int) -> ChainPlan:
    """The plan chain.cu's mixed build compiles for N (in (128, 512], not a
    power of two): the cheapest pass sequence and T <= 32 by _cost with at
    most 32 registers a thread, then the row padding (PAD_SHIFTS) and the
    padded row, from pad(N - 1) + 1 up, with the fewest wavefronts of a
    row-pass warp (the shortest row among equals)."""
    if not takes(n):
        raise ValueError(f"chain_plan: N must be in ({MIN_N - 1}, {MAX_N}] and not a power of "
                         f"two, got {n}")
    best = None
    for passes in _passes(n):
        for t in range(2, MAX_LINE_THREADS + 1):
            plan = MixedPlan(n, t, passes, n)
            if plan.elems > MAX_ELEMS:
                continue
            cost = _cost(plan)
            if best is None or cost < best[0]:
                best = (cost, plan)
    plan = best[1]
    lays = _layouts(plan)
    lines = [dataclasses.replace(plan, line=pad(n - 1, s) + 1 + d, pad_shift=s)
             for s in PAD_SHIFTS for d in range(16)]
    return ChainPlan(min(lines, key=lambda p: (wavefronts(p, lays)[0], p.line, -p.pad_shift)))


def plan_source(n: int, bf16_operands: bool = False) -> str:
    """The source that compiles chain.cu for N's mixed plan (its _bf16 twin
    with bf16_operands): the line type (regfft::MixedLine<N, T,
    passes...>), the padded row and the padding's shift as macros, then the
    kernel file. A file, since nvcc splits a -D value at its commas."""
    plan = chain_plan(n).line
    passes = ", ".join(f"regfft::Pass<{str(p.sum).lower()}, {', '.join(map(str, p.radices))}>"
                       for p in plan.passes)
    return (f"// chain.cu at N = {n}: ops/chain_plan.py's mixed-radix plan\n"
            + ("#define PTYRAD_BF16_OPERANDS 1\n" if bf16_operands else "")
            + f"#define PTYRAD_MIXED_LINE regfft::MixedLine<{n}, {plan.line_threads}, {passes}>\n"
            f"#define PTYRAD_MIXED_ROW {plan.line}\n"
            f"#define PTYRAD_MIXED_PAD {plan.pad_shift}\n"
            '#include "chain.cu"\n')

