"""The line plans of the segmented chain kernels (B5/B6, ``csrc/chain.cu``)
at N in (128, 512] that is not a power of two, and the source that builds
them.

A power of two N keeps chain.cu's own Stockham plan (``Plan<LOGN>``). Every
other N in (128, 512] runs the mixed-radix pair of ``csrc/reg_fft.cuh``
(``line_dif_mr`` forward, ``line_dit_mr`` its conjugate transpose) that
``ops/fused_plan.py`` describes for the fused kernels: one in-place stage
per prime factor, register passes of radix 2, 3, 5 and 7 on whole cosets,
an exchange through shared memory between passes (a larger prime takes
the Bluestein line below). Its candidates and its layouts are
fused_plan's (``Pass``, ``_passes_of``, ``MixedPlan``); what differs is the
chain's pass structure.
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

Where N has a prime factor above 7 the plan is a Bluestein line
(``reg_fft.cuh`` ``BluesteinLine``): the chirp-z identity turns the
N-point transform into a cyclic convolution over the least 7-smooth
M >= 2 N - 1 that has a plan that fits, two M-point mixed-radix lines of
register passes (``line`` is then that M-point plan) and three pointwise
products with tables the library computes in double precision
(``bluestein_tables`` restates them). Its spectrum is in natural order
(``perm`` is the identity), in the layout the points went in, and its
slots in an exchange are M. It takes every such N in place of the sum
pass of the prime (O(p) a point): timed against it on an H100 80GB HBM3 at
700 W (PERF.md; chain_bench.py --chain-n), the sum pass was ahead by at
most 10% (130, 495) and behind by up to 1.7x (136, 152, 176), and by 7x
or more at 254 and 509.

``chain_plan`` chooses the plan, ``plan_source`` hands it to nvcc as macros
(a library per N, ``ops/_build.mixed_lib``), and ``ptyrad_chain_plan``
reports what the library compiled. Python and NumPy alone: the tests import
it without a card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ptyrad_tpu_torch.ops import fused_plan
from ptyrad_tpu_torch.ops.fused_plan import (PAD_SHIFTS, MixedPlan, _passes_of, bank_wavefronts,
                                             digitrev, is_pow2, pad, pass_layouts, smooth)

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
    passes, the padded row of the row pass's exchange and its shift); for a
    Bluestein plan the M-point line inside it (``slots`` = M > N)."""

    line: MixedPlan
    n: int

    @property
    def bluestein(self) -> bool:
        return self.line.n != self.n

    @property
    def slots(self) -> int:
        """A line's slots in an exchange: N, or the Bluestein line's M."""
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
        """Bytes: the column tile, slot a of column c at a * COLS + c."""
        return 8 * COLS * self.slots

    @property
    def row_blocks(self) -> int:
        return -(-self.n // self.rows)

    @property
    def col_blocks(self) -> int:
        return -(-self.n // COLS)

    def layouts(self):
        """(positions, valid), each (2, T, E): the line positions of each
        thread's registers when they hold its points (0) and the spectrum
        (1). A Bluestein line keeps both in its inner first pass's layout,
        below N."""
        pos, ok = pass_layouts(self.line)
        if not self.bluestein:
            return pos[[0, -1]], ok[[0, -1]]
        pos0, ok0 = pos[0], ok[0] & (pos[0] < self.n)
        return np.stack([pos0, pos0]), np.stack([ok0, ok0])

    @property
    def perm(self) -> np.ndarray:
        """perm[p] = the frequency the forward leaves at position p: H is
        handed to the kernels as H[perm][:, perm] (a Bluestein line's is
        the identity)."""
        if self.bluestein:
            return np.arange(self.n)
        return np.array([digitrev(p, self.line.radices) for p in range(self.n)])

    def reported(self, pmode: int) -> tuple:
        """What ptyrad_chain_plan writes for pmode probe modes."""
        return (self.n, self.elems, self.line_threads, len(self.line.passes),
                len(self.line.radices), self.rows, COLS, self.row_threads(pmode),
                self.col_threads, self.row_smem(pmode), self.col_smem, self.line.line,
                self.line.pad_shift, self.slots)


def _cost(plan: ChainPlan) -> tuple:
    """Registers above 16 first, then exchanges, then the thread-registers
    of both passes a line takes (a row pass's warp spends 32 lanes on 32 // T
    lines), then fewer threads a line."""
    line = plan.line
    e, t = line.elems, line.line_threads
    work = line.n * e * (32 / (32 // t) + t)
    return (max(e - 16, 0), line.exchanges, work, t)


def wavefronts(plan: MixedPlan, layouts=None) -> tuple:
    """(wavefronts, least) of one row-pass warp's shared-memory accesses
    (fused_plan.bank_wavefronts): each register's store or load in each
    layout of its exchanges, its rows' lines at row * line + pad(position).
    Every warp of a block is alike up to a constant offset, which moves no
    element to another bank pair's share."""
    pos, ok = layouts if layouts is not None else pass_layouts(plan)
    tl = plan.line_threads
    lane = np.arange(32)
    row, t = lane // tl, lane % tl
    live = row < 32 // tl
    p = pos[:, t, :].transpose(0, 2, 1)      # (layouts, E, 32)
    use = ok[:, t, :].transpose(0, 2, 1) & live[None, None]
    addr = row[None, None] * plan.line + pad(p, plan.pad_shift)
    return bank_wavefronts(np.where(use, addr, -1))


def _fitting(n: int, size: int, passes):
    """The plans of an N-point chain line over ``size`` points with these
    passes and T <= 32 threads that hold at most 32 registers a thread."""
    for t in range(2, MAX_LINE_THREADS + 1):
        plan = ChainPlan(MixedPlan(size, t, passes, size), n)
        if plan.elems <= MAX_ELEMS:
            yield plan


def _candidates(n: int):
    """Every plan chain.cu's mixed build could compile for N: the pass
    sequences of a 7-smooth N, else the Bluestein line over the least
    7-smooth M >= 2 N - 1 that has a plan that fits (a power of two
    M <= 1,024 always does)."""
    if smooth(n):
        yield from (plan for passes in _passes_of(n) for plan in _fitting(n, n, passes))
        return
    for m in (m for m in range(2 * n - 1, 1 << (2 * n - 2).bit_length() + 1) if smooth(m)):
        plans = [plan for passes in _passes_of(m) for plan in _fitting(n, m, passes)]
        if plans:
            yield from plans
            return


@functools.lru_cache(maxsize=None)
def chain_plan(n: int) -> ChainPlan:
    """The plan chain.cu's mixed build compiles for N (in (128, 512], not a
    power of two): the cheapest candidate by _cost, then the row padding
    (PAD_SHIFTS) and the padded row, from pad(slots - 1) + 1 up, with the
    fewest wavefronts of a row-pass warp (the shortest row among equals)."""
    if not takes(n):
        raise ValueError(f"chain_plan: N must be in ({MIN_N - 1}, {MAX_N}] and not a power of "
                         f"two, got {n}")
    plan = min(_candidates(n), key=_cost)
    line, size = plan.line, plan.slots
    lays = pass_layouts(line)
    lines = [dataclasses.replace(line, line=pad(size - 1, s) + 1 + d, pad_shift=s)
             for s in PAD_SHIFTS for d in range(16)]
    best = min(lines, key=lambda p: (wavefronts(p, lays)[0], p.line, -p.pad_shift))
    return ChainPlan(best, n)


def bluestein_tables(n: int) -> tuple:
    """The Bluestein line's tables as the library computes them (reg_fft.cuh
    upload_bluestein), in double precision before the rounding to float32:
    the chirp c_j = exp(-i pi (j^2 mod 2N) / N) for j < N, and the filter,
    the spectrum over M of g_j = conj(c_|j|) (|j| < N, cyclic) divided by M,
    at inner position p the frequency digitrev(p)."""
    plan = chain_plan(n)
    if not plan.bluestein:
        raise ValueError(f"bluestein_tables: N = {n} has no Bluestein plan")
    return fused_plan.bluestein_tables(n, plan.line)


def plan_source(n: int, bf16_operands: bool = False) -> str:
    """The source that compiles chain.cu for N's mixed plan (its _bf16 twin
    with bf16_operands): the line type (regfft::MixedLine<N, T,
    passes...>, or for a Bluestein plan PTYRAD_BLUESTEIN and
    regfft::BluesteinLine<N, the M-point MixedLine>), the padded row and the
    padding's shift as macros, then the kernel file. A file, since nvcc
    splits a -D value at its commas."""
    plan = chain_plan(n)
    line = plan.line
    mixed = fused_plan.mixed_line_type(line)
    return (f"// chain.cu at N = {n}: ops/chain_plan.py's mixed-radix plan\n"
            + ("#define PTYRAD_BF16_OPERANDS 1\n" if bf16_operands else "")
            + ("#define PTYRAD_BLUESTEIN 1\n" if plan.bluestein else "")
            + "#define PTYRAD_MIXED_LINE "
            + (f"regfft::BluesteinLine<{n}, {mixed}>\n" if plan.bluestein else f"{mixed}\n")
            + f"#define PTYRAD_MIXED_ROW {line.line}\n"
            f"#define PTYRAD_MIXED_PAD {line.pad_shift}\n"
            '#include "chain.cu"\n')
