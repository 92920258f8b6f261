"""The line plans of the fused chain kernels (B3/B4, ``csrc/multislice.cu``)
at N that is not a power of two, and the compile flags that build them.

A power of two N keeps the radix-2 pair of ``csrc/reg_fft.cuh`` (``line_dif``,
``line_dit``), whose plan ``multislice.cu`` fixes itself. Every other N in
[2, 128] runs the mixed-radix pair (``line_dif_mr``, ``line_dit_mr``): the
N-point transform is an in-place decimation in frequency, one stage per
prime factor (its conjugate transpose, stage by stage backwards, is the
inverse), and ``mixed_plan`` groups the stages into passes:

- a register pass runs stages of radix 2, 3, 5 and 7 (unrolled butterflies)
  on points the thread holds: the pass's radices multiply to R, the line
  splits into K = N / R cosets of R points (the positions that differ only
  in the pass's digits), and thread t of the line's T takes cosets
  t, t + T, ... (slot u holds coset t + T u while that is below K);
- a sum pass runs the one stage of a prime p above 7 as direct sums, each
  output reading its p inputs from the line's slots with twiddles from a
  table: O(p) a point, so every N has a plan (N = 127 is one sum pass).

Between two passes the line goes once through its own slots of the field
(an exchange). The forward leaves the frequency ``digitrev(position)`` in
each register (the position written in the stages' mixed radix, its digits
reversed), as the radix-2 pair leaves bitrev. The plan is chosen here and
handed to nvcc as macros in a generated source (``plan_source``): each N
has its own build (``ops/_build.mixed_lib``) and ``ptyrad_fused_plan``
reports what it compiled. Python and NumPy alone: the tests import it
without a card.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

MAX_N = 128          # a padded 128^2 complex64 wavefield fills 139 KB of a block's shared memory
SMALL = (2, 3, 5, 7)  # radices with unrolled butterflies; a larger prime is a sum pass
MAX_LINE_THREADS = 16  # a column group (32 columns, T warps) fits the backward block
FWD_THREADS, BWD_THREADS = 1024, 512  # multislice.cu kFwdThreads, kBwdThreads
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
NAMED_BARRIERS = 15   # bar.sync ids 1 ... 15 (0 is __syncthreads)


def is_pow2(n: int) -> bool:
    return n >= 1 and not n & (n - 1)


def primes(n: int) -> list:
    """The prime factors of n, ascending, with multiplicity."""
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return out + ([n] if n > 1 else [])


PAD_SHIFTS = (4, 5, 6, 31)  # a row's element a at a + (a >> s); 31: no padding


def pad(a, shift: int = 4):
    """A row's element a sits at a + (a >> shift) (the field's padding; the
    radix-2 pair's is a + a // 16)."""
    return a + (a >> shift)


@dataclasses.dataclass(frozen=True)
class Pass:
    """A pass of a line transform: its stages' radices, first stage (the
    largest span) first; ``sum``: one prime above 7, as direct sums."""

    radices: tuple
    sum: bool = False


@dataclasses.dataclass(frozen=True)
class Block:
    """A chain block's threads and how a phase covers the N lines: ``rows``
    rows a warp (T threads each), ``groups`` column groups of 32 columns
    (T warps each, one named barrier), and the sweeps of each phase."""

    threads: int
    rows_per_warp: int
    groups: int
    row_sweeps: int
    col_sweeps: int


@dataclasses.dataclass(frozen=True)
class MixedPlan:
    """How T threads transform an N-point line with the mixed-radix pair,
    and how a chain block of multislice.cu holds the N x N field."""

    n: int
    line_threads: int   # T
    passes: tuple       # of Pass
    line: int           # a padded row of the field, in elements
    pad_shift: int = 4  # element a of a row at a + (a >> pad_shift)

    @property
    def radices(self) -> tuple:
        return tuple(r for p in self.passes for r in p.radices)

    def geometry(self, k: int) -> tuple:
        """(R, H, L, K, c) of pass k: the product of its radices, of the
        earlier passes', the span below it (N / (H R)), its cosets N / R and
        the coset slots a thread has (ceil(K / T); a sum pass: the
        ceil(N / T) points a thread computes)."""
        r = math.prod(self.passes[k].radices)
        h = math.prod(math.prod(p.radices) for p in self.passes[:k])
        big_k = self.n // r
        c = -(-self.n // self.line_threads) if self.passes[k].sum else \
            -(-big_k // self.line_threads)
        return r, h, self.n // (h * r), big_k, c

    def pass_elems(self, k: int) -> int:
        r, _, _, _, c = self.geometry(k)
        return c if self.passes[k].sum else c * r

    @property
    def elems(self) -> int:
        """E: the registers of a line a thread holds (the largest pass's)."""
        return max(self.pass_elems(k) for k in range(len(self.passes)))

    def layout(self, k: int, t: int):
        """Line positions of thread t's registers in pass k's layout:
        (positions, valid), each of length elems; register u + c D of a
        register pass holds point D of slot u's coset, register j of a sum
        pass position t + T j."""
        r, _, span, big_k, c = self.geometry(k)
        e = self.elems
        pos, ok = [0] * e, [False] * e
        if self.passes[k].sum:
            for j in range(c):
                p = t + self.line_threads * j
                if p < self.n:
                    pos[j], ok[j] = p, True
            return pos, ok
        for u in range(c):
            kappa = t + self.line_threads * u
            if kappa >= big_k:
                continue
            for d in range(r):
                m = u + c * d
                pos[m] = (kappa // span) * r * span + d * span + kappa % span
                ok[m] = True
        return pos, ok

    def points(self, t: int):
        """Thread t's points: the first pass's layout."""
        return self.layout(0, t)

    def frequencies(self, t: int):
        """The frequencies the forward leaves in thread t's registers."""
        pos, ok = self.layout(len(self.passes) - 1, t)
        return [digitrev(p, self.radices) for p in pos], ok

    def block(self, max_threads: int) -> Block:
        """multislice.cu's block geometry for a block of at most
        max_threads threads."""
        t = self.line_threads
        rpw = 32 // t
        w_max = (max_threads // 32) // t * t
        if t > 1:
            w_max = min(w_max, NAMED_BARRIERS * t)
        need = max(-(-self.n // rpw), t * -(-self.n // 32))
        w = min(w_max, -(-need // t) * t)
        return Block(threads=32 * w, rows_per_warp=rpw, groups=w // t,
                     row_sweeps=-(-self.n // (w * rpw)), col_sweeps=-(-self.n // (32 * (w // t))))

    @property
    def exchanges(self) -> int:
        """Trips of a line transform through the line's slots."""
        return len(self.passes) - 1 + int(self.passes[0].sum)

    @property
    def smem(self) -> int:
        return 8 * self.n * self.line


def digitrev(p: int, radices) -> int:
    """The frequency an in-place decimation in frequency with these stage
    radices leaves at position p: p's digits (the first stage's most
    significant) reversed, f = d_1 + r_1 d_2 + r_1 r_2 d_3 + ..."""
    f, scale, span = 0, 1, math.prod(radices)
    for r in radices:
        span //= r
        f += (p // span % r) * scale
        scale *= r
    return f


def _passes_of(n: int):
    """Candidate pass sequences for N: one register pass (N <= 16 and
    7-smooth), two register passes over a split N = R_A R_B, three register
    passes over the prime factors, largest first, or a register pass of N's
    7-smooth part with a sum pass of each prime above 7, on either side."""
    ps = primes(n)
    small = [p for p in ps if p in SMALL]
    big = [p for p in ps if p not in SMALL]
    if not big:
        if n <= 16:
            yield (Pass(tuple(sorted(small, reverse=True))),)
        for d in range(2, n):
            if n % d == 0:
                yield (Pass(tuple(sorted(primes(d), reverse=True))),
                       Pass(tuple(sorted(primes(n // d), reverse=True))))
        if len(small) >= 3:
            # the prime factors split three ways, largest radices first
            for cut1 in range(1, len(small) - 1):
                for cut2 in range(cut1 + 1, len(small)):
                    order = sorted(small, reverse=True)
                    yield (Pass(tuple(order[:cut1])), Pass(tuple(order[cut1:cut2])),
                           Pass(tuple(order[cut2:])))
        return
    sums = tuple(Pass((p,), True) for p in big)
    if not small:
        yield sums
        return
    reg = (Pass(tuple(sorted(small, reverse=True))),)
    yield reg + sums
    yield sums + reg


def _cost(plan: MixedPlan) -> tuple:
    """Registers above 16 first, then exchanges, then the thread-slots of a
    forward block's phases times the registers each works on, then
    ragged slots."""
    fwd = plan.block(FWD_THREADS)
    e = plan.elems
    work = (fwd.row_sweeps + fwd.col_sweeps) * fwd.threads * e
    return (max(e - 16, 0), plan.exchanges, work, e * plan.line_threads)


def wavefronts(plan: MixedPlan) -> tuple:
    """(wavefronts, least) of the forward block's first row sweep: every
    warp's access of each register in each layout a thread uses (its
    points, each pass's layout, its frequencies) at element addresses
    y * line + pad(position), as shared-memory transactions of 8-byte
    elements, a half-warp at a time (as many as the most distinct elements
    that share a bank pair), against one per half-warp that has any. The
    column phase's accesses (32 adjacent columns of one row) always take
    the least."""
    tl, rpw = plan.line_threads, 32 // plan.line_threads
    warps = plan.block(FWD_THREADS).threads // 32
    views = [plan.layout(k, t) for k in range(len(plan.passes)) for t in range(tl)]
    views = [views[:tl]] + [views[k * tl:(k + 1) * tl] for k in range(len(plan.passes))]
    views.append([plan.frequencies(t) for t in range(tl)])
    pos = np.array([[v[0] for v in view] for view in views])  # (layouts, T, E)
    ok = np.array([[v[1] for v in view] for view in views])
    lane = np.arange(32)
    row, t = lane // tl, lane % tl
    y = np.arange(warps)[:, None] * rpw + row[None, :]  # (warps, 32)
    live = (row < rpw)[None, :] & (y < plan.n)
    p = pos[:, t, :].transpose(0, 2, 1)[:, :, None, :]  # (layouts, E, 1, 32)
    use = ok[:, t, :].transpose(0, 2, 1)[:, :, None, :] & live[None, None]
    addr = y[None, None] * plan.line + pad(p, plan.pad_shift)
    return bank_wavefronts(np.where(use, addr, -1))


def bank_wavefronts(addr) -> tuple:
    """(wavefronts, least) of warp accesses of 8-byte elements at element
    addresses addr (..., 32 lanes; -1 for a lane that does not access): a
    half-warp at a time, as many as the most distinct elements that share a
    bank pair, against one per half-warp that has any."""
    half = np.sort(np.asarray(addr).reshape(-1, 16), axis=1)  # half-warps
    first = half >= 0
    first[:, 1:] &= half[:, 1:] != half[:, :-1]  # each distinct element once
    banks = np.zeros((half.shape[0], 16), int)
    rows = np.broadcast_to(np.arange(half.shape[0])[:, None], half.shape)
    np.add.at(banks, (rows[first], half[first] % 16), 1)
    return int(banks.max(axis=1).sum()), int(first.any(axis=1).sum())


@functools.lru_cache(maxsize=None)
def mixed_plan(n: int) -> MixedPlan:
    """The mixed-radix plan multislice.cu builds for N (2 <= N <= 128, not a
    power of two): the cheapest pass sequence and line threads T <= 16 by
    _cost, then the row padding (PAD_SHIFTS) and the padded row length,
    from pad(N - 1) + 1 up, with the fewest row-phase wavefronts (the
    shortest row among equals)."""
    if not 2 <= n <= MAX_N or is_pow2(n):
        raise ValueError(f"mixed_plan: N must be in [2, {MAX_N}] and not a power of two, got {n}")
    best = None
    for passes in _passes_of(n):
        for t in range(1, MAX_LINE_THREADS + 1):
            if len(passes) > 1 and t == 1 and n > 16:
                continue
            plan = MixedPlan(n, t, passes, n)
            if plan.exchanges and t == 1 and plan.elems > 16:
                continue
            cost = _cost(plan)
            if best is None or cost < best[0]:
                best = (cost, plan)
    plan = best[1]
    lines = [dataclasses.replace(plan, line=pad(n - 1, s) + 1 + d, pad_shift=s)
             for s in PAD_SHIFTS for d in range(16)]
    return min(lines, key=lambda p: (wavefronts(p)[0], p.line, -p.pad_shift))


def plan_source(n: int, bf16_operands: bool = False) -> str:
    """The source that compiles multislice.cu for N's mixed plan (its
    _bf16 twin with bf16_operands): the line type
    (regfft::MixedLine<N, T, passes...>), the padded row and the row
    padding's shift as macros, then the kernel file. A file, since nvcc
    splits a -D value at its commas."""
    plan = mixed_plan(n)
    passes = ", ".join(f"regfft::Pass<{str(p.sum).lower()}, {', '.join(map(str, p.radices))}>"
                       for p in plan.passes)
    return (f"// multislice.cu at N = {n}: ops/fused_plan.py's mixed-radix plan\n"
            + ("#define PTYRAD_BF16_OPERANDS 1\n" if bf16_operands else "")
            + f"#define PTYRAD_MIXED_LINE regfft::MixedLine<{n}, {plan.line_threads}, {passes}>\n"
            f"#define PTYRAD_MIXED_ROW {plan.line}\n"
            f"#define PTYRAD_MIXED_PAD {plan.pad_shift}\n"
            '#include "multislice.cu"\n')
