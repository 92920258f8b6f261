"""The line plans of the fused chain kernels (B3/B4, ``csrc/multislice.cu``)
at N that is not a power of two, and the compile flags that build them.

A power of two N keeps the radix-2 pair of ``csrc/reg_fft.cuh`` (``line_dif``,
``line_dit``), whose plan ``multislice.cu`` fixes itself. Every other
7-smooth N in [2, 128] runs the mixed-radix pair (``line_dif_mr``,
``line_dit_mr``): the N-point transform is an in-place decimation in
frequency, one stage per prime factor (its conjugate transpose, stage by
stage backwards, is the inverse), and ``mixed_plan`` groups the stages into
passes. A pass runs stages of radix 2, 3, 5 and 7 (unrolled butterflies)
on points the thread holds: the pass's radices multiply to R, the line
splits into K = N / R cosets of R points (the positions that differ only in
the pass's digits), and thread t of the line's T takes cosets t, t + T, ...
(slot u holds coset t + T u while that is below K).

Between two passes the line goes once through its own slots of the field
(an exchange). The forward leaves the frequency ``digitrev(position)`` in
each register (the position written in the stages' mixed radix, its digits
reversed), as the radix-2 pair leaves bitrev.

Every N with a prime factor above 7 (75 of the 120 N; 127, 122 = 2 x 61,
124 = 4 x 31, ...) runs a Bluestein line (``BluesteinPlan``;
``reg_fft.cuh`` ``BluesteinLine``): the chirp-z identity turns the N-point
transform into a cyclic convolution over a 7-smooth M >= 2 N - 1 (at most
the power of two at or above it; the one whose plan costs least), two
M-point lines of such passes and three pointwise products with tables
computed in double precision (``bluestein_tables``). An M-point line does
not fit the field's N-point row or column, so its exchanges go through a
scratch region of shared memory beside the resident field, and the block
takes fewer threads where field and scratch would not fit otherwise. The
field holds only the line's points and its spectrum, which comes out in
natural order in the points' own layout. Timed on an H100 80GB HBM3 at
700 W against a pass of direct sums over the prime (O(p) a point), the
line ran a training step's B3a + B3b faster at 27 of 29 N, by up to 6.6x,
and slower at 22 and 26 (by 1.87x and 1.29x; PERF.md §6), sizes no
configuration of the repository uses; every such N takes it.

The plan is chosen here and handed to nvcc as macros in a generated source
(``plan_source``): each N has its own build (``ops/_build.mixed_lib``) and
``ptyrad_fused_plan`` reports what it compiled (``reported``). Python and
NumPy alone: the tests import it without a card.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

MAX_N = 128          # a padded 128^2 complex64 wavefield fills 139 KB of a block's shared memory
SMALL = (2, 3, 5, 7)  # radices with unrolled butterflies
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
    largest span) first."""

    radices: tuple


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
        the coset slots a thread has (ceil(K / T))."""
        r = math.prod(self.passes[k].radices)
        h = math.prod(math.prod(p.radices) for p in self.passes[:k])
        big_k = self.n // r
        return r, h, self.n // (h * r), big_k, -(-big_k // self.line_threads)

    def pass_elems(self, k: int) -> int:
        r, _, _, _, c = self.geometry(k)
        return c * r

    @property
    def elems(self) -> int:
        """E: the registers of a line a thread holds (the largest pass's)."""
        return max(self.pass_elems(k) for k in range(len(self.passes)))

    def layout(self, k: int, t: int):
        """Line positions of thread t's registers in pass k's layout:
        (positions, valid), each of length elems; register u + c D holds
        point D of slot u's coset."""
        r, _, span, big_k, c = self.geometry(k)
        e = self.elems
        pos, ok = [0] * e, [False] * e
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
        return _block(self.n, self.line_threads, max_threads)

    @property
    def exchanges(self) -> int:
        """Trips of a line transform through the line's slots."""
        return len(self.passes) - 1

    @property
    def smem(self) -> int:
        return 8 * self.n * self.line

    def field_layouts(self, t: int) -> list:
        """Every layout in which thread t's registers meet the field: its
        points, each pass's layout (the exchanges), its frequencies."""
        return ([self.points(t)] + [self.layout(k, t) for k in range(len(self.passes))]
                + [self.frequencies(t)])


def _block(n: int, t: int, max_threads: int) -> Block:
    """The block geometry of N-point lines of T threads each, at most
    max_threads threads: 32 // T rows a warp, column groups of T warps (one
    named barrier each), the warps one sweep of each phase needs."""
    rpw = 32 // t
    w_max = (max_threads // 32) // t * t
    if t > 1:
        w_max = min(w_max, NAMED_BARRIERS * t)
    need = max(-(-n // rpw), t * -(-n // 32))
    w = min(w_max, -(-need // t) * t)
    return Block(threads=32 * w, rows_per_warp=rpw, groups=w // t,
                 row_sweeps=-(-n // (w * rpw)), col_sweeps=-(-n // (32 * (w // t))))


@dataclasses.dataclass(frozen=True)
class BluesteinPlan:
    """How T threads transform an N-point line whose prime factors include
    one above 7, and how a chain block of multislice.cu holds the field:
    ``inner`` is the M-point line of register passes inside the Bluestein
    line (its T threads and passes; its ``line`` and ``pad_shift`` are those
    of the row phase's scratch line, element a at a + (a >> pad_shift)).
    The field's rows are padded as a mixed plan's (``line``, ``pad_shift``).
    ``max_threads`` caps a block's threads so that the field and the scratch
    fit SMEM_LIMIT: the scratch holds one padded line for each row a row
    phase has in flight, or M slots for each column of a column phase's
    groups (slot a of column c at a * 32 + c), whichever is larger; the two
    phases share it."""

    n: int
    inner: MixedPlan
    line: int
    pad_shift: int = 4
    max_threads: int = FWD_THREADS

    @property
    def slots(self) -> int:
        """M: a line's slots in an inner exchange."""
        return self.inner.n

    @property
    def line_threads(self) -> int:
        return self.inner.line_threads

    @property
    def elems(self) -> int:
        return self.inner.elems

    @property
    def exchanges(self) -> int:
        """Trips of a line transform through its scratch line: two M-point
        transforms."""
        return 2 * self.inner.exchanges

    def points(self, t: int):
        """Thread t's points: the inner first pass's layout below N."""
        pos, ok = self.inner.layout(0, t)
        return pos, [o and p < self.n for p, o in zip(pos, ok)]

    def frequencies(self, t: int):
        """The spectrum comes out in natural order in the points' layout."""
        return self.points(t)

    def field_layouts(self, t: int) -> list:
        return [self.points(t), self.frequencies(t)]

    def block(self, max_threads: int) -> Block:
        return _block(self.n, self.line_threads, min(max_threads, self.max_threads))

    def scratch(self, max_threads: int) -> int:
        """Elements of the scratch of a block of at most max_threads threads."""
        blk = self.block(max_threads)
        rows = blk.threads // 32 * blk.rows_per_warp * self.inner.line
        return max(rows, blk.groups * 32 * self.slots)

    def block_smem(self, max_threads: int) -> int:
        """Bytes of shared memory of a block: the padded field, then the scratch."""
        return 8 * (self.n * self.line + self.scratch(max_threads))

    @property
    def smem(self) -> int:
        return self.block_smem(FWD_THREADS)


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
    """Candidate pass sequences for a 7-smooth N: one pass (N <= 16), two
    passes over a split N = R_A R_B, three passes over the prime factors,
    largest first."""
    small = primes(n)
    if not smooth(n):
        raise ValueError(f"_passes_of: N = {n} has a prime factor above 7")
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


def _cost(plan: MixedPlan) -> tuple:
    """Registers above 16 first, then exchanges, then the thread-slots of a
    forward block's phases times the registers each works on, then
    ragged slots."""
    fwd = plan.block(FWD_THREADS)
    e = plan.elems
    work = (fwd.row_sweeps + fwd.col_sweeps) * fwd.threads * e
    return (max(e - 16, 0), plan.exchanges, work, e * plan.line_threads)


def wavefronts(plan) -> tuple:
    """(wavefronts, least) of the forward block's first row sweep: every
    warp's access of each register in each layout a thread uses on the
    field (its points, each pass's layout, its frequencies) at element
    addresses y * line + pad(position), as shared-memory transactions of
    8-byte elements, a half-warp at a time (as many as the most distinct
    elements that share a bank pair), against one per half-warp that has
    any. The column phase's accesses (32 adjacent columns of one row)
    always take the least."""
    return _sweep_wavefronts(plan, plan.line, plan.pad_shift, *_field_views(plan))


def _field_views(plan):
    """(positions, valid), each (layouts, T, E), of plan.field_layouts."""
    views = [plan.field_layouts(t) for t in range(plan.line_threads)]
    pos = np.array([[v[j][0] for v in views] for j in range(len(views[0]))])
    ok = np.array([[v[j][1] for v in views] for j in range(len(views[0]))])
    return pos, ok


def _sweep_wavefronts(plan, line: int, shift: int, pos, ok) -> tuple:
    """(wavefronts, least) of the forward block's first row sweep's accesses
    of rows of ``line`` elements padded by ``shift`` (the field's, or the
    scratch's: row y of the first sweep owns scratch line y) in the layouts
    pos, ok (layouts, T, E)."""
    tl, rpw = plan.line_threads, 32 // plan.line_threads
    warps = plan.block(FWD_THREADS).threads // 32
    lane = np.arange(32)
    row, t = lane // tl, lane % tl
    y = np.arange(warps)[:, None] * rpw + row[None, :]  # (warps, 32)
    live = (row < rpw)[None, :] & (y < plan.n)
    p = pos[:, t, :].transpose(0, 2, 1)[:, :, None, :]  # (layouts, E, 1, 32)
    use = ok[:, t, :].transpose(0, 2, 1)[:, :, None, :] & live[None, None]
    addr = y[None, None] * line + pad(p, shift)
    return bank_wavefronts(np.where(use, addr, -1))


def bank_wavefronts(addr) -> tuple:
    """(wavefronts, least) of warp accesses of 8-byte elements at element
    addresses addr (..., 32 lanes; -1 for a lane that does not access): a
    half-warp at a time, as many as the most distinct elements that share a
    bank pair, against one per half-warp that has any."""
    half = np.sort(np.asarray(addr).reshape(-1, 16), axis=1)  # half-warps
    first = half >= 0
    first[:, 1:] &= half[:, 1:] != half[:, :-1]  # each distinct element once
    rows = np.broadcast_to(np.arange(half.shape[0])[:, None], half.shape)
    banks = np.bincount((rows * 16 + half % 16)[first], minlength=half.size).reshape(-1, 16)
    return int(banks.max(axis=1).sum()), int(first.any(axis=1).sum())


def smooth(n: int) -> bool:
    """Whether N's prime factors are all 2, 3, 5 or 7."""
    return all(p in SMALL for p in primes(n))


def pass_layouts(plan: MixedPlan):
    """(positions, valid), each (passes, T, E): every pass's layout of
    thread t's registers (the first holds its points, the last its
    frequencies)."""
    tl, k = plan.line_threads, len(plan.passes)
    lays = [[plan.layout(j, t) for t in range(tl)] for j in range(k)]
    pos = np.array([[p for p, _ in lay] for lay in lays])
    ok = np.array([[o for _, o in lay] for lay in lays], bool)
    return pos, ok


def scratch_wavefronts(plan: BluesteinPlan, layouts=None) -> tuple:
    """(wavefronts, least) of the forward block's first row sweep's accesses
    of the scratch: each register's store or load in each of the inner
    line's pass layouts, row y's scratch line at y * inner.line +
    pad(position, inner.pad_shift). A column-phase warp holds 32 adjacent
    columns of one t, whose slot a sits at a * 32 + column: 256 adjacent
    bytes, always the least."""
    inner = plan.inner
    return _sweep_wavefronts(plan, inner.line, inner.pad_shift, *(layouts or pass_layouts(inner)))


def _fits(n: int, inner: MixedPlan):
    """The Bluestein plan of an N-point line over inner with the most
    threads a block may take (1,024, 512, ... down to one column group)
    when the field's and the scratch's padded rows are the longest the
    padding search can give; None where none fits."""
    worst = dict(line=pad(n - 1) + 16)
    inner = dataclasses.replace(inner, line=pad(inner.n - 1) + 16)
    cap = FWD_THREADS
    while cap >= 32 * inner.line_threads:
        plan = BluesteinPlan(n, inner, max_threads=cap, **worst)
        if plan.block_smem(cap) <= SMEM_LIMIT:
            return plan
        cap //= 2
    return None


def _bluestein_plan(n: int) -> BluesteinPlan:
    """The cheapest Bluestein plan by _cost (then a power of two M, whose
    stages are all radix 2, then the least M) over every 7-smooth M from
    2 N - 1 to the power of two at or above it (T <= 16, at most 32
    registers a thread, field and scratch within SMEM_LIMIT), then
    the field's padding (its wavefronts), then the scratch row's
    (scratch_wavefronts), each the shortest row among equals. _cost's first
    keys, registers above 16 and exchanges, pass over the least M where its
    factors need three passes or more registers: on an H100 such lines ran
    1.3–2x slower a point than two passes of 16 or fewer (PERF.md §6)."""
    top = 1 << (2 * n - 2).bit_length()
    inner = (MixedPlan(m, t, passes, m) for m in range(2 * n - 1, top + 1) if smooth(m)
             for passes in _passes_of(m) for t in range(2, MAX_LINE_THREADS + 1))
    plans = (_fits(n, line) for line in inner if line.elems <= 32)
    plan = min((p for p in plans if p is not None),
               key=lambda p: (_cost(p), not is_pow2(p.slots), p.slots))
    m, views, lays = plan.slots, _field_views(plan), pass_layouts(plan.inner)
    fields = [dataclasses.replace(plan, line=pad(n - 1, s) + 1 + d, pad_shift=s)
              for s in PAD_SHIFTS for d in range(16)]
    plan = min(fields, key=lambda p: (_sweep_wavefronts(p, p.line, p.pad_shift, *views)[0],
                                      p.line, -p.pad_shift))
    rows = [dataclasses.replace(plan, inner=dataclasses.replace(
        plan.inner, line=pad(m - 1, s) + 1 + d, pad_shift=s)) for s in PAD_SHIFTS for d in range(16)]
    return min(rows, key=lambda p: (scratch_wavefronts(p, lays)[0], p.inner.line,
                                    -p.inner.pad_shift))


@functools.lru_cache(maxsize=None)
def mixed_plan(n: int):
    """The plan multislice.cu builds for N (2 <= N <= 128, not a power of
    two). A 7-smooth N: the mixed-radix plan (MixedPlan) with the cheapest pass sequence and line threads T <= 16 by
    _cost, then the row padding (PAD_SHIFTS) and the padded row length, from
    pad(N - 1) + 1 up, with the fewest row-phase wavefronts (the shortest
    row among equals). Any other N: the Bluestein plan (BluesteinPlan,
    _bluestein_plan)."""
    if not 2 <= n <= MAX_N or is_pow2(n):
        raise ValueError(f"mixed_plan: N must be in [2, {MAX_N}] and not a power of two, got {n}")
    if not smooth(n):
        return _bluestein_plan(n)
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


def bluestein_tables(n: int, inner: MixedPlan) -> tuple:
    """A Bluestein line's tables as the libraries compute them (reg_fft.cuh
    upload_bluestein), in double precision before the rounding to float32:
    the chirp c_j = exp(-i pi (j^2 mod 2N) / N) for j < N, and the filter,
    the spectrum over M of g_j = conj(c_|j|) (|j| < N, cyclic) divided by M,
    at inner position p the frequency digitrev(p) of the inner forward."""
    m = inner.n
    j = np.arange(n)
    chirp = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    g = np.zeros(m, complex)
    g[:n] = np.conj(chirp)
    g[m - n + 1:] = np.conj(chirp[1:][::-1])
    f = np.array([digitrev(p, inner.radices) for p in range(m)])
    return chirp, np.fft.fft(g)[f] / m


def mixed_line_type(line: MixedPlan) -> str:
    """reg_fft.cuh's type of the line: regfft::MixedLine<N, T, its passes>."""
    passes = ", ".join(f"regfft::Pass<false, {', '.join(map(str, p.radices))}>"
                       for p in line.passes)
    return f"regfft::MixedLine<{line.n}, {line.line_threads}, {passes}>"


def _line_type(plan) -> str:
    if isinstance(plan, BluesteinPlan):
        return f"regfft::BluesteinLine<{plan.n}, {mixed_line_type(plan.inner)}>"
    return mixed_line_type(plan)


def plan_source(n: int, bf16_operands: bool = False) -> str:
    """The source that compiles multislice.cu for N's plan (its _bf16 twin
    with bf16_operands): the line type (regfft::MixedLine<N, T,
    passes...>, or PTYRAD_BLUESTEIN and regfft::BluesteinLine<N, the M-point
    MixedLine>), the padded row and the row padding's shift as macros, for a
    Bluestein plan the scratch row's and the block's thread cap too, then
    the kernel file. A file, since nvcc splits a -D value at its commas."""
    plan = mixed_plan(n)
    blue = isinstance(plan, BluesteinPlan)
    kind = "Bluestein" if blue else "mixed-radix"
    return (f"// multislice.cu at N = {n}: ops/fused_plan.py's {kind} plan\n"
            + ("#define PTYRAD_BF16_OPERANDS 1\n" if bf16_operands else "")
            + ("#define PTYRAD_BLUESTEIN 1\n" if blue else "")
            + f"#define PTYRAD_MIXED_LINE {_line_type(plan)}\n"
            f"#define PTYRAD_MIXED_ROW {plan.line}\n"
            f"#define PTYRAD_MIXED_PAD {plan.pad_shift}\n"
            + (f"#define PTYRAD_SCRATCH_ROW {plan.inner.line}\n"
               f"#define PTYRAD_SCRATCH_PAD {plan.inner.pad_shift}\n"
               f"#define PTYRAD_BLOCK_THREADS {plan.max_threads}\n" if blue else "")
            + '#include "multislice.cu"\n')


def reported(n: int) -> tuple:
    """What ptyrad_fused_plan writes for N (not a power of two): N, E, T,
    the padded row and its shift, the forward block's threads and sweeps,
    the backward's, a column group's threads, the forward block's shared
    bytes, B3a's epilogue blocks a sample, the line kind (1 mixed-radix, 2
    Bluestein), a line's slots (N, or M), the forward block's scratch bytes,
    the scratch row and its shift (0 without a scratch)."""
    plan = mixed_plan(n)
    fwd, bwd = plan.block(FWD_THREADS), plan.block(BWD_THREADS)
    blue = isinstance(plan, BluesteinPlan)
    scratch = (plan.inner.line, plan.inner.pad_shift) if blue else (0, 0)
    return (n, plan.elems, plan.line_threads, plan.line, plan.pad_shift, fwd.threads,
            fwd.row_sweeps, fwd.col_sweeps, bwd.threads, bwd.row_sweeps, bwd.col_sweeps,
            32 * plan.line_threads, plan.smem, min(n, 16), 2 if blue else 1,
            plan.slots if blue else n, plan.smem - 8 * n * plan.line, *scratch)
