// Mixed-state multislice chain for sm_90a at every N <= 128, forward and backward:
// the plain pair (B4), whose output is the diffraction intensity, and the
// loss-folded pair (B3), whose output is the loss_single partial sums.
//
// Replaces the TPU kernels of ptyrad_tpu/ops/pallas_multislice.py:
//   B4a  _fwd_kernel      (:128, launched by _fused_fwd_impl :382/:404)
//   B4b  _bwd_kernel      (:145, launched by _fused_bwd      :428/:464,
//        adjoint walk _bwd_from_g :178)
//   B3a  _fwd_loss_kernel (:548, launched by _loss_fwd_impl  :642/:666)
//   B3b  _bwd_loss_kernel (:588, launched by _loss_fused_bwd :703/:744,
//        adjoint walk _bwd_from_g :178)
// B3 is B4 with the loss folded in; both share one chain kernel forward and
// one backward kernel, templated on the loss.
//
// Contract (omode 1; propagator H shared (1, N, N) or per position (B, N, N)):
//   psi_0   = probe mode p (shared real-space (1, pmode, N, N), or
//             per-position (B, pmode, N, N)), or ifft2 of the probe spectrum
//   for z:    psi <- psi * T_z,  T_z = a_z exp(i phi_z);
//             between slices psi <- ifft2(H * fft2(psi))
//   dp      = sum_p |fft2(psi)|^2 / N^2                  (corner-centred)
//   B4a returns dp (B, N, N). B4b takes its cotangent g (B, N, N).
//   B3a returns s1 = sum_b mask_b sum ((dp + eps)^p - meas^p)^2 and
//   s2 = sum_b mask_b sum meas^p, with meas ifftshifted to the corner-centred
//   order; B3b forms g = c mask 2p ((dp+eps)^p - meas^p)(dp+eps)^(p-1) with c
//   the upstream cotangent of s1.
//   Both backwards return d obja, d objp (B, 1, Nz, N, N) and d probe (the
//   probe's shape), and on request (need_dh, pallas_multislice.py
//   _bwd_from_g :211-231) dH in H's shape: with K_z = fft2(psi_z T_z) and
//   U_z = fft2(d psi_{z+1}) for each propagation z -> z+1,
//   dH = (1/N^2) sum_z sum_p U_z conj(K_z), summed over samples too for a
//   shared H (the 1/N^2 is kernel_util.unscale_dh :96-100).
//
// Bound on the card: FP32 arithmetic. A 128^2 complex 2D FFT is about
// 10 N^2 log2 N = 1.15 MFLOP. The forward runs 12 of them per (sample, mode)
// wavefield (kspace probe load, 5 propagations of 2, the far field), the
// backward 24 (the recompute plus the adjoint walk). At B=32, pmode=6 that
// is about 2.7 GFLOP forward and 5.3 GFLOP backward: 40 us and 80 us at
// 67 TFLOP/s. The forward reads about 52 MB, 16 us at 3.35 TB/s. Between
// the two sits the field's traffic through shared memory, which the design
// keeps to about 8 MB a forward wavefield (1.5 GB at tBL, 45 us at the
// card's 33 TB/s), and its barriers.
//
// Design (ptyrad_fused_plan reports FPlan; tests/test_torch_fused_plan.py
// emulates it):
//  * One block per (sample, mode) wavefield: 192 blocks at tBL. The N^2
//    complex64 field lives in dynamic shared memory for the whole chain,
//    its rows padded: element (y, x) at y L + x + x / 16, L = N + N / 16
//    (N + 1 below 16), 139 KB at N = 128, one block an SM. The wavefield
//    never touches device memory. The DFT is computed, not called: no
//    cuFFT, no library.
//  * Transforms in registers (reg_fft.cuh line_dif, line_dit): a line's
//    TL = N / E threads hold E = 16 points each at t + TL m and run radix-2
//    stages there: decimation in frequency forward (spans N/2 ... TL in
//    registers, one exchange on the line's own slots of the field, spans
//    TL/2 ... 1), and its conjugate transpose inverse. That is the arithmetic
//    of radix-2 stages in place, which the dz and tilt gradients need: they
//    cancel a term (a global phase of every H) whose float32 rounding, from
//    a chain of transforms and its adjoint, the pair keeps at the level of
//    such stages; chain.cu's Stockham passes (16 x 8, the inverse in the
//    forward's pass order) left it about 4 times larger on the tBL data,
//    past chip_smoke's float64 gate. The forward leaves frequency
//    bitrev(E t + i) in register i (dif_freq): global arrays are read and
//    written at that frequency, which in the column phase is one row for a
//    whole warp, so every access stays coalesced. A 2D transform is a row
//    phase (a row's threads share a warp: __syncwarp), one __syncthreads,
//    and a column phase (32 adjacent columns a warp, so a warp's accesses
//    are whole padded rows; a column's TL threads are TL warps that wait on
//    a named barrier of their own). The padding keeps every load and store
//    of both phases, in each of the three layouts (points, exchange
//    positions, frequencies), free of bank conflicts.
//  * Elementwise work rides on the phases: a slice is one row phase (the
//    previous propagation's inverse row transform, T = a e^{i phi}, the
//    forward row transform) and one column phase (forward column transform,
//    H / N^2, inverse column transform), so a propagation takes three phases
//    and about 6 barriers. The far field is one more column phase, which
//    writes |Y|^2 / N^2 (B3a, B4a) or, in the backward, multiplies by the dp
//    cotangent and runs the adjoint column transform at once. H, the kspace
//    probe, the intensity, meas, dp, g, K and the dH partials keep their
//    natural layouts in device memory.
//  * Mode reduction: dp sums over modes, which live in different blocks.
//    The chain kernel writes |Y|^2/N^2 to a (B, pmode, N, N) scratch. For B4a
//    an elementwise kernel sums the modes into dp in mode order. For B3a a
//    second kernel with B x 16 blocks (B x N below 16) forms dp (kept as the
//    residual for the backward, 2 MB) and the masked s1/s2 partial sums of
//    its rows; one warp adds the partials in a fixed order. Both forwards
//    are deterministic.
//  * Backward: the recompute writes the Nz slice-entry states of each
//    wavefield to a device scratch (B pmode Nz N^2 8 B = 151 MB at tBL) from
//    its row phases; the adjoint walk's row phase for slice z reads them
//    back at the same positions and forms dT = d chi conj(psi) and
//    d psi = d chi conj(T) between its inverse and forward row transforms.
//    dT sums over modes, which live in different blocks: each thread reads
//    an entry state once, so dT goes back into its slot of the stack, and
//    dt_reduce.cuh sums the modes in mode order before it forms d(a, phi)
//    (linear in dT). A shared probe's gradient leaves each block as a
//    partial field (B pmode N^2 8 B = 25 MB at tBL), summed over the samples
//    in sample order. No atomics, and no output to zero first: the
//    backward is deterministic.
//  * dH: the recompute's column phases store each K_z (B pmode (Nz-1) N^2
//    8 B = 126 MB at tBL) between the forward column transform and the H
//    multiply; the walk's column phases read it back at the same point,
//    where U_z sits in registers, and accumulate this wavefield's
//    sum_z U_z conj(K_z) into its own partial field (25 MB at tBL);
//    dh_reduce.cuh then sums the modes (and the samples for a shared H) in
//    a fixed order, without atomics. The backward kernel is templated on
//    kDh, so its instantiation without dH has none of this work.
//  * A per-position H is read at b N^2 by the blocks of sample b.
//  * Set-up once per (device, N) (prepare, ptyrad_fused_prepare): the
//    twiddle table and the kernels' shared-memory limits.
//  * N that is not a power of two (96, 100, 120, 127, ...): the same
//    kernels on the mixed-radix pair of reg_fft.cuh (line_dif_mr,
//    line_dit_mr) with the plan ops/fused_plan.py chooses for that N, which
//    this file takes as macros (PTYRAD_MIXED_LINE, PTYRAD_MIXED_ROW,
//    PTYRAD_MIXED_PAD): ops/_build.py compiles it, and its _bf16 twin, once
//    per such N into a library of its own, whose entry points take that N
//    alone. Without the macros the file builds the powers of two as before.
//    FPlanMR holds the field the same way (rows padded by a + (a >> pad),
//    the plan's shift), a line's T threads hold E points each in the
//    plan's layouts, and the block's warps may leave lanes or lines idle
//    where T does not divide 32 or the lines a sweep covers exceed N: an
//    idle thread runs every barrier and touches no memory (the exchanges'
//    `live`). The elementwise kernels index N^2 pixels by division by the
//    compile-time N^2 (regfft::FixedPix), B3a's epilogue blocks take
//    ceil(N^2 / chunks) pixels each, and the reduces are the fixed-order
//    ones of every N.
//  * N with a prime factor above 7 (127, 122 = 2 x 61, ...; ops/fused_plan.py
//    BluesteinPlan): the same kernels on reg_fft.cuh's Bluestein line
//    (PTYRAD_BLUESTEIN; regfft::BluesteinLine<N, an M-point MixedLine>, M the
//    7-smooth size >= 2 N - 1 whose plan costs least, 256 at 127): the
//    chirp, two M-point register-pass transforms, the filter and the chirp,
//    where a direct sum over the prime costs O(p) loads and FMAs a point.
//    M slots do not fit the field's N-point row or column, so FPlanBL puts
//    a scratch region after the field (PTYRAD_SCRATCH_ROW,
//    PTYRAD_SCRATCH_PAD) through which the inner lines exchange, and caps
//    the block (PTYRAD_BLOCK_THREADS: 512 at 127, for both kernels) so that
//    field and scratch fit. The spectrum is
//    in natural order in the points' own layout, so H, the field and every
//    array keep their layouts; the inverse is the forward's conjugate
//    transpose step by step.
//  * FP32 throughout, accurate sincosf, twiddles from double precision.
//  * The bfloat16 compute policy: multislice_bf16.cu compiles this file
//    with PTYRAD_BF16_OPERANDS 1, so every line transform (line_dif,
//    line_dit: each 1-D pass, forward and adjoint, of the chain, the kspace
//    probe, the far field and the dH spectra) rounds its points to bfloat16
//    first, as the JAX kernels round each pass's GEMM operand
//    (pallas_multislice.py:105-107, :140, :172, :189, :215-239). T and H
//    multiplies, the mode sums, the loss partials and the fixed-order
//    reduces stay FP32; its entry points carry the suffix _bf16. This file
//    alone (the default, 0) compiles the FP32 kernels as they were.

#ifndef PTYRAD_BF16_OPERANDS
#define PTYRAD_BF16_OPERANDS 0
#endif
#if PTYRAD_BF16_OPERANDS
#define PTYRAD_ENTRY(name) name##_bf16
#else
#define PTYRAD_ENTRY(name) name
#endif

#include <cuda_runtime.h>

#include "dh_reduce.cuh"
#include "dt_reduce.cuh"
#include "reg_fft.cuh"

namespace {

using regfft::cmul;
using regfft::cmul_conj;
using regfft::line_dif;
using regfft::line_dit;
using regfft::set_smem;
using regfft::static_for;
using regfft::with_logn;

constexpr int kMaxLogN = 7;  // N <= 128: the padded field fits 227 KB of shared memory
constexpr bool kBf16 = PTYRAD_BF16_OPERANDS != 0;  // every line transform rounds its operand
// A chain block's threads at N = 128 (one block an SM either way). The
// forward's 1,024 threads fit 64 registers with a 60-byte spill and beat
// 512; the backward needs 128 registers, and at 1,024 threads (64 each) a
// backward spilled 500-700 bytes and ran no faster (PERF.md §6).
constexpr int kFwdThreads = 1024;
constexpr int kBwdThreads = 512;
constexpr int kSumThreads = 256;

// The plan of N = 2^LOGN: the radix-2 pair of reg_fft.cuh
template <int LOGN, int kMaxThreads>
struct FPlan {
  using Line = regfft::LinePlan<LOGN>;
  static constexpr bool kPow2 = true;
  static constexpr int kLogN = LOGN;
  static constexpr int kN = Line::kN, kE = Line::kE, kLogTl = Line::kLogTl, kTl = Line::kTl;
  static constexpr int kNN = kN * kN;
  static constexpr int kLine = kN + (kN >= 16 ? kN / 16 : 1);  // a padded row
  static constexpr int kPadShift = 4;                           // element a at a + a / 16
  static constexpr int kSlots = kN * kTl;  // a phase's threads: TL for each of N lines
  static constexpr int kThreads = kSlots < kMaxThreads ? kSlots : kMaxThreads;
  static constexpr int kSweeps = kSlots / kThreads;  // lines a thread takes in a phase
  static constexpr int kRowSweeps = kSweeps, kColSweeps = kSweeps;
  static constexpr int kLinesPerSweep = kThreads >> kLogTl;
  static constexpr int kGroupThreads = 32 * kTl;  // a column phase's 32 adjacent columns
  static constexpr size_t kSmem = sizeof(float2) * kN * kLine;
  static constexpr bool kReadsSlots = kTl > 1;  // line_dif's exchange: store_freq waits first

  // register m of thread t: its point (t + TL m) and its frequency after line_dif
  template <int m>
  __device__ __forceinline__ static int pos(int t) { return t + m * kTl; }
  template <int m>
  __device__ __forceinline__ static bool pos_ok(int) { return true; }
  template <int m>
  __device__ __forceinline__ static int freq(int t) { return regfft::dif_freq<LOGN>(t, m); }
  template <int m>
  __device__ __forceinline__ static bool freq_ok(int) { return true; }
  template <bool kB, class Ex>
  __device__ __forceinline__ static void dif(float2 (&v)[kE], int t, const Ex& ex) {
    line_dif<LOGN, kB>(v, t, ex);
  }
  template <bool kB, class Ex>
  __device__ __forceinline__ static void dit(float2 (&v)[kE], int t, const Ex& ex) {
    line_dit<LOGN, kB>(v, t, ex);
  }
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The plan of a mixed-radix line (regfft::MixedLine, ops/fused_plan.py):
// rows of kRow elements padded by a + (a >> kPad); a warp holds 32 / T rows
// in the row phase, a column group T warps of 32 adjacent columns (one
// named barrier each, at most 15 groups); the block takes the warps one
// sweep of each phase needs, up to kMaxThreads
template <class L, int kMaxThreads, int kRow, int kPad>
struct FPlanMR {
  using Line = L;
  static constexpr bool kPow2 = false;
  static constexpr int kN = L::kN, kE = L::kE, kTl = L::kTl;
  static constexpr int kNN = kN * kN;
  static constexpr int kLine = kRow, kPadShift = kPad;
  static constexpr int kRowsPerWarp = 32 / kTl;
  static constexpr int kWarpsMax0 = (kMaxThreads / 32) / kTl * kTl;
  static constexpr int kWarpsMax =
      kTl > 1 && kWarpsMax0 > 15 * kTl ? 15 * kTl : kWarpsMax0;  // named barriers 1 ... 15
  static constexpr int kNeed0 = cdiv(kN, kRowsPerWarp), kNeed1 = kTl * cdiv(kN, 32);
  static constexpr int kNeed = cdiv(kNeed0 > kNeed1 ? kNeed0 : kNeed1, kTl) * kTl;
  static constexpr int kWarps = kNeed < kWarpsMax ? kNeed : kWarpsMax;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = kWarps / kTl;
  static constexpr int kRowSweeps = cdiv(kN, kWarps * kRowsPerWarp);
  static constexpr int kColSweeps = cdiv(kN, 32 * kGroups);
  static constexpr int kGroupThreads = 32 * kTl;
  static constexpr size_t kSmem = sizeof(float2) * kN * kLine;
  static constexpr bool kReadsSlots = L::kReadsSlots;
  static constexpr bool kBluestein = false;
  static_assert(kLine >= kN - 1 + ((kN - 1) >> kPad) + 1, "a padded row must hold the row");

  template <int m>
  __device__ __forceinline__ static int pos(int t) { return L::template pos<0, m>(t); }
  template <int m>
  __device__ __forceinline__ static bool pos_ok(int t) { return L::template ok<0, m>(t); }
  template <int m>
  __device__ __forceinline__ static int freq(int t) { return L::template freq<m>(t); }
  template <int m>
  __device__ __forceinline__ static bool freq_ok(int t) {
    return L::template ok<L::kPasses - 1, m>(t);
  }
  template <bool kB, class Ex>
  __device__ __forceinline__ static void dif(float2 (&v)[kE], int t, const Ex& ex) {
    regfft::line_dif_mr<L, kB>(v, t, ex);
  }
  template <bool kB, class Ex>
  __device__ __forceinline__ static void dit(float2 (&v)[kE], int t, const Ex& ex) {
    regfft::line_dit_mr<L, kB>(v, t, ex);
  }
};

#ifdef PTYRAD_BLUESTEIN
// The plan of a Bluestein line (regfft::BluesteinLine over an M-point
// MixedLine; ops/fused_plan.py BluesteinPlan): the field as FPlanMR's, the
// block capped at PTYRAD_BLOCK_THREADS, and after the field a scratch region
// for the M-point line's exchanges, which the N-point row or column cannot
// hold: in the row phase a padded line of kScrLine elements (element a at
// a + (a >> kScrPadShift)) for each row in flight, in the column phase M
// slots for each column of each group (slot a of column c at a * 32 + c);
// the phases share it. A transform loads and stores only the thread's own
// points of the field, so no store of the field waits (kReadsSlots false).
template <class L, int kMaxThreads, int kRow, int kPad, int kScrRow, int kScrPad>
struct FPlanBL : FPlanMR<L, (kMaxThreads < PTYRAD_BLOCK_THREADS ? kMaxThreads
                                                               : PTYRAD_BLOCK_THREADS),
                         kRow, kPad> {
  using Base = FPlanMR<L, (kMaxThreads < PTYRAD_BLOCK_THREADS ? kMaxThreads
                                                              : PTYRAD_BLOCK_THREADS),
                       kRow, kPad>;
  static constexpr bool kBluestein = true;
  static constexpr bool kReadsSlots = false;
  static constexpr int kSlots = L::kSlots;  // M
  static constexpr int kScrLine = kScrRow, kScrPadShift = kScrPad;
  static constexpr size_t kField = static_cast<size_t>(Base::kN) * Base::kLine;
  static constexpr size_t kScrRows =
      static_cast<size_t>(Base::kWarps) * Base::kRowsPerWarp * kScrLine;
  static constexpr size_t kScrCols = static_cast<size_t>(Base::kGroups) * 32 * kSlots;
  static constexpr size_t kScratch = kScrRows > kScrCols ? kScrRows : kScrCols;
  static constexpr size_t kSmem = sizeof(float2) * (kField + kScratch);
  static_assert(kSmem <= 232448, "field and scratch exceed a block's shared memory");
  static_assert(kScrLine >= kSlots - 1 + ((kSlots - 1) >> kScrPad) + 1,
                "a scratch line must hold the M slots");

  template <bool kB, class Ex>
  __device__ __forceinline__ static void dif(float2 (&v)[Base::kE], int t, const Ex& ex) {
    regfft::line_dif_bl<L, kB>(v, t, ex.scratch());
  }
  template <bool kB, class Ex>
  __device__ __forceinline__ static void dit(float2 (&v)[Base::kE], int t, const Ex& ex) {
    regfft::line_dit_bl<L, kB>(v, t, ex.scratch());
  }
};
#endif

// What the kernels are built for: a shape S gives the plan of a block of at
// most kMax threads (S::Plan<kMax>), the pixel arithmetic of the
// elementwise kernels, the key of its one-time set-up and its twiddles.
template <int LOGN>
struct Pow2Shape {
  template <int kMax>
  using Plan = FPlan<LOGN, kMax>;
  static constexpr int kN = 1 << LOGN, kKey = LOGN;
  static regfft::Pow2Pix pix() { return regfft::Pow2Pix{2 * LOGN}; }
  static cudaError_t upload() { return cudaSuccess; }
};

#ifdef PTYRAD_MIXED_LINE
using MixedLineT = PTYRAD_MIXED_LINE;
struct MixedShape {
#ifdef PTYRAD_BLUESTEIN
  template <int kMax>
  using Plan = FPlanBL<MixedLineT, kMax, PTYRAD_MIXED_ROW, PTYRAD_MIXED_PAD, PTYRAD_SCRATCH_ROW,
                       PTYRAD_SCRATCH_PAD>;
  static cudaError_t upload() { return regfft::upload_bluestein<MixedLineT>(); }
#else
  template <int kMax>
  using Plan = FPlanMR<MixedLineT, kMax, PTYRAD_MIXED_ROW, PTYRAD_MIXED_PAD>;
  static cudaError_t upload() { return regfft::upload_mixed(MixedLineT::kN); }
#endif
  static constexpr int kN = MixedLineT::kN, kKey = 1;
  static regfft::FixedPix<kN * kN> pix() { return {}; }
};
#endif

// the two chain kernels' block sizes of shape S (no comma for __launch_bounds__)
template <class S>
constexpr int kFwdBlock = S::template Plan<kFwdThreads>::kThreads;
template <class S>
constexpr int kBwdBlock = S::template Plan<kBwdThreads>::kThreads;

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

__device__ __forceinline__ float pow_p(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 0.5f) return sqrtf(x);
  return powf(x, p);
}

// x^(p-1) for x > 0
__device__ __forceinline__ float pow_pm1(float x, float p) {
  if (p == 1.0f) return 1.0f;
  if (p == 0.5f) return 1.0f / sqrtf(x);
  return powf(x, p - 1.0f);
}

// A row of the resident field as a line (element a at a + a / 16); the
// row's threads share a warp.
struct FieldRow {
  static constexpr bool live = true;
  float2* s;
  __device__ __forceinline__ void store(int a, float2 x) const { s[a + (a >> 4)] = x; }
  __device__ __forceinline__ float2 load(int a) const { return s[a + (a >> 4)]; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// A column of the resident field as a line (element a at a L). Its TL
// threads are TL warps of a group of 32 adjacent columns, which waits on
// named barrier `bar`.
template <class P>
struct FieldCol {
  static constexpr bool live = true;
  float2* s;
  int bar;
  __device__ __forceinline__ void store(int a, float2 x) const { s[a * P::kLine] = x; }
  __device__ __forceinline__ float2 load(int a) const { return s[a * P::kLine]; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" : : "r"(bar), "r"(P::kGroupThreads) : "memory");
  }
};

// The same for a mixed-radix plan, where a thread may hold no line (live
// false: it waits at every barrier, stores nothing and loads from the
// field's first element)
template <class P>
struct MixedRow {
  float2* s;
  bool live;
  __device__ __forceinline__ void store(int a, float2 x) const {
    if (live) s[a + (a >> P::kPadShift)] = x;
  }
  __device__ __forceinline__ float2 load(int a) const { return s[a + (a >> P::kPadShift)]; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

template <class P>
struct MixedCol {
  float2* s;
  int bar;
  bool live;
  __device__ __forceinline__ void store(int a, float2 x) const {
    if (live) s[a * P::kLine] = x;
  }
  __device__ __forceinline__ float2 load(int a) const { return s[a * P::kLine]; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" : : "r"(bar), "r"(P::kGroupThreads) : "memory");
  }
};

#ifdef PTYRAD_BLUESTEIN
// A row's line in a Bluestein plan's scratch (its padded scratch line; the
// row's threads share a warp) and a column's (slot a at a * 32, the
// group's named barrier); an idle thread stores nothing
template <class P>
struct ScratchRow {
  float2* s;
  bool live;
  __device__ __forceinline__ void store(int a, float2 x) const {
    if (live) s[a + (a >> P::kScrPadShift)] = x;
  }
  __device__ __forceinline__ float2 load(int a) const { return s[a + (a >> P::kScrPadShift)]; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

template <class P>
struct ScratchCol {
  float2* s;
  int bar;
  bool live;
  __device__ __forceinline__ void store(int a, float2 x) const {
    if (live) s[a * 32] = x;
  }
  __device__ __forceinline__ float2 load(int a) const { return s[a * 32]; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" : : "r"(bar), "r"(P::kGroupThreads) : "memory");
  }
};

// A line of the field (F) with its line of the scratch (X), which the
// plan's transforms exchange through
template <class F, class X>
struct WithScratch : F {
  X x;
  __device__ __forceinline__ const X& scratch() const { return x; }
};
#endif

// f(y, t, line) for every row y of the field: thread t of the row's TL
template <class P, class F>
__device__ __forceinline__ void for_rows(float2* s, F&& f) {
  if constexpr (P::kPow2) {
    const int t = threadIdx.x & (P::kTl - 1);
    for (int sw = 0; sw < P::kSweeps; ++sw) {
      const int y = sw * P::kLinesPerSweep + (threadIdx.x >> P::kLogTl);
      f(y, t, FieldRow{s + y * P::kLine});
    }
  } else {
    const int lane = threadIdx.x & 31;
    const int t = lane % P::kTl;
    const int r = lane / P::kTl;
    for (int sw = 0; sw < P::kRowSweeps; ++sw) {
      const int y = (sw * P::kWarps + (threadIdx.x >> 5)) * P::kRowsPerWarp + r;
      const bool live = r < P::kRowsPerWarp && y < P::kN;
      if constexpr (P::kBluestein) {
#ifdef PTYRAD_BLUESTEIN
        // the warp's rows in flight own scratch lines warp * rows + r
        const int line = (threadIdx.x >> 5) * P::kRowsPerWarp + r;
        float2* x = s + P::kField + (live ? line * P::kScrLine : 0);
        f(y, t, WithScratch<MixedRow<P>, ScratchRow<P>>{{s + (live ? y * P::kLine : 0), live},
                                                        {x, live}});
#endif
      } else {
        f(y, t, MixedRow<P>{s + (live ? y * P::kLine : 0), live});
      }
    }
  }
}

// f(x, t, line) for every column x of the field: warp w holds 32 adjacent
// columns with one t, and a column's TL warps are adjacent
template <class P, class F>
__device__ __forceinline__ void for_cols(float2* s, F&& f) {
  if constexpr (P::kPow2) {
    const int w = threadIdx.x >> 5;
    const int group = w >> P::kLogTl;
    const int t = w & (P::kTl - 1);
    for (int sw = 0; sw < P::kSweeps; ++sw) {
      const int x = sw * P::kLinesPerSweep + group * 32 + (threadIdx.x & 31);
      f(x, t, FieldCol<P>{s + x + (x >> 4), 1 + group});
    }
  } else {
    const int w = threadIdx.x >> 5;
    const int group = w / P::kTl;
    const int t = w % P::kTl;
    for (int sw = 0; sw < P::kColSweeps; ++sw) {
      const int x = (sw * P::kGroups + group) * 32 + (threadIdx.x & 31);
      const bool live = x < P::kN;
      if constexpr (P::kBluestein) {
#ifdef PTYRAD_BLUESTEIN
        // a group's columns own M slots each, interleaved by column
        float2* xs = s + P::kField + group * 32 * P::kSlots + (threadIdx.x & 31);
        f(x, t, WithScratch<MixedCol<P>, ScratchCol<P>>{
                    {s + (live ? x + (x >> P::kPadShift) : 0), 1 + group, live},
                    {xs, 1 + group, live}});
#endif
      } else {
        f(x, t, MixedCol<P>{s + (live ? x + (x >> P::kPadShift) : 0), 1 + group, live});
      }
    }
  }
}

// Registers a mixed-radix plan's layouts leave empty start at zero
template <class P>
__device__ __forceinline__ void fresh(float2 (&v)[P::kE]) {
  if constexpr (!P::kPow2) static_for<0, P::kE>([&](auto m) { v[m] = make_float2(0.0f, 0.0f); });
}

// f(m, a) for each register m of thread t that holds a point, a its line
// position (t + TL m for a power of two), on a line the thread holds
template <class P, class Ex, class F>
__device__ __forceinline__ void each_point(int t, const Ex& ex, F&& f) {
  static_for<0, P::kE>([&](auto m) {
    if (ex.live && P::template pos_ok<decltype(m)::value>(t)) {
      f(m, P::template pos<decltype(m)::value>(t));
    }
  });
}

// f(i, k) for each register i of thread t that holds a frequency after the
// forward transform, k that frequency
template <class P, class Ex, class F>
__device__ __forceinline__ void each_freq(int t, const Ex& ex, F&& f) {
  static_for<0, P::kE>([&](auto i) {
    if (ex.live && P::template freq_ok<decltype(i)::value>(t)) {
      f(i, P::template freq<decltype(i)::value>(t));
    }
  });
}

// The thread's points of a line, from and to the field
template <class P, class Ex>
__device__ __forceinline__ void load_line(float2 (&v)[P::kE], int t, const Ex& ex) {
  each_point<P>(t, ex, [&](auto m, int a) { v[m] = ex.load(a); });
}

template <class P, class Ex>
__device__ __forceinline__ void store_line(const float2 (&v)[P::kE], int t, const Ex& ex) {
  each_point<P>(t, ex, [&](auto m, int a) { ex.store(a, v[m]); });
}

// The thread's frequencies of a line, from and to the field; the store
// waits first for the exchange loads of the forward transform
template <class P, class Ex>
__device__ __forceinline__ void load_freq(float2 (&v)[P::kE], int t, const Ex& ex) {
  each_freq<P>(t, ex, [&](auto i, int k) { v[i] = ex.load(k); });
}

template <class P, class Ex>
__device__ __forceinline__ void store_freq(const float2 (&v)[P::kE], int t, const Ex& ex) {
  if constexpr (P::kReadsSlots) ex.sync();
  each_freq<P>(t, ex, [&](auto i, int k) { ex.store(k, v[i]); });
}

// The chain from the probe through the final slice's forward row
// transforms: on return every row of s holds the final slice's exit chi
// transformed along x (natural order), and the block is synchronised (the
// far field's column phase is the caller's). kspace: pr is the probe's
// spectrum, transformed here, with the 1/N^2 of ifft2 on the first slice.
// With st (the backward's recompute), each slice's entry state is stored
// there; with kDh, the spectrum K_z of each propagation z -> z+1 in kst.
template <class P, bool kDh>
__device__ __forceinline__ void run_chain(float2* s, const float2* __restrict__ pr, bool kspace,
                                          const float* __restrict__ a_b,
                                          const float* __restrict__ phi_b,
                                          const float2* __restrict__ h, float2* __restrict__ st,
                                          float2* __restrict__ kst, int nz) {
  constexpr int kN = P::kN, kE = P::kE, kNN = P::kNN;
  constexpr float kInvNN = 1.0f / kNN;
  if (kspace) {  // the spectrum's inverse column transforms, straight from device memory
    for_cols<P>(s, [&](int x, int t, const auto& ex) {
      float2 v[kE];
      fresh<P>(v);
      each_freq<P>(t, ex, [&](auto i, int k) { v[i] = pr[k * kN + x]; });
      P::template dit<kBf16>(v, t, ex);
      store_line<P>(v, t, ex);
    });
    __syncthreads();
  }
  for (int z = 0; z < nz; ++z) {
    const float* a_z = a_b + z * kNN;
    const float* phi_z = phi_b + z * kNN;
    // the previous propagation's (or the spectrum's) inverse row transform,
    // the slice's entry state, T, the forward row transform
    for_rows<P>(s, [&](int y, int t, const auto& ex) {
      float2 v[kE];
      fresh<P>(v);
      const int row = y * kN;
      if (z == 0 && !kspace) {
        each_point<P>(t, ex, [&](auto m, int a) { v[m] = pr[row + a]; });
      } else {
        load_freq<P>(v, t, ex);
        P::template dit<kBf16>(v, t, ex);
        if (z == 0) static_for<0, kE>([&](auto m) { v[m] = cscale(v[m], kInvNN); });
      }
      if (st != nullptr) {
        each_point<P>(t, ex, [&](auto m, int a) { st[z * kNN + row + a] = v[m]; });
      }
      each_point<P>(t, ex, [&](auto m, int a) {
        const int k = row + a;
        float sn, cs;
        sincosf(phi_z[k], &sn, &cs);
        const float amp = a_z[k];
        v[m] = cmul(v[m], make_float2(amp * cs, amp * sn));
      });
      P::template dif<kBf16>(v, t, ex);
      store_freq<P>(v, t, ex);
    });
    __syncthreads();
    if (z == nz - 1) break;
    // the propagation's column phase: forward transform, (K_z), H / N^2, inverse
    for_cols<P>(s, [&](int x, int t, const auto& ex) {
      float2 v[kE];
      fresh<P>(v);
      load_line<P>(v, t, ex);
      P::template dif<kBf16>(v, t, ex);
      each_freq<P>(t, ex, [&](auto i, int f) {
        const int k = f * kN + x;
        if constexpr (kDh) kst[z * kNN + k] = v[i];
        const float2 hv = __ldg(h + k);
        v[i] = cmul(v[i], make_float2(hv.x * kInvNN, hv.y * kInvNN));
      });
      P::template dit<kBf16>(v, t, ex);
      store_line<P>(v, t, ex);
    });
    __syncthreads();
  }
}

template <class S>
__global__ void __launch_bounds__(kFwdBlock<S>)
chain_fwd_kernel(const float* __restrict__ obja, const float* __restrict__ objp,
                 const float2* __restrict__ probe, const float2* __restrict__ h,
                 float* __restrict__ inten, int pmode, int nz, int shared_probe, int h_shared,
                 int kspace) {
  using P = typename S::template Plan<kFwdThreads>;
  constexpr int kN = P::kN, kE = P::kE, kNN = P::kNN;
  constexpr float kInvNN = 1.0f / kNN;
  extern __shared__ float2 smem[];
  const int b = blockIdx.x / pmode;
  const int p = blockIdx.x % pmode;

  run_chain<P, false>(smem, probe + (static_cast<size_t>(shared_probe ? 0 : b) * pmode + p) * kNN,
                      kspace != 0, obja + static_cast<size_t>(b) * nz * kNN,
                      objp + static_cast<size_t>(b) * nz * kNN,
                      h + static_cast<size_t>(h_shared ? 0 : b) * kNN, nullptr, nullptr, nz);
  // the far field: the column transforms, |Y|^2 / N^2 in natural order
  float* out = inten + static_cast<size_t>(blockIdx.x) * kNN;
  for_cols<P>(smem, [&](int x, int t, const auto& ex) {
    float2 v[kE];
    fresh<P>(v);
    load_line<P>(v, t, ex);
    P::template dif<kBf16>(v, t, ex);
    each_freq<P>(t, ex, [&](auto i, int f) {
      out[f * kN + x] = (v[i].x * v[i].x + v[i].y * v[i].y) * kInvNN;
    });
  });
}

// dp = the sum over modes of inten, in mode order (B4a)
template <class Pix>
__global__ void __launch_bounds__(kSumThreads)
mode_sum_kernel(const float* __restrict__ inten, float* __restrict__ dp, int pmode, Pix pix,
                size_t total) {
  const size_t nn = pix.nn();
  for (size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = pix.div(t);
    const float* src = inten + b * pmode * nn + pix.mod(t);
    float d = 0.0f;
    for (int q = 0; q < pmode; ++q) d += src[q * nn];
    dp[t] = d;
  }
}

__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : 0.0f;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

// B3a's epilogue, grid (chunks, B): block (c, b) takes chunk c of sample b's
// N^2 pixels (ceil(N^2 / chunks) of them, the last chunk the rest), sums the
// modes into dp in mode order, and writes the masked partial sums of s1
// and s2 over its pixels to partial (B, chunks, 2).
template <class Pix>
__global__ void __launch_bounds__(kSumThreads)
loss_reduce_kernel(const float* __restrict__ inten, const float* __restrict__ meas,
                   const float* __restrict__ mask, float* __restrict__ dp,
                   float* __restrict__ partial, int pmode, Pix pix, float p, float eps) {
  __shared__ float red[kSumThreads / 32];
  const size_t nn = pix.nn();
  const size_t b = blockIdx.y;
  constexpr bool kExact = std::is_same_v<Pix, regfft::Pow2Pix>;  // chunks divide N^2
  const size_t per = kExact ? nn / gridDim.x : (nn + gridDim.x - 1) / gridDim.x;
  const size_t first = b * nn + blockIdx.x * per;
  const size_t stop = kExact || first + per < (b + 1) * nn ? first + per : (b + 1) * nn;
  float s1 = 0.0f;
  float s2 = 0.0f;
  for (size_t i = first + threadIdx.x; i < stop; i += blockDim.x) {
    const float* src = inten + (b * pmode) * nn + (i - b * nn);
    float d = 0.0f;
    for (int q = 0; q < pmode; ++q) d += src[q * nn];
    dp[i] = d;
    const float mp = pow_p(meas[i], p);
    const float diff = pow_p(d + eps, p) - mp;
    s1 += diff * diff;
    s2 += mp;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    float* out = partial + 2 * (b * gridDim.x + blockIdx.x);
    out[0] = mask[b] * s1;
    out[1] = mask[b] * s2;
  }
}

// s1, s2 = the sums of the count partials, in a fixed order: lane l adds
// partials l, l + 32, ..., then the warp adds its lanes in a fixed tree
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                                    int count) {
  float s1 = 0.0f;
  float s2 = 0.0f;
  for (int i = threadIdx.x; i < count; i += 32) {
    s1 += partial[2 * i];
    s2 += partial[2 * i + 1];
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (threadIdx.x == 0) {
    sums[0] = s1;
    sums[1] = s2;
  }
}

// The backward of one (sample, mode) wavefield. kLoss (B3b): the dp
// cotangent is formed here from meas, mask, the forward's dp and c; else
// (B4b) it is read from g. Leaves dT_z in place of each entry state in the
// stack, and the probe's cotangent in d_probe (per-position probe) or in
// this wavefield's probe_part field (shared probe); dt_reduce.cuh reduces
// both. kDh (need_dh): the recompute stores each K_z in kstack (B pmode,
// nz - 1, N, N) and the walk accumulates this wavefield's sum_z U_z
// conj(K_z) into its dh_part field, in natural order; without it both
// pointers are ignored.
template <class S, bool kLoss, bool kDh>
__global__ void __launch_bounds__(kBwdBlock<S>)
chain_bwd_kernel(const float* __restrict__ obja, const float* __restrict__ objp,
                 const float2* __restrict__ probe, const float2* __restrict__ h,
                 const float* __restrict__ g, const float* __restrict__ meas,
                 const float* __restrict__ mask, const float* __restrict__ dp,
                 const float* __restrict__ c, float2* __restrict__ stack, float2* kstack,
                 float2* dh_part, float2* __restrict__ d_probe, float2* __restrict__ probe_part,
                 int pmode, int nz, int shared_probe, int h_shared, int kspace, float p,
                 float eps) {
  using P = typename S::template Plan<kBwdThreads>;
  constexpr int kN = P::kN, kE = P::kE, kNN = P::kNN;
  constexpr float kInvNN = 1.0f / kNN;
  extern __shared__ float2 smem[];
  const int b = blockIdx.x / pmode;
  const int pm = blockIdx.x % pmode;
  const size_t pr_off = (static_cast<size_t>(shared_probe ? 0 : b) * pmode + pm) * kNN;
  const float2* h_b = h + static_cast<size_t>(h_shared ? 0 : b) * kNN;
  float2* kst = kDh ? kstack + static_cast<size_t>(blockIdx.x) * (nz - 1) * kNN : nullptr;
  float2* dacc = kDh ? dh_part + static_cast<size_t>(blockIdx.x) * kNN : nullptr;
  const float* a_b = obja + static_cast<size_t>(b) * nz * kNN;
  const float* phi_b = objp + static_cast<size_t>(b) * nz * kNN;
  float2* st = stack + static_cast<size_t>(blockIdx.x) * nz * kNN;

  // recompute the chain, keeping each slice's entry state
  run_chain<P, kDh>(smem, probe + pr_off, kspace != 0, a_b, phi_b, h_b, st, kst, nz);

  // the far field Y (column transforms); dY = 2 g Y / N^2, g the cotangent
  // of dp; then the adjoint column transforms
  const float* g_b = kLoss ? dp + static_cast<size_t>(b) * kNN : g + static_cast<size_t>(b) * kNN;
  const float* m_b = kLoss ? meas + static_cast<size_t>(b) * kNN : nullptr;
  // B3b: g = c mask 2p ((dp+eps)^p - meas^p) (dp+eps)^(p-1)
  const float coef = kLoss ? c[0] * mask[b] * 2.0f * p * 2.0f * kInvNN : 2.0f * kInvNN;
  for_cols<P>(smem, [&](int x, int t, const auto& ex) {
    float2 v[kE];
    fresh<P>(v);
    load_line<P>(v, t, ex);
    P::template dif<kBf16>(v, t, ex);
    each_freq<P>(t, ex, [&](auto i, int f) {
      const int k = f * kN + x;
      float gk;
      if constexpr (kLoss) {
        const float d = g_b[k] + eps;
        gk = (pow_p(d, p) - pow_p(m_b[k], p)) * pow_pm1(d, p);
      } else {
        gk = g_b[k];
      }
      v[i] = cscale(v[i], coef * gk);
    });
    P::template dit<kBf16>(v, t, ex);
    store_line<P>(v, t, ex);
  });
  __syncthreads();

  float2* out = shared_probe ? probe_part + static_cast<size_t>(blockIdx.x) * kNN
                             : d_probe + pr_off;
  for (int z = nz - 1; z >= 0; --z) {
    const bool probe_rows = z == 0 && !kspace;  // d probe leaves from the row phase
    // the inverse row transform (of the far field's adjoint or the adjoint
    // propagation): d chi; dT against the entry state, stored in its slot;
    // d psi = d chi conj(T); the forward row transform of the adjoint
    // propagation to slice z - 1
    for_rows<P>(smem, [&](int y, int t, const auto& ex) {
      float2 v[kE];
      fresh<P>(v);
      load_freq<P>(v, t, ex);
      P::template dit<kBf16>(v, t, ex);
      const int row = z * kNN + y * kN;
      each_point<P>(t, ex, [&](auto m, int a) {
        const int k = row + a;
        float sn, cs;
        sincosf(phi_b[k], &sn, &cs);
        const float amp = a_b[k];
        st[k] = cmul_conj(v[m], st[k]);  // dT = d chi conj(psi)
        v[m] = cmul_conj(v[m], make_float2(amp * cs, amp * sn));
      });
      if (probe_rows) {
        each_point<P>(t, ex, [&](auto m, int a) { out[y * kN + a] = v[m]; });
      } else {
        P::template dif<kBf16>(v, t, ex);
        store_freq<P>(v, t, ex);
      }
    });
    if (probe_rows) break;
    __syncthreads();
    if (z > 0) {
      // the adjoint propagation's column phase: forward transform (U),
      // (dH += U conj(K)), conj(H) / N^2, inverse transform
      for_cols<P>(smem, [&](int x, int t, const auto& ex) {
        float2 v[kE];
        fresh<P>(v);
        load_line<P>(v, t, ex);
        P::template dif<kBf16>(v, t, ex);
        each_freq<P>(t, ex, [&](auto i, int f) {
          const int k = f * kN + x;
          if constexpr (kDh) {
            float2 d = cmul_conj(v[i], kst[(z - 1) * kNN + k]);
            if (z != nz - 1) d = make_float2(d.x + dacc[k].x, d.y + dacc[k].y);
            dacc[k] = d;
          }
          const float2 hv = __ldg(h_b + k);
          v[i] = cmul_conj(v[i], make_float2(hv.x * kInvNN, hv.y * kInvNN));
        });
        P::template dit<kBf16>(v, t, ex);
        store_line<P>(v, t, ex);
      });
      __syncthreads();
    } else {
      // kspace: the spectrum's cotangent, fft2(d psi_0) / N^2
      for_cols<P>(smem, [&](int x, int t, const auto& ex) {
        float2 v[kE];
        fresh<P>(v);
        load_line<P>(v, t, ex);
        P::template dif<kBf16>(v, t, ex);
        each_freq<P>(t, ex, [&](auto i, int f) { out[f * kN + x] = cscale(v[i], kInvNN); });
      });
    }
  }
}

// f(S{}) for the shape of N: a power of two up to 128, or (built with a
// mixed plan) that plan's N alone
#ifdef PTYRAD_MIXED_LINE
template <class F>
cudaError_t with_shape(int n, F&& f) {
  if (n != MixedShape::kN) return cudaErrorInvalidValue;
  return f(MixedShape{});
}
#else
template <class F>
cudaError_t with_shape(int n, F&& f) {
  if (n < 2 || n > (1 << kMaxLogN) || (n & (n - 1)) != 0) return cudaErrorInvalidValue;
  return with_logn<kMaxLogN>(regfft::log2i(n), [&](auto L) -> cudaError_t {
    return f(Pow2Shape<decltype(L)::value>{});
  });
}
#endif

// Set-up once per (device, N) (regfft::prepare_once): the twiddle tables
// and the shared-memory limits of the five chain kernels of that N. After
// it a launch checks one flag and does no set-up (ptyrad_fused_prepare).
cudaError_t prepare(int n) {
  return with_shape(n, [](auto shape) -> cudaError_t {
    using S = decltype(shape);
    return regfft::prepare_once<kMaxLogN>(S::kKey, [](int) -> cudaError_t {
      REGFFT_TRY(S::upload());
      constexpr size_t smem = S::template Plan<kBwdThreads>::kSmem;
      REGFFT_TRY(set_smem(chain_fwd_kernel<S>, S::template Plan<kFwdThreads>::kSmem));
      REGFFT_TRY(set_smem(chain_bwd_kernel<S, false, false>, smem));
      REGFFT_TRY(set_smem(chain_bwd_kernel<S, false, true>, smem));
      REGFFT_TRY(set_smem(chain_bwd_kernel<S, true, false>, smem));
      return set_smem(chain_bwd_kernel<S, true, true>, smem);
    });
  });
}

cudaError_t launch_chain_fwd(const float* obja, const float* objp, const float2* probe,
                             const float2* h, float* inten, int B, int pmode, int nz, int n,
                             int shared_probe, int h_shared, int kspace, cudaStream_t st) {
  REGFFT_TRY(prepare(n));
  return with_shape(n, [&](auto shape) -> cudaError_t {
    using S = decltype(shape);
    using P = typename S::template Plan<kFwdThreads>;
    chain_fwd_kernel<S><<<B * pmode, P::kThreads, P::kSmem, st>>>(
        obja, objp, probe, h, inten, pmode, nz, shared_probe, h_shared, kspace);
    return cudaGetLastError();
  });
}

// Launches the backward, then the fixed-order reduces of dt_reduce.cuh
// (the object cotangents; a shared probe's); with dh (need_dh), then
// reduces the partials into dh (zero for a single slice, which propagates
// nowhere).
template <bool kLoss>
cudaError_t launch_chain_bwd(const float* obja, const float* objp, const float2* probe,
                             const float2* h, const float* g, const float* meas,
                             const float* mask, const float* dp, const float* c, float2* stack,
                             float2* kstack, float2* dh_part, float2* dh, float* d_obja,
                             float* d_objp, float2* d_probe, float2* probe_part, int B, int pmode,
                             int nz, int n, int shared_probe, int h_shared, int kspace,
                             float p, float eps, cudaStream_t st) {
  REGFFT_TRY(prepare(n));
  const size_t nn = static_cast<size_t>(n) * n;
  const bool with_dh = dh != nullptr && nz > 1;
  if (shared_probe && probe_part == nullptr) return cudaErrorInvalidValue;
  if (dh != nullptr && !with_dh) {
    REGFFT_TRY(cudaMemsetAsync(dh, 0, sizeof(float2) * (h_shared ? 1 : B) * nn, st));
  }
  return with_shape(n, [&](auto shape) -> cudaError_t {
    using S = decltype(shape);
    using P = typename S::template Plan<kBwdThreads>;
    // without dH the instantiation that never touches the dH scratch
    auto kernel = with_dh ? chain_bwd_kernel<S, kLoss, true> : chain_bwd_kernel<S, kLoss, false>;
    kernel<<<B * pmode, P::kThreads, P::kSmem, st>>>(
        obja, objp, probe, h, g, meas, mask, dp, c, stack, kstack, dh_part, d_probe, probe_part,
        pmode, nz, shared_probe, h_shared, kspace, p, eps);
    REGFFT_TRY(cudaGetLastError());
    REGFFT_TRY(dt::obj(stack, obja, objp, d_obja, d_objp, B, pmode, nz, nn, st));
    if (shared_probe) REGFFT_TRY(dt::probe(probe_part, d_probe, B, pmode, nn, st));
    if (!with_dh) return cudaSuccess;
    return dh::reduce_pix(dh_part, dh, B, pmode, h_shared, S::pix(), st);
  });
}

// B3a's epilogue blocks per sample: min(N, 16)
constexpr int chunks(int n) { return n < 16 ? n : 16; }

}  // namespace

extern "C" {

// B4a. obja, objp (B, 1, nz, N, N) f32; probe (B or 1, pmode, N, N)
// complex64; h (B or 1, N, N) complex64 (h_shared: one H for all). Writes
// the inten (B, pmode, N, N) scratch and dp (B, N, N), corner-centred.
int PTYRAD_ENTRY(ptyrad_dp_fwd)(
    const float* obja, const float* objp, const float2* probe, const float2* h, float* inten,
    float* dp, int B, int pmode, int nz, int n, int shared_probe, int h_shared, int kspace,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_chain_fwd(obja, objp, probe, h, inten, B, pmode, nz, n,
                                     shared_probe, h_shared, kspace, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(with_shape(n, [&](auto shape) -> cudaError_t {
    const size_t total = static_cast<size_t>(B) * n * n;
    const size_t blocks = (total + kSumThreads - 1) / kSumThreads;
    mode_sum_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), kSumThreads, 0,
                      st>>>(inten, dp, pmode, decltype(shape)::pix(), total);
    return cudaGetLastError();
  }));
}

// B4b. As ptyrad_dp_fwd, plus g (B, N, N) the dp cotangent, corner-centred,
// stack (B, pmode, nz, N, N) complex64 scratch and, for a shared probe,
// probe_part (B, pmode, N, N) complex64 scratch (else null). Writes d_obja,
// d_objp (B, 1, nz, N, N) and d_probe (the probe's shape), each summed in a
// fixed order. With dh (H's shape) not null it also writes the propagator
// cotangent, through the scratches kstack (B, pmode, nz - 1, N, N) and
// dh_part (B, pmode, N, N).
int PTYRAD_ENTRY(ptyrad_dp_bwd)(
    const float* obja, const float* objp, const float2* probe, const float2* h, const float* g,
    float2* stack, float2* kstack, float2* dh_part, float2* dh, float* d_obja, float* d_objp,
    float2* d_probe, float2* probe_part, int B, int pmode, int nz, int n, int shared_probe,
    int h_shared, int kspace, void* stream) {
  return static_cast<int>(launch_chain_bwd<false>(
      obja, objp, probe, h, g, nullptr, nullptr, nullptr, nullptr, stack, kstack, dh_part, dh,
      d_obja, d_objp, d_probe, probe_part, B, pmode, nz, n, shared_probe, h_shared, kspace,
      1.0f, 0.0f, static_cast<cudaStream_t>(stream)));
}

// B3a. As ptyrad_dp_fwd, plus meas (B, N, N) f32 corner-centred and mask
// (B,) f32. Writes the inten (B, pmode, N, N) and partial (B, chunks, 2)
// scratch (chunks = min(N, 16), ptyrad_fused_plan), dp (B, N, N) and
// sums (2,) = (s1, s2).
int PTYRAD_ENTRY(ptyrad_loss_fwd)(
    const float* obja, const float* objp, const float2* probe, const float2* h, const float* meas,
    const float* mask, float* inten, float* dp, float* partial, float* sums, int B, int pmode,
    int nz, int n, int shared_probe, int h_shared, int kspace, float p, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_chain_fwd(obja, objp, probe, h, inten, B, pmode, nz, n,
                                     shared_probe, h_shared, kspace, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = with_shape(n, [&](auto shape) -> cudaError_t {
    loss_reduce_kernel<<<dim3(chunks(n), B), kSumThreads, 0, st>>>(
        inten, meas, mask, dp, partial, pmode, decltype(shape)::pix(), p, eps);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, 32, 0, st>>>(partial, sums, B * chunks(n));
  return static_cast<int>(cudaGetLastError());
}

// B3b. As ptyrad_loss_fwd, plus dp (the forward's residual), c (scalar
// cotangent of s1, on the device), stack (B, pmode, nz, N, N) complex64
// scratch and probe_part as for ptyrad_dp_bwd. Writes d_obja, d_objp,
// d_probe and (with dh) the propagator cotangent as ptyrad_dp_bwd does.
int PTYRAD_ENTRY(ptyrad_loss_bwd)(
    const float* obja, const float* objp, const float2* probe, const float2* h, const float* meas,
    const float* mask, const float* dp, const float* c, float2* stack, float2* kstack,
    float2* dh_part, float2* dh, float* d_obja, float* d_objp, float2* d_probe,
    float2* probe_part, int B, int pmode, int nz, int n, int shared_probe, int h_shared,
    int kspace, float p, float eps, void* stream) {
  return static_cast<int>(launch_chain_bwd<true>(
      obja, objp, probe, h, nullptr, meas, mask, dp, c, stack, kstack, dh_part, dh, d_obja,
      d_objp, d_probe, probe_part, B, pmode, nz, n, shared_probe, h_shared, kspace, p, eps,
      static_cast<cudaStream_t>(stream)));
}

// The set-up of N on the current device (prepare): a launch after it does
// none.
int PTYRAD_ENTRY(ptyrad_fused_prepare)(int n) { return static_cast<int>(prepare(n)); }

#if !PTYRAD_BF16_OPERANDS
// The plan for N, which the card-only tests and chip_smoke.py hold against
// tests/test_torch_fused_plan.py's and ops/fused_plan.py's (reported): out
// gets N, E, TL, the padded row length, the row padding's shift, the
// forward chain block's threads and its row and column sweeps, the same for
// the backward's block, a column group's threads, the forward block's
// shared bytes, the B3a epilogue's blocks per sample, the line kind (0 the
// radix-2 pair, 1 the mixed-radix pair, 2 a Bluestein line), a line's slots
// (N, or M), the forward block's scratch bytes, the scratch row and its
// shift (0 without a scratch).
int ptyrad_fused_plan(int n, int* out) {
  return static_cast<int>(with_shape(n, [&](auto shape) -> cudaError_t {
    using S = decltype(shape);
    using F = typename S::template Plan<kFwdThreads>;
    using B = typename S::template Plan<kBwdThreads>;
    int kind = 0, slots = F::kN, scratch = 0, scr_row = 0, scr_pad = 0;
    if constexpr (!F::kPow2) {
      kind = 1;
      if constexpr (F::kBluestein) {
#ifdef PTYRAD_BLUESTEIN
        kind = 2;
        slots = F::kSlots;
        scratch = static_cast<int>(sizeof(float2) * F::kScratch);
        scr_row = F::kScrLine;
        scr_pad = F::kScrPadShift;
#endif
      }
    }
    const int v[] = {F::kN, F::kE, F::kTl, F::kLine, F::kPadShift, F::kThreads, F::kRowSweeps,
                     F::kColSweeps, B::kThreads, B::kRowSweeps, B::kColSweeps, F::kGroupThreads,
                     static_cast<int>(F::kSmem), chunks(n), kind, slots, scratch, scr_row,
                     scr_pad};
    for (int i = 0; i < 19; ++i) out[i] = v[i];
    return cudaSuccess;
  }));
}
#endif  // !PTYRAD_BF16_OPERANDS

}  // extern "C"
