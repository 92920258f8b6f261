// Segmented multislice chain (B5, B6) for sm_90a: forward and backward.
//
// Replaces the TPU kernels of ptyrad_tpu/ops/pallas_chain.py:
//   B5a  _seg_fwd_kernel  (:238, pallas_call :1018, chain_segment :1045)
//   B5b  _seg_bwd_kernel  (:279, pallas_call :1120)
//   B6a  _mega_fwd_kernel (:466, pallas_call :810, chain_stack :841)
//   B6b  _mega_bwd_kernel (:529, pallas_call :942)
// with the propagator cotangents (need_dh: _seg_bwd_kernel :330-334,
// :369-373, _acc_dh :396; _mega_bwd_kernel :552-564, :593-597, :632-636,
// _acc_dh_mega :651) and B5's far-field exit (set_far_field :738, off by
// default there: _seg_fwd_kernel :250/:273, _seg_bwd_kernel :289/:323).
//
// Contract, per sample b and probe mode p (complex64 wavefields):
//   for slice z of the chain:  chi_z = psi_z * T_z,  T_z = a_z exp(i phi_z)
//                               psi_{z+1} = ifft2(H * fft2(chi_z))
//   except after the chain's final slice when `last` (B5) / `last_mega` (B6)
//   is set: then the exit is chi of the final slice, unpropagated; or, for
//   B5 with `far_field` (needs `last`), its centred detector-plane spectrum
//   Y = fftshift(fft2(chi)), unnormalised, in natural order (the caller folds
//   1/N^2 into the intensity). The adjoint of that exit is the unnormalised
//   inverse transform of the unshifted cotangent; it adds nothing to dH.
//   B6a also writes the segment-entry stack (B, S, pmode, N, N): entry s is
//   psi at the first slice of segment s (entry 0 is psi0).
//   Backward: the adjoint of ifft2(H fft2(.)) is ifft2(conj(H) fft2(.)); the
//   transmission adjoint gives d psi = d chi conj(T) and
//   dT = sum_p d chi conj(psi), so d a = Re(dT e^{-i phi}) and
//   d phi = a Im(dT e^{-i phi}). B5b rebuilds its segment's slice-entry
//   states from the entry psi; B6b walks the segments in reverse, rebuilds
//   each from its stacked entry into a scratch of Sg fields, and carries the
//   cotangent across segment boundaries.
//   dH (on request): with K = fft2(chi) of each propagation and U = fft2 of
//   the cotangent it delivers, dH = (1/N^2) sum_prop sum_p U conj(K),
//   summed over samples too for a shared H.
//
// Bound on the card. A 256^2 complex64 field is 512 KB, more than one
// block's shared memory (227 KB), so the field moves through device memory
// twice per slice:
//   row pass     [the previous propagation's row IFFT], the T multiply,
//                the row FFT
//   column pass  the column FFT, the H multiply, the column IFFT
// At PSO shapes (B=32, pmode=4, N=256) one field is 64 MiB, so a pass moves
// 134 MB: 40 us at 3.35 TB/s, against about 10 us for its two 1D transforms
// at 67 TFLOP/s. A pass is bound by its bytes; the design keeps the work of
// a pass under that traffic.
//
// Design (ptyrad_chain_plan reports Plan; tests/test_torch_chain_plan.py
// emulates it):
//  * Transforms in registers (reg_fft.cuh, shared with multislice.cu's B3
//    and B4). Each thread holds E = 16 points of a line (N
//    points below 16) at positions t + TL m, TL = N / E threads per line,
//    and runs Stockham radix passes there: N = 256 is 16 x 16, N = 128
//    16 x 8, N = 512 16 x 16 x 2. Each radix-R butterfly is an unrolled
//    radix-2 network on compile-time indices; the only trip through shared
//    memory is one exchange between two passes (a store, a barrier, a load).
//    A thread loads its points at t + TL m and the last pass leaves frequency
//    t + TL m in the same registers, so every transform is natural in and
//    natural out: no permutation sits between the passes, H and the dH
//    partials are in natural order, and the T and H multiplies need no
//    exchange.
//  * Pass twiddles exp(-2 pi i r k / (Ns R)) come from a table in device
//    memory, filled once per device from double precision (prepare)
//    and laid out so that a warp's reads are adjacent (g_twiddle); the radix
//    networks' own are literals. Index math is shifts and masks: every
//    kernel is a template on log2 N, dispatched by with_logn over
//    N = 2 ... 512.
//  * Device memory to registers and back directly: a row-pass thread reads
//    8 B at stride TL (a warp covers whole 128-byte lines), a column-pass
//    block holds 16 adjacent columns (16 x 8 B = 128 B per row) with the
//    column fastest across threads.
//  * A row-pass block holds a warp's worth of rows (32 / TL) of one sample
//    and ALL its probe modes: G = min(pmode, 4) warps, one per mode group,
//    warp g taking modes g, g + G, ... T is computed once per pixel into
//    shared memory by the whole block; the backward sums
//    dT = sum_p d chi conj(psi) in registers over a warp's modes, then over
//    the warps in order through shared memory, so d a and d phi are written
//    once, with no atomics, and are deterministic. Small blocks with one
//    mode a warp keep many loads in flight and the last wave short. A row's
//    threads share a warp, so its exchange waits on __syncwarp; the row's
//    line in shared memory is padded (element a at a + a / 16), which keeps
//    the radix-16 stores free of bank conflicts. The column tile's exchange
//    is interleaved by column and waits on __syncthreads.
//  * Launch shape: a sequence of pass kernels on the caller's stream (the
//    stream orders them; nothing synchronises). Each pass works in place on
//    its own elements, so one working buffer carries the field.
//  * dH. Every propagation's K and U exist in the column pass, after its
//    column FFT and before the H multiply. The rebuild's column passes store
//    K to a scratch of sg fields, extended by one slice so that the
//    propagation out of the segment's final slice has its K too; the adjoint
//    column passes read it back and accumulate U conj(K) into a
//    per-(sample, mode) partial field; after the walk dh_reduce.cuh sums the
//    modes, and the samples for a shared H, in a fixed order. The adjoint of
//    the propagation out of a segment's final slice runs its row pass at the
//    end of the later segment's walk and its column pass after this
//    segment's rebuild, where K exists (the order of pallas_chain.py:589-604):
//    no pass is added. The dH work lives in col_kernel<., true> only.
//  * The far-field exit rides on the passes: the final slice's row pass runs
//    its row FFT after the T multiply and stores point m of a thread from
//    register m ^ E/2 (column x holds kx = x ^ N/2, the shifted order; the
//    stores stay whole lines), and one more column pass (col_ff_kernel:
//    column FFT only) stores row ky at ky ^ N/2. The adjoint loads through
//    the same maps and runs the unnormalised inverse transforms. No 1/N^2
//    anywhere there; the 1/N^2 of a propagation rides on H. The permuting
//    store and load are template flags (kFf) of the row kernels.
//  * FP32 throughout, accurate sincosf.
//  * The bfloat16 compute policy: chain_bf16.cu compiles this file with
//    PTYRAD_BF16_OPERANDS 1, so every line transform (line_fft: the row and
//    column passes, forward and adjoint, and the far-field exit's) rounds
//    its points to bfloat16 first, as the JAX chain rounds each pass's GEMM
//    operand (pallas_chain.py:221-228, :270-274, :317-336, :368-375,
//    :492-504). T and H multiplies, the dT and dH sums and every field
//    written between passes stay FP32; its entry points carry the suffix
//    _bf16. This file alone (the default, 0) compiles the FP32 kernels as
//    they were.
//  * N in (128, 512] that is not a power of two (192, 384, 509, ...): the
//    same pass structure and walks on the mixed-radix pair of reg_fft.cuh
//    (line_dif_mr forward, line_dit_mr its conjugate transpose) with the
//    plan ops/chain_plan.py chooses for that N, which this file takes as
//    macros (PTYRAD_MIXED_LINE, PTYRAD_MIXED_ROW, PTYRAD_MIXED_PAD):
//    ops/_build.py compiles it, and its _bf16 twin, once per such N into a
//    library of its own whose entry points take that N alone. Without the
//    macros the file builds the powers of two as before. A row's T <= 32
//    threads share a warp (32 / T rows a mode group, lanes past them idle);
//    a column-pass block holds 16 columns of T threads. The forward leaves
//    frequency digitrev(position) at each position, so the spectra stay in
//    that order on both axes: the x-spectrum is stored between the passes
//    at the positions the transform leaves it, the column pass multiplies
//    H at the positions it leaves, and the caller hands the kernels H
//    gathered with the plan's permutation on both axes (the dH partials,
//    and dH, come back in that order). The far-field exit stores frequency
//    f at (f + N / 2) % N on both axes (fftshift's roll at any N) and its
//    adjoint loads through the same map. Rows and columns past N idle: an
//    idle thread runs every barrier and touches no device memory.
//  * every N in (128, 512] with a prime factor above 7 (ops/chain_plan.py)
//    (254 = 2 x 127, 509, ...): the same build on reg_fft.cuh's Bluestein
//    line (PTYRAD_BLUESTEIN; the line type regfft::BluesteinLine<N, an
//    M-point MixedLine>, M the 7-smooth size of the cyclic convolution,
//    M >= 2 N - 1), through line_fwd / line_inv. A sum pass of a prime p
//    costs O(p) loads and FMAs a point; the Bluestein line two M-point
//    register-pass transforms and three pointwise products. Its spectrum is
//    in natural order in the points' own layout (kPasses = 1), so H goes in
//    as it is; a line's exchange slots, the padded row and the column tile
//    hold M points (MPlan::kSlots), the T tile N.

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
#include "reg_fft.cuh"

namespace {

using regfft::cmul;
using regfft::cmul_conj;
using regfft::ColExchange;
using regfft::line_fft;
using regfft::RowExchange;
using regfft::set_smem;
using regfft::static_for;
using regfft::with_logn;

constexpr int kMaxLogN = 9;  // N <= 512
constexpr bool kBf16 = PTYRAD_BF16_OPERANDS != 0;  // every line transform rounds its operand

template <int LOGN>
struct Plan {
  // the line transform (reg_fft.cuh)
  using Line = regfft::LinePlan<LOGN>;
  static constexpr int kN = Line::kN, kLogE = Line::kLogE, kE = Line::kE;
  static constexpr int kLogTl = Line::kLogTl, kTl = Line::kTl, kPasses = Line::kPasses;
  static constexpr int kR0 = Line::kR0, kR1 = Line::kR1, kR2 = Line::kR2;
  // a row-pass block: kRows rows (a warp's worth of threads, kGroup) for
  // each of up to kMaxGroups mode groups; group g walks modes g, g + G, ...
  static constexpr int kRows = kN < (32 >> kLogTl) ? kN : (32 >> kLogTl);
  static constexpr int kGroup = kRows * kTl;
  static constexpr int kMaxGroups = 4;
  static constexpr int kLogCols = kLogE;
  static constexpr int kCols = 1 << kLogCols;
  static constexpr int kLine = kN + kN / 16;       // a row's padded line in shared memory
  static constexpr int kColThreads = kCols * kTl;
  static constexpr size_t kColSmem = kPasses > 1 ? sizeof(float2) * kCols * kN : 0;
  static constexpr int groups(int pmode) { return pmode < kMaxGroups ? pmode : kMaxGroups; }
  // the block's T tile, then each group's lines (the backward's partial dT
  // sums reuse them after the mode loop)
  static constexpr size_t row_smem(int g) {
    return sizeof(float2) * (static_cast<size_t>(kRows) * kN +
                             static_cast<size_t>(g) * kRows * kLine);
  }
};

// Row pass of the forward chain, for rows y0..y0+R-1 of sample b, all modes
// (grid (N / R, B), G = min(pmode, 4) warps of R rows, one per mode group).
// Loads src (its rows in frequency when `pending`: the previous
// propagation's row IFFT is still to do), finishes that IFFT, stores the
// natural state to `entry` if given, multiplies by T if a is given, runs the
// row FFT if `fft`, and writes dst if given. T is computed once per pixel,
// into shared memory, by the whole block. kFf (the far-field exit; needs
// `fft`): column x of dst holds kx = x ^ N/2.
template <int LOGN, bool kFf>
__global__ void __launch_bounds__(Plan<LOGN>::kGroup * Plan<LOGN>::kMaxGroups)
row_fwd_kernel(const float2* src, long long src_bs, int pending, float2* entry,
               long long entry_bs, const float* __restrict__ a, const float* __restrict__ ph,
               long long obj_bs, int fft, float2* dst, long long dst_bs, int pmode) {
  using P = Plan<LOGN>;
  constexpr int kE = P::kE, kTl = P::kTl, kTile = P::kRows * P::kN;
  extern __shared__ float2 smem[];
  const int groups = blockDim.x / P::kGroup;
  const int group = threadIdx.x / P::kGroup;
  const int line = (threadIdx.x % P::kGroup) >> P::kLogTl;
  const int t = threadIdx.x & (kTl - 1);
  const size_t b = blockIdx.y;
  const size_t tile = static_cast<size_t>(blockIdx.x * P::kRows) << LOGN;  // the block's pixels
  float2* tsm = smem;  // T of the tile's pixels
  const RowExchange ex{smem + kTile + (group * P::kRows + line) * P::kLine};
  const int pos = (line << LOGN) + t;  // the thread's pixels: pos + kTl m of the tile

  if (a != nullptr) {
    for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
      const size_t k = b * obj_bs + tile + e;
      float sn, cs;
      sincosf(ph[k], &sn, &cs);
      tsm[e] = make_float2(a[k] * cs, a[k] * sn);
    }
    __syncthreads();
  }
  for (int p = group; p < pmode; p += groups) {
    const size_t off = (static_cast<size_t>(p) << (2 * LOGN)) + tile + pos;
    const float2* sp = src + b * src_bs + off;
    float2 v[kE];
    static_for<0, kE>([&](auto m) { v[m] = sp[m * kTl]; });
    if (pending) line_fft<LOGN, true, kBf16>(v, t, ex);
    if (entry != nullptr) {
      float2* ep = entry + b * entry_bs + off;
      static_for<0, kE>([&](auto m) { ep[m * kTl] = v[m]; });
    }
    if (a != nullptr) {
      static_for<0, kE>([&](auto m) { v[m] = cmul(v[m], tsm[pos + m * kTl]); });
    }
    if (fft) line_fft<LOGN, false, kBf16>(v, t, ex);
    if (dst != nullptr) {
      float2* dp = dst + b * dst_bs + off;
      static_for<0, kE>([&](auto m) { dp[m * kTl] = v[kFf ? (m ^ (kE / 2)) : m]; });
    }
  }
}

// Row pass of the adjoint walk for slice z (grid and groups as
// row_fwd_kernel). Loads the cotangent d chi (pending: in frequency along x,
// its row IFFT still to do), forms each group's share of
// dT = sum_p d chi conj(psi) against the slice-entry state psi, multiplies
// by conj(T), runs the row FFT if `fft` (the adjoint propagation to the
// previous slice follows), and writes dst; then the block sums the groups'
// shares in group order and writes d a and d phi. kFf (the adjoint of the
// far-field exit; needs `pending`): column x of src holds kx = x ^ N/2.
template <int LOGN, bool kFf>
__global__ void __launch_bounds__(Plan<LOGN>::kGroup * Plan<LOGN>::kMaxGroups)
row_bwd_kernel(const float2* src, long long src_bs, int pending, const float2* __restrict__ psi,
               long long psi_bs, const float* __restrict__ a, const float* __restrict__ ph,
               long long obj_bs, float* __restrict__ da, float* __restrict__ dph,
               long long dobj_bs, int fft, float2* dst, long long dst_bs, int pmode) {
  using P = Plan<LOGN>;
  constexpr int kE = P::kE, kTl = P::kTl, kTile = P::kRows * P::kN;
  extern __shared__ float2 smem[];
  const int groups = blockDim.x / P::kGroup;
  const int group = threadIdx.x / P::kGroup;
  const int line = (threadIdx.x % P::kGroup) >> P::kLogTl;
  const int t = threadIdx.x & (kTl - 1);
  const size_t b = blockIdx.y;
  const size_t tile = static_cast<size_t>(blockIdx.x * P::kRows) << LOGN;
  float2* tsm = smem;
  float2* part = smem + kTile;  // after the mode loop: each group's dT share
  const RowExchange ex{smem + kTile + (group * P::kRows + line) * P::kLine};
  const int pos = (line << LOGN) + t;

  for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
    const size_t k = b * obj_bs + tile + e;
    float sn, cs;
    sincosf(ph[k], &sn, &cs);
    tsm[e] = make_float2(a[k] * cs, a[k] * sn);
  }
  __syncthreads();
  float2 dt[kE];
  static_for<0, kE>([&](auto m) { dt[m] = make_float2(0.0f, 0.0f); });
  for (int p = group; p < pmode; p += groups) {
    const size_t off = (static_cast<size_t>(p) << (2 * LOGN)) + tile + pos;
    const float2* sp = src + b * src_bs + off;
    const float2* pp = psi + b * psi_bs + off;
    float2 v[kE], ps[kE];  // psi is loaded with d chi, before the transform
    static_for<0, kE>([&](auto m) {
      v[m] = sp[(kFf ? (m ^ (kE / 2)) : m) * kTl];
      ps[m] = pp[m * kTl];
    });
    if (pending) line_fft<LOGN, true, kBf16>(v, t, ex);
    static_for<0, kE>([&](auto m) {
      const float2 q = cmul_conj(v[m], ps[m]);
      dt[m].x += q.x;
      dt[m].y += q.y;
      v[m] = cmul_conj(v[m], tsm[pos + m * kTl]);
    });
    if (fft) line_fft<LOGN, false, kBf16>(v, t, ex);
    float2* dp = dst + b * dst_bs + off;
    static_for<0, kE>([&](auto m) { dp[m * kTl] = v[m]; });
  }
  __syncthreads();  // the exchange lines become the partial sums
  static_for<0, kE>([&](auto m) { part[group * kTile + pos + m * kTl] = dt[m]; });
  __syncthreads();
  // d a = Re(dT e^{-i phi}), d phi = a Im(dT e^{-i phi}), dT summed over
  // the groups in order: a fixed order, no atomics
  for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
    float2 d = part[e];
    for (int g = 1; g < groups; ++g) {
      d.x += part[g * kTile + e].x;
      d.y += part[g * kTile + e].y;
    }
    const size_t k = b * obj_bs + tile + e;
    const size_t kd = b * dobj_bs + tile + e;
    float sn, cs;
    sincosf(ph[k], &sn, &cs);
    da[kd] = d.x * cs + d.y * sn;
    dph[kd] = a[k] * (d.y * cs - d.x * sn);
  }
}

// Column pass, in place (grid (N / C, pmode, B)): columns c0..c0+C-1 of
// field (b, p), which arrive with x in frequency. Column FFT, times H/N^2
// (conj(H)/N^2 for the adjoint), column IFFT. kDh (need_dh), after the
// column FFT: forward, K is stored to kbuf (and with h null the pass ends
// there); adjoint, dacc = U conj(K) (+= unless first) against K read from
// kbuf. kbuf and dacc are fields laid out as buf; without kDh they are
// ignored.
template <int LOGN, bool kDh>
__global__ void __launch_bounds__(Plan<LOGN>::kColThreads)
col_kernel(float2* buf, long long bs, const float2* __restrict__ h, long long h_bs, int conj_h,
           float2* kbuf, float2* dacc, int first) {
  using P = Plan<LOGN>;
  constexpr int kE = P::kE, kTl = P::kTl;
  extern __shared__ float2 smem[];
  const int c = threadIdx.x & (P::kCols - 1);
  const int t = threadIdx.x >> P::kLogCols;
  // the thread's elements: rows t + kTl m of column c0 + c, at col + (m kTl << LOGN)
  const size_t col = blockIdx.x * P::kCols + c + (static_cast<size_t>(t) << LOGN);
  const size_t fo = blockIdx.z * static_cast<size_t>(bs) +
                    (static_cast<size_t>(blockIdx.y) << (2 * LOGN)) + col;
  const ColExchange<P::kLogCols> ex{smem, c};
  float2* f = buf + fo;
  constexpr size_t kStep = static_cast<size_t>(kTl) << LOGN;

  float2 v[kE];
  static_for<0, kE>([&](auto m) { v[m] = f[m * kStep]; });
  line_fft<LOGN, false, kBf16>(v, t, ex);
  if constexpr (kDh) {
    float2* kb = kbuf + fo;
    if (!conj_h) {
      static_for<0, kE>([&](auto m) { kb[m * kStep] = v[m]; });
      if (h == nullptr) return;
    } else {
      float2* dc = dacc + fo;
      static_for<0, kE>([&](auto m) {
        float2 d = cmul_conj(v[m], kb[m * kStep]);
        if (!first) d = make_float2(d.x + dc[m * kStep].x, d.y + dc[m * kStep].y);
        dc[m * kStep] = d;
      });
    }
  }
  const float inv_nn = 1.0f / static_cast<float>(P::kN * P::kN);
  const float2* hb = h + blockIdx.z * static_cast<size_t>(h_bs) + col;
  static_for<0, kE>([&](auto m) {
    const float2 hv = hb[m * kStep];
    v[m] = cmul(v[m], make_float2(hv.x * inv_nn, (conj_h ? -hv.y : hv.y) * inv_nn));
  });
  line_fft<LOGN, true, kBf16>(v, t, ex);
  static_for<0, kE>([&](auto m) { f[m * kStep] = v[m]; });
}

// Column pass of the far-field exit (grid (N / C, pmode, B)), on columns
// c0..c0+C-1 of field (b, p) of src, into the same columns of dst (which may
// be src: each thread reads its elements before it writes them). Forward:
// the column FFT, row ky of the result stored at ky ^ N/2. kAdj, its
// adjoint: the rows loaded through the same map, then the unnormalised
// inverse column transform.
template <int LOGN, bool kAdj>
__global__ void __launch_bounds__(Plan<LOGN>::kColThreads)
col_ff_kernel(const float2* src, float2* dst, long long bs) {
  using P = Plan<LOGN>;
  constexpr int kE = P::kE, kTl = P::kTl;
  extern __shared__ float2 smem[];
  const int c = threadIdx.x & (P::kCols - 1);
  const int t = threadIdx.x >> P::kLogCols;
  const size_t fo = blockIdx.z * static_cast<size_t>(bs) +
                    (static_cast<size_t>(blockIdx.y) << (2 * LOGN)) + blockIdx.x * P::kCols + c +
                    (static_cast<size_t>(t) << LOGN);
  const ColExchange<P::kLogCols> ex{smem, c};
  constexpr size_t kStep = static_cast<size_t>(kTl) << LOGN;

  float2 v[kE];
  static_for<0, kE>([&](auto m) { v[m] = src[fo + (kAdj ? (m ^ (kE / 2)) : m) * kStep]; });
  if constexpr (kAdj) {
    line_fft<LOGN, true, kBf16>(v, t, ex);
  } else {
    line_fft<LOGN, false, kBf16>(v, t, ex);
  }
  static_for<0, kE>([&](auto m) { dst[fo + m * kStep] = v[kAdj ? m : (m ^ (kE / 2))]; });
}

#ifndef PTYRAD_MIXED_LINE
// Set-up once per (device, log2 N) (regfft::prepare_once): the twiddle table
// and the shared-memory limits of the eight kernels of that N. After it, a
// launch checks one flag and does no set-up, so a caller that warms up every
// N first (ptyrad_chain_prepare) can capture the launches in a CUDA graph.
cudaError_t prepare(int logn) {
  return regfft::prepare_once<kMaxLogN>(logn, [](int logn) {
    return with_logn<kMaxLogN>(logn, [](auto L) -> cudaError_t {
      constexpr int kL = decltype(L)::value;
      using P = Plan<kL>;
      const size_t row_smem = P::row_smem(P::kMaxGroups);
      REGFFT_TRY(set_smem(row_fwd_kernel<kL, false>, row_smem));
      REGFFT_TRY(set_smem(row_fwd_kernel<kL, true>, row_smem));
      REGFFT_TRY(set_smem(row_bwd_kernel<kL, false>, row_smem));
      REGFFT_TRY(set_smem(row_bwd_kernel<kL, true>, row_smem));
      REGFFT_TRY(set_smem(col_kernel<kL, false>, P::kColSmem));
      REGFFT_TRY(set_smem(col_kernel<kL, true>, P::kColSmem));
      REGFFT_TRY(set_smem(col_ff_kernel<kL, false>, P::kColSmem));
      return set_smem(col_ff_kernel<kL, true>, P::kColSmem);
    });
  });
}

// Shapes shared by every pass of one call.
struct Chain {
  int B, pmode, logn;
  long long nn, field_bs;  // N^2; a (B, pmode, N, N) field's per-sample stride
  const float2* h;
  long long h_bs;
  cudaStream_t st;

  cudaError_t init() {
    if (logn < 1 || logn > kMaxLogN || B < 1 || pmode < 1) return cudaErrorInvalidValue;
    nn = 1LL << (2 * logn);
    field_bs = pmode * nn;
    return prepare(logn);
  }

  cudaError_t row_fwd(const float2* src, long long src_bs, bool pending, float2* entry,
                      long long entry_bs, const float* a, const float* ph, long long obj_bs,
                      bool fft, float2* dst, bool ff = false) const {
    return with_logn<kMaxLogN>(logn, [&](auto L) -> cudaError_t {
      constexpr int kL = decltype(L)::value;
      using P = Plan<kL>;
      auto kernel = ff ? row_fwd_kernel<kL, true> : row_fwd_kernel<kL, false>;
      const int groups = P::groups(pmode);
      kernel<<<dim3(P::kN / P::kRows, B), P::kGroup * groups, P::row_smem(groups), st>>>(
          src, src_bs, pending, entry, entry_bs, a, ph, obj_bs, fft, dst, field_bs, pmode);
      return cudaGetLastError();
    });
  }

  cudaError_t row_bwd(const float2* src, bool pending, const float2* psi, long long psi_bs,
                      const float* a, const float* ph, long long obj_bs, float* da, float* dph,
                      long long dobj_bs, bool fft, float2* dst, bool ff = false) const {
    return with_logn<kMaxLogN>(logn, [&](auto L) -> cudaError_t {
      constexpr int kL = decltype(L)::value;
      using P = Plan<kL>;
      auto kernel = ff ? row_bwd_kernel<kL, true> : row_bwd_kernel<kL, false>;
      const int groups = P::groups(pmode);
      kernel<<<dim3(P::kN / P::kRows, B), P::kGroup * groups, P::row_smem(groups), st>>>(
          src, field_bs, pending, psi, psi_bs, a, ph, obj_bs, da, dph, dobj_bs, fft, dst,
          field_bs, pmode);
      return cudaGetLastError();
    });
  }

  // a propagation (conj_h: its adjoint); with kbuf, the dH variant of
  // col_kernel (kbuf, dacc, first as there), else the plain one; with h
  // null (and kbuf) only the column FFT, stored to kbuf (a final slice's K)
  cudaError_t col(float2* buf, bool conj_h, float2* kbuf = nullptr, float2* dacc = nullptr,
                  bool first = false, bool with_h = true) const {
    return with_logn<kMaxLogN>(logn, [&](auto L) -> cudaError_t {
      constexpr int kL = decltype(L)::value;
      using P = Plan<kL>;
      auto kernel = kbuf != nullptr ? col_kernel<kL, true> : col_kernel<kL, false>;
      kernel<<<dim3(P::kN / P::kCols, pmode, B), P::kColThreads, P::kColSmem, st>>>(
          buf, field_bs, with_h ? h : nullptr, h_bs, conj_h, kbuf, dacc, first);
      return cudaGetLastError();
    });
  }

  // the column FFT of buf only, stored to kbuf (the K of a final slice)
  cudaError_t col_k(float2* buf, float2* kbuf) const {
    return col(buf, false, kbuf, nullptr, false, false);
  }

  // the far-field exit's column pass from src into dst (adj: its adjoint)
  cudaError_t col_ff(const float2* src, float2* dst, bool adj) const {
    return with_logn<kMaxLogN>(logn, [&](auto L) -> cudaError_t {
      constexpr int kL = decltype(L)::value;
      using P = Plan<kL>;
      auto kernel = adj ? col_ff_kernel<kL, true> : col_ff_kernel<kL, false>;
      kernel<<<dim3(P::kN / P::kCols, pmode, B), P::kColThreads, P::kColSmem, st>>>(
          src, dst, field_bs);
      return cudaGetLastError();
    });
  }

  // dH from the per-(sample, mode) partials (natural order: Plan has no
  // permutation between passes)
  cudaError_t reduce_dh(const float2* dh_part, float2* dh, int h_shared) const {
    return dh::reduce(dh_part, dh, B, pmode, h_shared, logn, st);
  }
};

// log2 N for N a power of two in [2, 512], else 0 (which Chain::init refuses)
int logn_of(int n) {
  return n >= 2 && n <= (1 << kMaxLogN) && (n & (n - 1)) == 0 ? regfft::log2i(n) : 0;
}

Chain make_chain(int B, int pmode, int n, const float2* h, int h_shared, void* stream) {
  Chain c{};
  c.B = B;
  c.pmode = pmode;
  c.logn = logn_of(n);
  c.h = h;
  c.st = static_cast<cudaStream_t>(stream);
  c.h_bs = h_shared ? 0 : (1LL << (2 * c.logn));
  return c;
}

// The set-up of N on the current device (prepare)
cudaError_t prepare_n(int n) { return prepare(logn_of(n)); }
#endif  // !PTYRAD_MIXED_LINE

#ifdef PTYRAD_MIXED_LINE
// -- the mixed-radix build: one N in (128, 512] that is not a power of two ---

using MLine = PTYRAD_MIXED_LINE;

// The plan (ops/chain_plan.py ChainPlan; ptyrad_chain_plan reports it): a
// row-pass block holds kRows = 32 / T rows of one sample for each of up to
// kMaxGroups mode groups, a warp each, every row's line padded in shared
// memory (element a at a + (a >> kPad)); a column-pass block holds 16
// adjacent columns of T threads each (regfft::ColExchange<4>).
struct MPlan {
  using Line = MLine;
  static constexpr int kN = Line::kN, kE = Line::kE, kTl = Line::kTl;
  static constexpr int kLast = Line::kPasses - 1;  // the pass whose layout holds the spectrum
  static constexpr int kRows = 32 / kTl;
  static constexpr int kMaxGroups = 4;
  static constexpr int kLogCols = 4;
  static constexpr int kCols = 1 << kLogCols;
  static constexpr int kLine = PTYRAD_MIXED_ROW, kPad = PTYRAD_MIXED_PAD;
  static constexpr int kColThreads = kCols * kTl;
  static constexpr int kRowBlocks = (kN + kRows - 1) / kRows;
  static constexpr int kColBlocks = (kN + kCols - 1) / kCols;
  static constexpr size_t kNN = static_cast<size_t>(kN) * kN;
  static constexpr int kSlots = Line::kSlots;  // a line's slots in an exchange: N, or M
  static constexpr size_t kColSmem = sizeof(float2) * kCols * kSlots;
  static constexpr int groups(int pmode) { return pmode < kMaxGroups ? pmode : kMaxGroups; }
  static constexpr size_t row_smem(int g) {
    return sizeof(float2) * (static_cast<size_t>(kRows) * kN +
                             static_cast<size_t>(g) * kRows * kLine);
  }
  // where the far-field exit keeps frequency f: fftshift's roll by floor(N / 2)
  __device__ __forceinline__ static int shifted(int f) {
    return f + kN / 2 < kN ? f + kN / 2 : f + kN / 2 - kN;
  }
  static_assert(kTl >= 2 && kTl <= 32, "a row's line stays inside one warp");
  // every transform passes a barrier of its line between the loads of its
  // points and the stores of its results, so a pass may work in place
  static_assert(Line::kReadsSlots, "a mixed plan without an exchange");
  static_assert(kLine >= kSlots - 1 + ((kSlots - 1) >> kPad) + 1,
                "a padded row must hold the line's slots");
};

// The build's line transforms: the mixed-radix pair, or the Bluestein line
// (PTYRAD_BLUESTEIN, reg_fft.cuh) whose spectrum is in natural order
template <class Ex>
__device__ __forceinline__ void line_fwd(float2 (&v)[MPlan::kE], int t, const Ex& ex) {
#ifdef PTYRAD_BLUESTEIN
  regfft::line_dif_bl<MLine, kBf16>(v, t, ex);
#else
  regfft::line_dif_mr<MLine, kBf16>(v, t, ex);
#endif
}

template <class Ex>
__device__ __forceinline__ void line_inv(float2 (&v)[MPlan::kE], int t, const Ex& ex) {
#ifdef PTYRAD_BLUESTEIN
  regfft::line_dit_bl<MLine, kBf16>(v, t, ex);
#else
  regfft::line_dit_mr<MLine, kBf16>(v, t, ex);
#endif
}

// A row's padded line in shared memory; an idle lane (no row) stores nothing
struct MixedRowEx {
  float2* s;
  bool live;
  __device__ __forceinline__ void store(int a, float2 x) const {
    if (live) s[a + (a >> MPlan::kPad)] = x;
  }
  __device__ __forceinline__ float2 load(int a) const { return s[a + (a >> MPlan::kPad)]; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// f(m, a) for each register m of thread t that holds a point of its line in
// the points' layout (kSpec: the spectrum's, the last pass's), a its position
template <bool kSpec, class F>
__device__ __forceinline__ void each_at(int t, F&& f) {
  constexpr int k = kSpec ? MPlan::kLast : 0;
  static_for<0, MPlan::kE>([&](auto m) {
    if (MLine::template ok<k, decltype(m)::value>(t)) {
      f(m, MLine::template pos<k, decltype(m)::value>(t));
    }
  });
}

// f(m, x) over the spectrum's registers, x the far-field exit's place of
// the frequency register m holds
template <class F>
__device__ __forceinline__ void each_shifted(int t, F&& f) {
  static_for<0, MPlan::kE>([&](auto m) {
    if (MLine::template ok<MPlan::kLast, decltype(m)::value>(t)) {
      f(m, MPlan::shifted(MLine::template freq<decltype(m)::value>(t)));
    }
  });
}

template <int E>
__device__ __forceinline__ void zero(float2 (&v)[E]) {
  static_for<0, E>([&](auto m) { v[m] = make_float2(0.0f, 0.0f); });
}

// Row pass of the forward chain (grid (ceil(N / R), B), G warps): as
// row_fwd_kernel, on the mixed line. Its rows arrive in natural order, or
// (pending) as the x-spectrum at the positions the forward left it; the row
// FFT stores the x-spectrum the same way, or (kFf) frequency f at column
// shifted(f).
template <bool kFf>
__global__ void __launch_bounds__(32 * MPlan::kMaxGroups)
row_fwd_mr(const float2* src, long long src_bs, int pending, float2* entry, long long entry_bs,
           const float* __restrict__ a, const float* __restrict__ ph, long long obj_bs, int fft,
           float2* dst, long long dst_bs, int pmode) {
  using P = MPlan;
  constexpr int kE = P::kE, kN = P::kN;
  extern __shared__ float2 smem[];
  const int groups = blockDim.x >> 5;
  const int group = threadIdx.x >> 5;
  const int line = (threadIdx.x & 31) / P::kTl;
  const int t = (threadIdx.x & 31) % P::kTl;
  const int y0 = blockIdx.x * P::kRows;
  const int rows = kN - y0 < P::kRows ? kN - y0 : P::kRows;
  const bool live = line < rows;
  const size_t b = blockIdx.y;
  const size_t tile = static_cast<size_t>(y0) * kN;  // the block's pixels
  const int row = live ? line * kN : 0;               // the thread's row in the tile
  float2* tsm = smem;
  const MixedRowEx ex{smem + P::kRows * kN + (group * P::kRows + (live ? line : 0)) * P::kLine,
                      live};

  if (a != nullptr) {
    for (int e = threadIdx.x; e < rows * kN; e += blockDim.x) {
      const size_t k = b * obj_bs + tile + e;
      float sn, cs;
      sincosf(ph[k], &sn, &cs);
      tsm[e] = make_float2(a[k] * cs, a[k] * sn);
    }
    __syncthreads();
  }
  for (int p = group; p < pmode; p += groups) {
    const size_t off = p * P::kNN + tile + row;
    const float2* sp = src + b * src_bs + off;
    float2 v[kE];
    zero(v);
    if (live) {
      if (pending) {
        each_at<true>(t, [&](auto m, int x) { v[m] = sp[x]; });
      } else {
        each_at<false>(t, [&](auto m, int x) { v[m] = sp[x]; });
      }
    }
    if (pending) line_inv(v, t, ex);
    if (entry != nullptr && live) {
      float2* ep = entry + b * entry_bs + off;
      each_at<false>(t, [&](auto m, int x) { ep[x] = v[m]; });
    }
    if (a != nullptr) {
      each_at<false>(t, [&](auto m, int x) { v[m] = cmul(v[m], tsm[row + x]); });
    }
    if (fft) line_fwd(v, t, ex);
    if (dst != nullptr && live) {
      float2* dp = dst + b * dst_bs + off;
      if (!fft) {
        each_at<false>(t, [&](auto m, int x) { dp[x] = v[m]; });
      } else if (kFf) {
        each_shifted(t, [&](auto m, int x) { dp[x] = v[m]; });
      } else {
        each_at<true>(t, [&](auto m, int x) { dp[x] = v[m]; });
      }
    }
  }
}

// Row pass of the adjoint walk (grid and groups as row_fwd_mr): as
// row_bwd_kernel, on the mixed line; kFf: column x of src holds the
// frequency whose shifted place is x.
template <bool kFf>
__global__ void __launch_bounds__(32 * MPlan::kMaxGroups)
row_bwd_mr(const float2* src, long long src_bs, int pending, const float2* __restrict__ psi,
           long long psi_bs, const float* __restrict__ a, const float* __restrict__ ph,
           long long obj_bs, float* __restrict__ da, float* __restrict__ dph, long long dobj_bs,
           int fft, float2* dst, long long dst_bs, int pmode) {
  using P = MPlan;
  constexpr int kE = P::kE, kN = P::kN, kTile = P::kRows * P::kN;
  extern __shared__ float2 smem[];
  const int groups = blockDim.x >> 5;
  const int group = threadIdx.x >> 5;
  const int line = (threadIdx.x & 31) / P::kTl;
  const int t = (threadIdx.x & 31) % P::kTl;
  const int y0 = blockIdx.x * P::kRows;
  const int rows = kN - y0 < P::kRows ? kN - y0 : P::kRows;
  const bool live = line < rows;
  const size_t b = blockIdx.y;
  const size_t tile = static_cast<size_t>(y0) * kN;
  const int row = live ? line * kN : 0;
  float2* tsm = smem;
  float2* part = smem + kTile;  // after the mode loop: each group's dT share
  const MixedRowEx ex{smem + kTile + (group * P::kRows + (live ? line : 0)) * P::kLine, live};

  for (int e = threadIdx.x; e < rows * kN; e += blockDim.x) {
    const size_t k = b * obj_bs + tile + e;
    float sn, cs;
    sincosf(ph[k], &sn, &cs);
    tsm[e] = make_float2(a[k] * cs, a[k] * sn);
  }
  __syncthreads();
  float2 dt[kE];
  zero(dt);
  for (int p = group; p < pmode; p += groups) {
    const size_t off = p * P::kNN + tile + row;
    const float2* sp = src + b * src_bs + off;
    const float2* pp = psi + b * psi_bs + off;
    float2 v[kE], ps[kE];  // psi is loaded with d chi, before the transform
    zero(v);
    zero(ps);
    if (live) {
      if (!pending) {
        each_at<false>(t, [&](auto m, int x) { v[m] = sp[x]; });
      } else if (kFf) {
        each_shifted(t, [&](auto m, int x) { v[m] = sp[x]; });
      } else {
        each_at<true>(t, [&](auto m, int x) { v[m] = sp[x]; });
      }
      each_at<false>(t, [&](auto m, int x) { ps[m] = pp[x]; });
    }
    if (pending) line_inv(v, t, ex);
    each_at<false>(t, [&](auto m, int x) {
      const float2 q = cmul_conj(v[m], ps[m]);
      dt[m].x += q.x;
      dt[m].y += q.y;
      v[m] = cmul_conj(v[m], tsm[row + x]);
    });
    if (fft) line_fwd(v, t, ex);
    if (live) {
      float2* dp = dst + b * dst_bs + off;
      if (fft) {
        each_at<true>(t, [&](auto m, int x) { dp[x] = v[m]; });
      } else {
        each_at<false>(t, [&](auto m, int x) { dp[x] = v[m]; });
      }
    }
  }
  __syncthreads();  // the exchange lines become the partial sums
  if (live) each_at<false>(t, [&](auto m, int x) { part[group * kTile + row + x] = dt[m]; });
  __syncthreads();
  // d a = Re(dT e^{-i phi}), d phi = a Im(dT e^{-i phi}), dT summed over
  // the groups in order: a fixed order, no atomics
  for (int e = threadIdx.x; e < rows * kN; e += blockDim.x) {
    float2 d = part[e];
    for (int g = 1; g < groups; ++g) {
      d.x += part[g * kTile + e].x;
      d.y += part[g * kTile + e].y;
    }
    const size_t k = b * obj_bs + tile + e;
    const size_t kd = b * dobj_bs + tile + e;
    float sn, cs;
    sincosf(ph[k], &sn, &cs);
    da[kd] = d.x * cs + d.y * sn;
    dph[kd] = a[k] * (d.y * cs - d.x * sn);
  }
}

// Column pass, in place (grid (ceil(N / 16), pmode, B)): as col_kernel, on
// the mixed line. The column FFT leaves row position y holding frequency
// digitrev(y), where H (handed in permuted), K and the dH partials sit.
template <bool kDh>
__global__ void __launch_bounds__(MPlan::kColThreads)
col_mr(float2* buf, long long bs, const float2* __restrict__ h, long long h_bs, int conj_h,
       float2* kbuf, float2* dacc, int first) {
  using P = MPlan;
  constexpr int kE = P::kE, kN = P::kN;
  extern __shared__ float2 smem[];
  const int c = threadIdx.x & (P::kCols - 1);
  const int t = threadIdx.x >> P::kLogCols;
  const int x = blockIdx.x * P::kCols + c;
  const bool live = x < kN;
  const size_t col = live ? x : 0;
  const size_t fo = blockIdx.z * static_cast<size_t>(bs) + blockIdx.y * P::kNN + col;
  const ColExchange<P::kLogCols> ex{smem, c};
  float2* f = buf + fo;

  float2 v[kE];
  zero(v);
  if (live) each_at<false>(t, [&](auto m, int y) { v[m] = f[static_cast<size_t>(y) * kN]; });
  line_fwd(v, t, ex);
  if constexpr (kDh) {
    float2* kb = kbuf + fo;
    if (!conj_h) {
      if (live) each_at<true>(t, [&](auto m, int y) { kb[static_cast<size_t>(y) * kN] = v[m]; });
      if (h == nullptr) return;
    } else if (live) {
      float2* dc = dacc + fo;
      each_at<true>(t, [&](auto m, int y) {
        const size_t k = static_cast<size_t>(y) * kN;
        float2 d = cmul_conj(v[m], kb[k]);
        if (!first) d = make_float2(d.x + dc[k].x, d.y + dc[k].y);
        dc[k] = d;
      });
    }
  }
  if (live) {
    const float inv_nn = 1.0f / static_cast<float>(P::kNN);
    const float2* hb = h + blockIdx.z * static_cast<size_t>(h_bs) + col;
    each_at<true>(t, [&](auto m, int y) {
      const float2 hv = hb[static_cast<size_t>(y) * kN];
      v[m] = cmul(v[m], make_float2(hv.x * inv_nn, (conj_h ? -hv.y : hv.y) * inv_nn));
    });
  }
  line_inv(v, t, ex);
  if (live) each_at<false>(t, [&](auto m, int y) { f[static_cast<size_t>(y) * kN] = v[m]; });
}

// Column pass of the far-field exit (grid (ceil(N / 16), pmode, B)): the
// column FFT with frequency f stored at row shifted(f); kAdj, its adjoint:
// the rows loaded through the same map, the unnormalised inverse transform.
template <bool kAdj>
__global__ void __launch_bounds__(MPlan::kColThreads)
col_ff_mr(const float2* src, float2* dst, long long bs) {
  using P = MPlan;
  constexpr int kE = P::kE, kN = P::kN;
  extern __shared__ float2 smem[];
  const int c = threadIdx.x & (P::kCols - 1);
  const int t = threadIdx.x >> P::kLogCols;
  const int x = blockIdx.x * P::kCols + c;
  const bool live = x < kN;
  const size_t fo = blockIdx.z * static_cast<size_t>(bs) + blockIdx.y * P::kNN + (live ? x : 0);
  const ColExchange<P::kLogCols> ex{smem, c};

  float2 v[kE];
  zero(v);
  if (live) {
    if constexpr (kAdj) {
      each_shifted(t, [&](auto m, int y) { v[m] = src[fo + static_cast<size_t>(y) * kN]; });
    } else {
      each_at<false>(t, [&](auto m, int y) { v[m] = src[fo + static_cast<size_t>(y) * kN]; });
    }
  }
  if constexpr (kAdj) {
    line_inv(v, t, ex);
  } else {
    line_fwd(v, t, ex);
  }
  if (live) {
    if constexpr (kAdj) {
      each_at<false>(t, [&](auto m, int y) { dst[fo + static_cast<size_t>(y) * kN] = v[m]; });
    } else {
      each_shifted(t, [&](auto m, int y) { dst[fo + static_cast<size_t>(y) * kN] = v[m]; });
    }
  }
}

// Set-up once per device (regfft::prepare_once, key 1: the library holds one
// N): the line's tables (the mixed pair's twiddles; the Bluestein line's
// inner twiddles, chirp and filter) and the eight kernels' shared-memory
// limits
cudaError_t prepare_mixed() {
  return regfft::prepare_once<kMaxLogN>(1, [](int) -> cudaError_t {
    using P = MPlan;
#ifdef PTYRAD_BLUESTEIN
    REGFFT_TRY(regfft::upload_bluestein<MLine>());
#else
    REGFFT_TRY(regfft::upload_mixed(P::kN));
#endif
    const size_t row_smem = P::row_smem(P::kMaxGroups);
    REGFFT_TRY(set_smem(row_fwd_mr<false>, row_smem));
    REGFFT_TRY(set_smem(row_fwd_mr<true>, row_smem));
    REGFFT_TRY(set_smem(row_bwd_mr<false>, row_smem));
    REGFFT_TRY(set_smem(row_bwd_mr<true>, row_smem));
    REGFFT_TRY(set_smem(col_mr<false>, P::kColSmem));
    REGFFT_TRY(set_smem(col_mr<true>, P::kColSmem));
    REGFFT_TRY(set_smem(col_ff_mr<false>, P::kColSmem));
    return set_smem(col_ff_mr<true>, P::kColSmem);
  });
}

// Shapes shared by every pass of one call, as Chain, at the build's N
struct MixedChain {
  int B, pmode, n;
  long long nn, field_bs;
  const float2* h;
  long long h_bs;
  cudaStream_t st;

  cudaError_t init() {
    if (n != MPlan::kN || B < 1 || pmode < 1) return cudaErrorInvalidValue;
    nn = static_cast<long long>(MPlan::kNN);
    field_bs = pmode * nn;
    return prepare_mixed();
  }

  cudaError_t row_fwd(const float2* src, long long src_bs, bool pending, float2* entry,
                      long long entry_bs, const float* a, const float* ph, long long obj_bs,
                      bool fft, float2* dst, bool ff = false) const {
    using P = MPlan;
    auto kernel = ff ? row_fwd_mr<true> : row_fwd_mr<false>;
    const int groups = P::groups(pmode);
    kernel<<<dim3(P::kRowBlocks, B), 32 * groups, P::row_smem(groups), st>>>(
        src, src_bs, pending, entry, entry_bs, a, ph, obj_bs, fft, dst, field_bs, pmode);
    return cudaGetLastError();
  }

  cudaError_t row_bwd(const float2* src, bool pending, const float2* psi, long long psi_bs,
                      const float* a, const float* ph, long long obj_bs, float* da, float* dph,
                      long long dobj_bs, bool fft, float2* dst, bool ff = false) const {
    using P = MPlan;
    auto kernel = ff ? row_bwd_mr<true> : row_bwd_mr<false>;
    const int groups = P::groups(pmode);
    kernel<<<dim3(P::kRowBlocks, B), 32 * groups, P::row_smem(groups), st>>>(
        src, field_bs, pending, psi, psi_bs, a, ph, obj_bs, da, dph, dobj_bs, fft, dst, field_bs,
        pmode);
    return cudaGetLastError();
  }

  cudaError_t col(float2* buf, bool conj_h, float2* kbuf = nullptr, float2* dacc = nullptr,
                  bool first = false, bool with_h = true) const {
    using P = MPlan;
    auto kernel = kbuf != nullptr ? col_mr<true> : col_mr<false>;
    kernel<<<dim3(P::kColBlocks, pmode, B), P::kColThreads, P::kColSmem, st>>>(
        buf, field_bs, with_h ? h : nullptr, h_bs, conj_h, kbuf, dacc, first);
    return cudaGetLastError();
  }

  cudaError_t col_k(float2* buf, float2* kbuf) const {
    return col(buf, false, kbuf, nullptr, false, false);
  }

  cudaError_t col_ff(const float2* src, float2* dst, bool adj) const {
    using P = MPlan;
    auto kernel = adj ? col_ff_mr<true> : col_ff_mr<false>;
    kernel<<<dim3(P::kColBlocks, pmode, B), P::kColThreads, P::kColSmem, st>>>(src, dst,
                                                                               field_bs);
    return cudaGetLastError();
  }

  // dH from the partials, in the order H was handed in (the plan's
  // permutation on both axes)
  cudaError_t reduce_dh(const float2* dh_part, float2* dh, int h_shared) const {
    using Pix = regfft::FixedPix<MPlan::kN * MPlan::kN>;
    return dh::reduce_pix(dh_part, dh, B, pmode, h_shared, Pix{}, st);
  }
};

MixedChain make_chain(int B, int pmode, int n, const float2* h, int h_shared, void* stream) {
  MixedChain c{};
  c.B = B;
  c.pmode = pmode;
  c.n = n;
  c.h = h;
  c.st = static_cast<cudaStream_t>(stream);
  c.h_bs = h_shared ? 0 : static_cast<long long>(MPlan::kNN);
  return c;
}

cudaError_t prepare_n(int n) { return n == MPlan::kN ? prepare_mixed() : cudaErrorInvalidValue; }
#endif  // PTYRAD_MIXED_LINE

// Forward walk over nslices slices (a and ph point at the first; slice z at
// + z * nn), from psi_in into out. With a stack, the entry state of every
// sg-slice segment is written to stack[:, z / sg]. `last`: no propagation
// after the final slice; with `ff` (needs `last`) the far-field exit instead.
template <class C>
cudaError_t chain_fwd(const C& c, const float2* psi_in, float2* out, const float* a,
                      const float* ph, long long obj_bs, float2* stack, int n_seg, int sg,
                      int nslices, bool last, bool ff = false) {
  const float2* src = psi_in;
  bool pending = false;
  for (int z = 0; z < nslices; ++z) {
    float2* entry = (stack != nullptr && z % sg == 0) ? stack + (z / sg) * c.field_bs : nullptr;
    const bool final_slice = z == nslices - 1;
    const bool prop = !(last && final_slice);
    const bool exit_ff = ff && final_slice;
    REGFFT_TRY(c.row_fwd(src, c.field_bs, pending, entry, n_seg * c.field_bs, a + z * c.nn,
                         ph + z * c.nn, obj_bs, prop || exit_ff, out, exit_ff));
    if (prop) REGFFT_TRY(c.col(out, false));
    if (exit_ff) REGFFT_TRY(c.col_ff(out, out, false));
    src = out;
    pending = prop;
  }
  if (pending) {  // finish the trailing propagation's row IFFT
    REGFFT_TRY(c.row_fwd(out, c.field_bs, true, nullptr, 0, nullptr, nullptr, 0, false, out));
  }
  return cudaSuccess;
}

// Adjoint walk over n_seg segments of sg slices, in reverse. Segment s
// starts from stack[:, s] (stack_bs: the stack's per-sample stride); its
// slice-entry states 1..sg-1 are rebuilt into scratch (sg - 1 fields of
// (B, pmode, N, N), `work` one more) before its slices are walked. g is
// the cotangent of the chain's exit; `last`: the final slice did not
// propagate, and with `ff` g is the cotangent of its far-field exit. Writes
// d a, d phi (B, n_seg * sg, N, N) and d psi0 into dpsi, which also
// carries the running cotangent. With dh (need_dh): kscr holds sg fields
// of K, dh_part one field of partials, and dh gets the propagator
// cotangent in H's shape.
template <class C>
cudaError_t chain_bwd(const C& c, const float2* g, const float2* stack, long long stack_bs,
                      const float* a, const float* ph, long long obj_bs, float2* scratch,
                      float2* work, float2* kscr, float2* dh_part, float2* dh, float* da,
                      float* dph, float2* dpsi, int n_seg, int sg, bool last, bool ff = false) {
  const long long dobj_bs = static_cast<long long>(n_seg) * sg * c.nn;
  const long long scratch_field = c.B * c.field_bs;
  const bool with_dh = dh != nullptr;
  bool dh_first = true;
  // the adjoint propagations: a column pass of dpsi, whose K is kscr[j]
  auto adjoint_col = [&](int j) -> cudaError_t {
    const cudaError_t err =
        c.col(dpsi, true, with_dh ? kscr + j * scratch_field : nullptr, with_dh ? dh_part : nullptr,
              dh_first);
    dh_first = false;
    return err;
  };
  const float2* src = g;
  bool pending = false;   // src awaits the row IFFT of an adjoint propagation
  bool col_due = !last;   // dpsi awaits the column pass of the adjoint propagation
                          // out of the segment's final slice (its row FFT is done)
  if (!last) {  // the cotangent arrives after the final propagation
    REGFFT_TRY(c.row_fwd(g, c.field_bs, false, nullptr, 0, nullptr, nullptr, 0, true, dpsi));
    src = dpsi;
  } else if (ff) {  // the exit's adjoint: its column pass here, its row IFFT pending
    REGFFT_TRY(c.col_ff(g, dpsi, true));
    src = dpsi;
    pending = true;
  }
  bool ff_due = ff;  // the next adjoint row pass loads the exit's x order
  for (int s = n_seg - 1; s >= 0; --s) {
    const float2* entry0 = stack + s * c.field_bs;
    const float* a_s = a + static_cast<long long>(s) * sg * c.nn;
    const float* ph_s = ph + static_cast<long long>(s) * sg * c.nn;
    // rebuild: scratch[j - 1] = psi entering slice j, j = 1..sg-1; with dH,
    // kscr[j] = K of slice j, for every slice that propagates
    const float2* rsrc = entry0;
    long long rsrc_bs = stack_bs;
    for (int j = 0; j + 1 < sg; ++j) {
      REGFFT_TRY(c.row_fwd(rsrc, rsrc_bs, j > 0,
                           j > 0 ? scratch + (j - 1) * scratch_field : nullptr, c.field_bs,
                           a_s + j * c.nn, ph_s + j * c.nn, obj_bs, true, work));
      REGFFT_TRY(c.col(work, false, with_dh ? kscr + j * scratch_field : nullptr));
      rsrc = work;
      rsrc_bs = c.field_bs;
    }
    const bool k_final = with_dh && col_due;  // the final slice propagates: its K
    if (sg > 1 || k_final) {
      float2* last_entry = sg > 1 ? scratch + (sg - 2) * scratch_field : nullptr;
      REGFFT_TRY(c.row_fwd(rsrc, rsrc_bs, sg > 1, last_entry,
                           c.field_bs, k_final ? a_s + (sg - 1) * c.nn : nullptr,
                           k_final ? ph_s + (sg - 1) * c.nn : nullptr, obj_bs, k_final,
                           k_final ? work : nullptr));
      if (k_final) REGFFT_TRY(c.col_k(work, kscr + (sg - 1) * scratch_field));
    }
    if (col_due) {
      REGFFT_TRY(adjoint_col(sg - 1));
      pending = true;
    }
    for (int j = sg - 1; j >= 0; --j) {
      const bool prop_in = j > 0 || s > 0;  // a propagation delivered slice j's entry
      const float2* psi = j > 0 ? scratch + (j - 1) * scratch_field : entry0;
      const long long psi_bs = j > 0 ? c.field_bs : stack_bs;
      const long long z = static_cast<long long>(s) * sg + j;
      REGFFT_TRY(c.row_bwd(src, pending, psi, psi_bs, a_s + j * c.nn, ph_s + j * c.nn, obj_bs,
                           da + z * c.nn, dph + z * c.nn, dobj_bs, prop_in, dpsi, ff_due));
      ff_due = false;
      if (j > 0) REGFFT_TRY(adjoint_col(j - 1));
      src = dpsi;
      pending = j > 0;
    }
    col_due = s > 0;
  }
  if (!with_dh) return cudaSuccess;
  const int h_shared = c.h_bs == 0;
  if (dh_first) {  // nothing propagated
    return cudaMemsetAsync(dh, 0, sizeof(float2) * (h_shared ? 1 : c.B) * c.nn, c.st);
  }
  return c.reduce_dh(dh_part, dh, h_shared);
}

}  // namespace

extern "C" {

// Every entry point takes N itself: a power of two in [2, 512], or in a
// mixed build its own N alone (anything else: cudaErrorInvalidValue).
//
// B5a. psi (B, pmode, N, N) complex64 -> out (same); a, ph: slice 0 of the
// segment, (B, ., N, N) f32 with per-sample stride obj_bs (elements) and
// the sg slices adjacent; h (1 or B, N, N) complex64, corner-centred (in a
// mixed build gathered with the plan's permutation on both axes). With
// far_field (needs last) out is the exit's centred spectrum.
int PTYRAD_ENTRY(ptyrad_chain_segment_fwd)(
    const float2* psi, const float* a, const float* ph, long long obj_bs, const float2* h,
    float2* out, int B, int pmode, int sg, int n, int h_shared, int last, int far_field,
    void* stream) {
  auto c = make_chain(B, pmode, n, h, h_shared, stream);
  if (sg < 1 || (far_field && !last)) return static_cast<int>(cudaErrorInvalidValue);
  REGFFT_TRY(c.init());
  return static_cast<int>(chain_fwd(c, psi, out, a, ph, obj_bs, nullptr, 1, sg, sg, last != 0,
                                    far_field != 0));
}

// B5b. g: cotangent of the exit (B, pmode, N, N), of its centred spectrum
// with far_field; psi: the segment's entry.
// scratch: (sg - 1) fields, work: one field (B, pmode, N, N). Writes d a,
// d phi (B, sg, N, N) and d psi (B, pmode, N, N). With dh (H's shape) not
// null, also the propagator cotangent, through kscr (sg fields) and
// dh_part (one field).
int PTYRAD_ENTRY(ptyrad_chain_segment_bwd)(
    const float2* g, const float2* psi, const float* a, const float* ph, long long obj_bs,
    const float2* h, float2* scratch, float2* work, float2* kscr, float2* dh_part, float2* dh,
    float* da, float* dph, float2* dpsi, int B, int pmode, int sg, int n, int h_shared,
    int last, int far_field, void* stream) {
  auto c = make_chain(B, pmode, n, h, h_shared, stream);
  if (sg < 1 || (far_field && !last)) return static_cast<int>(cudaErrorInvalidValue);
  REGFFT_TRY(c.init());
  return static_cast<int>(chain_bwd(c, g, psi, c.field_bs, a, ph, obj_bs, scratch, work, kscr,
                                    dh_part, dh, da, dph, dpsi, 1, sg, last != 0,
                                    far_field != 0));
}

// B6a. n_seg segments of sg slices from psi0; writes the exit to out and the
// segment-entry stack (B, n_seg, pmode, N, N).
int PTYRAD_ENTRY(ptyrad_chain_stack_fwd)(
    const float2* psi0, const float* a, const float* ph, long long obj_bs, const float2* h,
    float2* stack, float2* out, int B, int pmode, int n_seg, int sg, int n, int h_shared,
    int last_mega, void* stream) {
  auto c = make_chain(B, pmode, n, h, h_shared, stream);
  if (sg < 1 || n_seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  REGFFT_TRY(c.init());
  return static_cast<int>(chain_fwd(c, psi0, out, a, ph, obj_bs, stack, n_seg, sg, n_seg * sg,
                                    last_mega != 0));
}

// B6b. g: cotangent of the exit; stack from B6a. scratch (sg - 1) fields,
// work one field. Writes d a, d phi (B, n_seg * sg, N, N) and d psi0; with
// dh, the propagator cotangent as B5b does.
int PTYRAD_ENTRY(ptyrad_chain_stack_bwd)(
    const float2* g, const float2* stack, const float* a, const float* ph, long long obj_bs,
    const float2* h, float2* scratch, float2* work, float2* kscr, float2* dh_part, float2* dh,
    float* da, float* dph, float2* dpsi0, int B, int pmode, int n_seg, int sg, int n,
    int h_shared, int last_mega, void* stream) {
  auto c = make_chain(B, pmode, n, h, h_shared, stream);
  if (sg < 1 || n_seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  REGFFT_TRY(c.init());
  return static_cast<int>(chain_bwd(c, g, stack, n_seg * c.field_bs, a, ph, obj_bs, scratch,
                                    work, kscr, dh_part, dh, da, dph, dpsi0, n_seg, sg,
                                    last_mega != 0));
}

// The set-up of N on the current device (prepare): a launch after it does
// none.
int PTYRAD_ENTRY(ptyrad_chain_prepare)(int n) { return static_cast<int>(prepare_n(n)); }

#if !PTYRAD_BF16_OPERANDS
#ifdef PTYRAD_MIXED_LINE
// The mixed plan for pmode probe modes, which the card-only tests hold
// against ops/chain_plan.py's ChainPlan.reported: out gets N, E, T, the
// passes, the stages, rows and columns per block, threads per row and
// column block, the two blocks' shared bytes, the padded row and its shift,
// and a line's slots (N, or a Bluestein line's M; its passes and stages are
// the M-point line's).
int ptyrad_chain_plan(int n, int pmode, int* out) {
  using P = MPlan;
#ifdef PTYRAD_BLUESTEIN
  using Passes = MLine::In;
#else
  using Passes = MLine;
#endif
  if (pmode < 1 || n != P::kN) return static_cast<int>(cudaErrorInvalidValue);
  const int g = P::groups(pmode);
  const int v[] = {P::kN, P::kE, P::kTl, Passes::kPasses, Passes::kStages, P::kRows, P::kCols,
                   32 * g, P::kColThreads, static_cast<int>(P::row_smem(g)),
                   static_cast<int>(P::kColSmem), P::kLine, P::kPad, P::kSlots};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}
#else
// The pass plan for N (a power of two) and pmode probe modes, which the
// card-only tests hold against tests/test_torch_chain_plan.py's: out gets
// N, E, TL, the number of passes, their radices (0 past the last), rows and
// columns per block, threads per row and column block, and the two blocks'
// shared bytes.
int ptyrad_chain_plan(int n, int pmode, int* out) {
  if (pmode < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_logn<kMaxLogN>(logn_of(n), [&](auto L) -> cudaError_t {
    using P = Plan<decltype(L)::value>;
    const int g = P::groups(pmode);
    const int v[] = {P::kN, P::kE, P::kTl, P::kPasses, P::kR0, P::kPasses > 1 ? P::kR1 : 0,
                     P::kPasses > 2 ? P::kR2 : 0, P::kRows, P::kCols, P::kGroup * g,
                     P::kColThreads, static_cast<int>(P::row_smem(g)),
                     static_cast<int>(P::kColSmem)};
    for (int i = 0; i < 13; ++i) out[i] = v[i];
    return cudaSuccess;
  }));
}
#endif  // PTYRAD_MIXED_LINE
#endif  // !PTYRAD_BF16_OPERANDS

}  // extern "C"
