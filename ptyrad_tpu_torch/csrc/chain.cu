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
// Bound on the card. Counting only the inputs read once and the outputs
// written once, a chain is bound by its FP32 operations: at PSO shapes
// (B=32, pmode=4, N=256) one propagation of the 128 wavefields is a 2D FFT
// and a 2D IFFT, 2 x 10 N^2 log2 N = 10.5 MFLOP each, 1.34 GFLOP in all
// (20 us at 67 TFLOP/s). But a 256^2 complex64 field is 512 KB, more than
// one block's shared memory (227 KB), so a wavefield cannot stay on chip for
// a whole slice the way B3 keeps its 128^2 field. This design moves the
// (B, pmode, N, N) field through device memory twice per slice:
//   row pass     [the previous propagation's row IFFT], the T multiply,
//                the row FFT
//   column pass  the column FFT, the H multiply, the column IFFT
// One field is 64 MiB, so a pass moves 134 MB (40 us at 3.35 TB/s): the
// kernels are bound by their own traffic, about 4x the operation bound, and
// the design keeps that traffic at two round trips per slice (the T and H
// multiplies and both 1D transforms ride on the passes that move the field
// anyway).
//
// Design:
//  * Each pass holds a few whole lines (rows or columns) in dynamic shared
//    memory and runs radix-2 N-point transforms there. The forward transform
//    is decimation in frequency (natural in, bit-reversed out) and the
//    inverse decimation in time (bit-reversed in, natural out), so no
//    bit-reversal pass exists: between a row pass and a column pass the
//    field sits in global memory with x in bit-reversed order, and the
//    column pass reads H at (bitrev(ky), bitrev(kx)). The 1/N^2 of the
//    inverse transform is folded into H.
//  * A row-pass block holds R rows of one sample for ALL its probe modes, so
//    T is computed once per pixel for every mode and the backward's
//    dT = sum_p d chi conj(psi) is summed inside the block in a fixed order:
//    d a and d phi are written once, by one thread, with no atomics, and are
//    deterministic.
//  * A column-pass block holds 16 adjacent columns of one field (16 x 8 B =
//    128 B per row: coalesced), with neighbouring threads on neighbouring
//    columns in shared memory.
//  * Launch shape: a sequence of pass kernels on the caller's stream (the
//    stream orders them; nothing synchronises). Each pass works in place on
//    its own tile, so one working buffer carries the field.
//  * dH. Every propagation's K and U exist in the column pass, after its
//    column FFT and before the H multiply, at the same (bitrev ky, bitrev
//    kx) position. The rebuild's column passes store K to a scratch of sg
//    fields (512 MiB at PSO), extended by one slice so that the propagation
//    out of the segment's final slice has its K too; the adjoint column
//    passes read it back and accumulate U conj(K) into a per-(sample, mode)
//    partial field (64 MiB); after the walk dh_reduce.cuh sums the modes,
//    and the samples for a shared H, in a fixed order. The adjoint of the
//    propagation out of a segment's final slice runs its row pass at the end
//    of the later segment's walk, as before, and its column pass after this
//    segment's rebuild, where K exists (the order of pallas_chain.py:589-604):
//    no pass is added, so the path without dH runs the same passes as ever.
//    The dH work lives in col_kernel<true> only; without dH every column
//    pass is col_kernel<false>, which has none of it.
//  * The far-field exit. The TPU kernel multiplies by dense shift-folded DFT
//    matrices because it has no FFT; here the exit rides on the passes: the
//    final slice's row pass runs its row FFT after the T multiply and stores
//    each line in natural, shifted kx order (a permutation on the way out of
//    shared memory: the global stores stay whole 128-byte lines), and one
//    more column pass (col_ff_kernel: column FFT only, no H, no inverse)
//    stores its rows at (ky + N/2) % N. A column tile holds whole columns, so
//    that pass permutes rows inside its own tile and works in place. The
//    adjoint is one column pass on the cotangent (load through the same row
//    map, unnormalised inverse column transform) and the same x permutation
//    on the load of the first adjoint row pass, whose row IFFT is then
//    pending. No 1/N^2 anywhere: the inverse transforms are unnormalised and
//    the 1/N^2 of a propagation rides on H. The permuting store and load are
//    template flags (kFf) of the row kernels, so every pass without the exit
//    is the instantiation it was.
//  * FP32 throughout, accurate sincosf, twiddles from double sincospi.

#include <cuda_runtime.h>

#include "dh_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogN = 9;      // N <= 512
constexpr int kColTile = 16;     // columns per column-pass block
constexpr int kRowElems = 4096;  // target elements (rows x modes x N) per row-pass block

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ int bitrev(int i, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - logn));
}

// The far-field exit's order along a line of n = 2^logn points: position
// i = line * n + x of the natural, shifted order (x holds frequency
// (x + n/2) % n = x ^ n/2) maps to where the bit-reversed output of the
// forward transform holds that frequency, bitrev(x ^ n/2) = bitrev(x) ^ 1.
__device__ __forceinline__ int ff_index(int i, int logn) {
  const int n = 1 << logn;
  return (i & ~(n - 1)) | (bitrev(i & (n - 1), logn) ^ 1);
}

// tw[k] = exp(-2 pi i k / n), k < n/2; returns synchronised
__device__ void init_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
    double sn, cs;
    sincospi(-2.0 * k / n, &sn, &cs);
    tw[k] = make_float2(static_cast<float>(cs), static_cast<float>(sn));
  }
  __syncthreads();
}

// One radix-2 stage over nlines lines of n = 2^logn points held in shared
// memory, element (line l, position i) at s[l * ls + i * ps]. kInv:
// decimation in time with conjugate twiddles; else decimation in frequency.
// kLineFastest maps neighbouring threads to neighbouring lines (for the
// column tile, whose lines are adjacent in memory).
template <bool kInv, bool kLineFastest>
__device__ __forceinline__ void fft_stage(float2* s, const float2* tw, int nlines, int logn,
                                          int ls, int ps, int lh) {
  const int half = 1 << lh;
  const int tshift = logn - 1 - lh;  // twiddle stride n / (2 half)
  const int per_line = 1 << (logn - 1);
  const int total = nlines * per_line;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    int line, b;
    if (kLineFastest) {
      line = t % nlines;
      b = t / nlines;
    } else {
      line = t >> (logn - 1);
      b = t & (per_line - 1);
    }
    const int j = b & (half - 1);
    const int i0 = ((b >> lh) << (lh + 1)) + j;
    const int a0 = line * ls + i0 * ps;
    const int a1 = a0 + half * ps;
    float2 w = tw[j << tshift];
    const float2 u = s[a0];
    const float2 v = s[a1];
    if (kInv) {
      w.y = -w.y;
      const float2 t1 = cmul(v, w);
      s[a0] = make_float2(u.x + t1.x, u.y + t1.y);
      s[a1] = make_float2(u.x - t1.x, u.y - t1.y);
    } else {
      s[a0] = make_float2(u.x + v.x, u.y + v.y);
      s[a1] = cmul(make_float2(u.x - v.x, u.y - v.y), w);
    }
  }
}

// Unnormalized forward transform of every line: natural in, bit-reversed
// out. Callers synchronise before; returns synchronised.
template <bool kLineFastest>
__device__ void fft_lines(float2* s, const float2* tw, int nlines, int logn, int ls, int ps) {
  for (int lh = logn - 1; lh >= 0; --lh) {
    fft_stage<false, kLineFastest>(s, tw, nlines, logn, ls, ps, lh);
    __syncthreads();
  }
}

// Unnormalized inverse transform of every line: bit-reversed in, natural out.
template <bool kLineFastest>
__device__ void ifft_lines(float2* s, const float2* tw, int nlines, int logn, int ls, int ps) {
  for (int lh = 0; lh < logn; ++lh) {
    fft_stage<true, kLineFastest>(s, tw, nlines, logn, ls, ps, lh);
    __syncthreads();
  }
}

// Field addressing: sample b's mode p starts at base + b * bs + p * nn.
struct Rows {
  int b, y0, rows, pmode, logn;
  __device__ size_t at(size_t bs, int e) const {  // e = (p * rows + r) * n + x
    const int n = 1 << logn;
    const int l = e >> logn;
    const int p = l / rows;
    const int r = l - p * rows;
    return static_cast<size_t>(b) * bs + (static_cast<size_t>(p) << (2 * logn)) +
           static_cast<size_t>(y0 + r) * n + (e & (n - 1));
  }
};

// Row pass of the forward chain, for rows y0..y0+R-1 of sample b, all modes
// (grid (N / R, B)). Loads src (bit-reversed along x when `pending`: the
// previous propagation's row IFFT is still to do), finishes that IFFT,
// stores the natural state to `entry` if given, multiplies by T if a is
// given, runs the row FFT if `fft`, and writes dst if given. kFf (the
// far-field exit; needs `fft`): the transformed lines are stored in natural,
// shifted order, column x holding kx = (x + N/2) % N.
template <bool kFf>
__global__ void __launch_bounds__(kThreads)
row_fwd_kernel(const float2* src, long long src_bs, int pending, float2* entry,
               long long entry_bs, const float* __restrict__ a, const float* __restrict__ ph,
               long long obj_bs, int fft, float2* dst, long long dst_bs, int pmode, int logn,
               int rows) {
  extern __shared__ float2 smem[];
  const int n = 1 << logn;
  float2* tw = smem;
  float2* s = smem + n / 2;
  const Rows g{static_cast<int>(blockIdx.y), static_cast<int>(blockIdx.x) * rows, rows, pmode,
               logn};
  const int nlines = pmode * rows;
  const int ne = nlines << logn;

  init_twiddles(tw, n);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) s[e] = src[g.at(src_bs, e)];
  __syncthreads();
  if (pending) ifft_lines<false>(s, tw, nlines, logn, n, 1);
  if (entry != nullptr) {
    for (int e = threadIdx.x; e < ne; e += blockDim.x) entry[g.at(entry_bs, e)] = s[e];
  }
  if (a != nullptr) {
    const int npix = rows << logn;
    for (int e = threadIdx.x; e < npix; e += blockDim.x) {
      const size_t k = static_cast<size_t>(g.b) * obj_bs +
                       (static_cast<size_t>(g.y0) << logn) + e;
      float sn, cs;
      sincosf(ph[k], &sn, &cs);
      const float am = a[k];
      const float2 t = make_float2(am * cs, am * sn);
      for (int p = 0; p < pmode; ++p) {
        const int i = p * npix + e;
        s[i] = cmul(s[i], t);
      }
    }
    __syncthreads();
  }
  if (fft) fft_lines<false>(s, tw, nlines, logn, n, 1);
  if (dst != nullptr) {
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      dst[g.at(dst_bs, e)] = s[kFf ? ff_index(e, logn) : e];
    }
  }
}

// Row pass of the adjoint walk for slice z (grid (N / R, B)). Loads the
// cotangent d chi (pending: bit-reversed along x, its row IFFT still to
// do), forms dT = sum_p d chi conj(psi) against the slice-entry state psi,
// writes d a and d phi for these pixels, multiplies by conj(T), runs the
// row FFT if `fft` (the adjoint propagation to the previous slice
// follows), and writes dst. kFf (the adjoint of the far-field exit; needs
// `pending`): src holds its lines in the exit's natural, shifted order.
template <bool kFf>
__global__ void __launch_bounds__(kThreads)
row_bwd_kernel(const float2* src, long long src_bs, int pending, const float2* __restrict__ psi,
               long long psi_bs, const float* __restrict__ a, const float* __restrict__ ph,
               long long obj_bs, float* __restrict__ da, float* __restrict__ dph,
               long long dobj_bs, int fft, float2* dst, long long dst_bs, int pmode, int logn,
               int rows) {
  extern __shared__ float2 smem[];
  const int n = 1 << logn;
  float2* tw = smem;
  float2* s = smem + n / 2;
  const Rows g{static_cast<int>(blockIdx.y), static_cast<int>(blockIdx.x) * rows, rows, pmode,
               logn};
  const int nlines = pmode * rows;
  const int ne = nlines << logn;

  init_twiddles(tw, n);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    s[kFf ? ff_index(e, logn) : e] = src[g.at(src_bs, e)];
  }
  __syncthreads();
  if (pending) ifft_lines<false>(s, tw, nlines, logn, n, 1);

  const int npix = rows << logn;
  const size_t mode_nn = static_cast<size_t>(1) << (2 * logn);
  for (int e = threadIdx.x; e < npix; e += blockDim.x) {
    const size_t pix = (static_cast<size_t>(g.y0) << logn) + e;
    const size_t k = static_cast<size_t>(g.b) * obj_bs + pix;
    float sn, cs;
    sincosf(ph[k], &sn, &cs);
    const float am = a[k];
    const float2 t = make_float2(am * cs, am * sn);
    const float2* psi_b = psi + static_cast<size_t>(g.b) * psi_bs + pix;
    float2 dt = make_float2(0.0f, 0.0f);
    for (int p = 0; p < pmode; ++p) {
      const int i = p * npix + e;
      const float2 dchi = s[i];
      const float2 q = cmul_conj(dchi, psi_b[p * mode_nn]);
      dt.x += q.x;
      dt.y += q.y;
      s[i] = cmul_conj(dchi, t);
    }
    const size_t kd = static_cast<size_t>(g.b) * dobj_bs + pix;
    da[kd] = dt.x * cs + dt.y * sn;
    dph[kd] = am * (dt.y * cs - dt.x * sn);
  }
  __syncthreads();
  if (fft) fft_lines<false>(s, tw, nlines, logn, n, 1);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) dst[g.at(dst_bs, e)] = s[e];
}

// Column pass, in place (grid (N / C, pmode, B)): columns c0..c0+C-1 of
// field (b, p), which arrive with x bit-reversed. Column FFT, times H/N^2
// (conj(H)/N^2 for the adjoint) read at (bitrev(ky), bitrev(kx)), column
// IFFT. kDh (need_dh), after the column FFT: forward, K is stored to kbuf
// (and with h null the pass ends there); adjoint, dacc = U conj(K) (+=
// unless first) against K read from kbuf. kbuf and dacc are fields laid out
// as buf; without kDh they are ignored.
template <bool kDh>
__global__ void __launch_bounds__(kThreads)
col_kernel(float2* buf, long long bs, const float2* __restrict__ h, long long h_bs, int conj_h,
           float2* kbuf, float2* dacc, int first, int logn, int log_c) {
  extern __shared__ float2 smem[];
  const int n = 1 << logn;
  const int c = 1 << log_c;
  float2* tw = smem;
  float2* s = smem + n / 2;  // s[r * c + col]
  const int c0 = blockIdx.x * c;
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int ne = n << log_c;
  float2* f = buf + static_cast<size_t>(b) * bs + (static_cast<size_t>(p) << (2 * logn)) + c0;

  init_twiddles(tw, n);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    s[e] = f[static_cast<size_t>(e >> log_c) * n + (e & (c - 1))];
  }
  __syncthreads();
  fft_lines<true>(s, tw, c, logn, 1, c);
  if constexpr (kDh) {
    const size_t fo = static_cast<size_t>(b) * bs + (static_cast<size_t>(p) << (2 * logn)) + c0;
    if (!conj_h) {
      for (int e = threadIdx.x; e < ne; e += blockDim.x) {
        kbuf[fo + static_cast<size_t>(e >> log_c) * n + (e & (c - 1))] = s[e];
      }
      if (h == nullptr) return;
    } else {
      for (int e = threadIdx.x; e < ne; e += blockDim.x) {
        const size_t k = fo + static_cast<size_t>(e >> log_c) * n + (e & (c - 1));
        float2 d = cmul_conj(s[e], kbuf[k]);
        if (!first) d = make_float2(d.x + dacc[k].x, d.y + dacc[k].y);
        dacc[k] = d;
      }
    }
  }
  const float inv_nn = 1.0f / static_cast<float>(n * n);
  const float2* hb = h + static_cast<size_t>(b) * h_bs;
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int ky = bitrev(e >> log_c, logn);
    const int kx = bitrev(c0 + (e & (c - 1)), logn);
    float2 hv = hb[static_cast<size_t>(ky) * n + kx];
    hv = make_float2(hv.x * inv_nn, (conj_h ? -hv.y : hv.y) * inv_nn);
    s[e] = cmul(s[e], hv);
  }
  __syncthreads();
  ifft_lines<true>(s, tw, c, logn, 1, c);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    f[static_cast<size_t>(e >> log_c) * n + (e & (c - 1))] = s[e];
  }
}

// Column pass of the far-field exit (grid (N / C, pmode, B)), on columns
// c0..c0+C-1 of field (b, p) of src, into the same columns of dst (which may
// be src: the block holds its whole columns before it stores any). Forward:
// the column FFT, row ky of the result stored at (ky + N/2) % N. kAdj, its
// adjoint: the rows loaded through the same map, then the unnormalised
// inverse column transform.
template <bool kAdj>
__global__ void __launch_bounds__(kThreads)
col_ff_kernel(const float2* src, float2* dst, long long bs, int logn, int log_c) {
  extern __shared__ float2 smem[];
  const int n = 1 << logn;
  const int c = 1 << log_c;
  float2* tw = smem;
  float2* s = smem + n / 2;  // s[r * c + col]
  const int ne = n << log_c;
  const size_t fo = static_cast<size_t>(blockIdx.z) * bs +
                    (static_cast<size_t>(blockIdx.y) << (2 * logn)) + blockIdx.x * c;

  init_twiddles(tw, n);
  // memory row y of the exit <-> transform position bitrev(y) ^ 1 (ff_index)
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int y = e >> log_c, col = e & (c - 1);
    const int r = kAdj ? ff_index(y, logn) : y;
    s[(r << log_c) + col] = src[fo + static_cast<size_t>(y) * n + col];
  }
  __syncthreads();
  if (kAdj) {
    ifft_lines<true>(s, tw, c, logn, 1, c);
  } else {
    fft_lines<true>(s, tw, c, logn, 1, c);
  }
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int y = e >> log_c, col = e & (c - 1);
    const int r = kAdj ? y : ff_index(y, logn);
    dst[fo + static_cast<size_t>(y) * n + col] = s[(r << log_c) + col];
  }
}

#define CHAIN_TRY(expr)                         \
  do {                                          \
    const cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

// Shapes shared by every pass of one call.
struct Chain {
  int B, pmode, logn;
  long long nn, field_bs;  // N^2; a (B, pmode, N, N) field's per-sample stride
  const float2* h;
  long long h_bs;
  cudaStream_t st;
  int rows, log_c;
  size_t row_smem, col_smem;

  // ff: the call takes the far-field exit, so its kernels are set up too
  cudaError_t init(bool ff = false) {
    if (logn < 1 || logn > kMaxLogN || B < 1 || pmode < 1) return cudaErrorInvalidValue;
    const int n = 1 << logn;
    nn = static_cast<long long>(n) * n;
    field_bs = pmode * nn;
    rows = 1;
    while (rows < n && 2 * rows * pmode * n <= kRowElems) rows *= 2;
    log_c = 0;
    while ((1 << log_c) < kColTile && (1 << log_c) < n) ++log_c;
    row_smem = (static_cast<size_t>(rows) * pmode * n + n / 2) * sizeof(float2);
    col_smem = ((static_cast<size_t>(n) << log_c) + n / 2) * sizeof(float2);
    CHAIN_TRY(set_smem(row_fwd_kernel<false>, row_smem));
    CHAIN_TRY(set_smem(row_bwd_kernel<false>, row_smem));
    CHAIN_TRY(set_smem(col_kernel<false>, col_smem));
    CHAIN_TRY(set_smem(col_kernel<true>, col_smem));
    if (ff) {
      CHAIN_TRY(set_smem(row_fwd_kernel<true>, row_smem));
      CHAIN_TRY(set_smem(row_bwd_kernel<true>, row_smem));
      CHAIN_TRY(set_smem(col_ff_kernel<false>, col_smem));
      CHAIN_TRY(set_smem(col_ff_kernel<true>, col_smem));
    }
    return cudaSuccess;
  }

  template <typename Kernel>
  static cudaError_t set_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  }

  dim3 row_grid() const { return dim3((1 << logn) / rows, B); }

  cudaError_t row_fwd(const float2* src, long long src_bs, bool pending, float2* entry,
                      long long entry_bs, const float* a, const float* ph, long long obj_bs,
                      bool fft, float2* dst, bool ff = false) const {
    auto kernel = ff ? row_fwd_kernel<true> : row_fwd_kernel<false>;
    kernel<<<row_grid(), kThreads, row_smem, st>>>(
        src, src_bs, pending, entry, entry_bs, a, ph, obj_bs, fft, dst, field_bs, pmode, logn,
        rows);
    return cudaGetLastError();
  }

  cudaError_t row_bwd(const float2* src, bool pending, const float2* psi, long long psi_bs,
                      const float* a, const float* ph, long long obj_bs, float* da, float* dph,
                      long long dobj_bs, bool fft, float2* dst, bool ff = false) const {
    auto kernel = ff ? row_bwd_kernel<true> : row_bwd_kernel<false>;
    kernel<<<row_grid(), kThreads, row_smem, st>>>(
        src, field_bs, pending, psi, psi_bs, a, ph, obj_bs, da, dph, dobj_bs, fft, dst,
        field_bs, pmode, logn, rows);
    return cudaGetLastError();
  }

  // a propagation (conj_h: its adjoint); with kbuf, the dH variant of
  // col_kernel (kbuf, dacc, first as there), else the plain one
  cudaError_t col(float2* buf, bool conj_h, float2* kbuf = nullptr, float2* dacc = nullptr,
                  bool first = false) const {
    const dim3 grid((1 << logn) >> log_c, pmode, B);
    auto kernel = kbuf != nullptr ? col_kernel<true> : col_kernel<false>;
    kernel<<<grid, kThreads, col_smem, st>>>(buf, field_bs, h, h_bs, conj_h, kbuf, dacc, first,
                                             logn, log_c);
    return cudaGetLastError();
  }

  // the column FFT of buf only, stored to kbuf (the K of a final slice)
  cudaError_t col_k(float2* buf, float2* kbuf) const {
    const dim3 grid((1 << logn) >> log_c, pmode, B);
    col_kernel<true><<<grid, kThreads, col_smem, st>>>(buf, field_bs, nullptr, 0, 0, kbuf,
                                                       nullptr, 0, logn, log_c);
    return cudaGetLastError();
  }

  // the far-field exit's column pass from src into dst (adj: its adjoint)
  cudaError_t col_ff(const float2* src, float2* dst, bool adj) const {
    const dim3 grid((1 << logn) >> log_c, pmode, B);
    auto kernel = adj ? col_ff_kernel<true> : col_ff_kernel<false>;
    kernel<<<grid, kThreads, col_smem, st>>>(src, dst, field_bs, logn, log_c);
    return cudaGetLastError();
  }
};

// Forward walk over nslices slices (a and ph point at the first; slice z at
// + z * nn), from psi_in into out. With a stack, the entry state of every
// sg-slice segment is written to stack[:, z / sg]. `last`: no propagation
// after the final slice; with `ff` (needs `last`) the far-field exit instead.
cudaError_t chain_fwd(const Chain& c, const float2* psi_in, float2* out, const float* a,
                      const float* ph, long long obj_bs, float2* stack, int n_seg, int sg,
                      int nslices, bool last, bool ff = false) {
  const float2* src = psi_in;
  bool pending = false;
  for (int z = 0; z < nslices; ++z) {
    float2* entry = (stack != nullptr && z % sg == 0) ? stack + (z / sg) * c.field_bs : nullptr;
    const bool final_slice = z == nslices - 1;
    const bool prop = !(last && final_slice);
    const bool exit_ff = ff && final_slice;
    CHAIN_TRY(c.row_fwd(src, c.field_bs, pending, entry, n_seg * c.field_bs, a + z * c.nn,
                        ph + z * c.nn, obj_bs, prop || exit_ff, out, exit_ff));
    if (prop) CHAIN_TRY(c.col(out, false));
    if (exit_ff) CHAIN_TRY(c.col_ff(out, out, false));
    src = out;
    pending = prop;
  }
  if (pending) {  // finish the trailing propagation's row IFFT
    CHAIN_TRY(c.row_fwd(out, c.field_bs, true, nullptr, 0, nullptr, nullptr, 0, false, out));
  }
  return cudaSuccess;
}

// Adjoint walk over n_seg segments of sg slices, in reverse. Segment s
// starts from stack[:, s] (stack_bs: the stack's per-sample stride); its
// slice-entry states 1..sg-1 are rebuilt into scratch (sg - 1 fields of
// (B, pmode, N, N), `work` one more) before its slices are walked. g is
// the cotangent of the chain's exit; `last`: the final slice did not
// propagate, and with `ff` g is the cotangent of its far-field exit. Writes d a, d phi (B, n_seg * sg, N, N) and d psi0 into dpsi,
// which also carries the running cotangent. With dh (need_dh): kscr holds
// sg fields of K, dh_part one field of partials, and dh gets the
// propagator cotangent in H's shape.
cudaError_t chain_bwd(const Chain& c, const float2* g, const float2* stack, long long stack_bs,
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
    CHAIN_TRY(c.row_fwd(g, c.field_bs, false, nullptr, 0, nullptr, nullptr, 0, true, dpsi));
    src = dpsi;
  } else if (ff) {  // the exit's adjoint: its column pass here, its row IFFT pending
    CHAIN_TRY(c.col_ff(g, dpsi, true));
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
      CHAIN_TRY(c.row_fwd(rsrc, rsrc_bs, j > 0, j > 0 ? scratch + (j - 1) * scratch_field : nullptr,
                          c.field_bs, a_s + j * c.nn, ph_s + j * c.nn, obj_bs, true, work));
      CHAIN_TRY(c.col(work, false, with_dh ? kscr + j * scratch_field : nullptr));
      rsrc = work;
      rsrc_bs = c.field_bs;
    }
    const bool k_final = with_dh && col_due;  // the final slice propagates: its K
    if (sg > 1 || k_final) {
      float2* last_entry = sg > 1 ? scratch + (sg - 2) * scratch_field : nullptr;
      CHAIN_TRY(c.row_fwd(rsrc, rsrc_bs, sg > 1, last_entry,
                          c.field_bs, k_final ? a_s + (sg - 1) * c.nn : nullptr,
                          k_final ? ph_s + (sg - 1) * c.nn : nullptr, obj_bs, k_final,
                          k_final ? work : nullptr));
      if (k_final) CHAIN_TRY(c.col_k(work, kscr + (sg - 1) * scratch_field));
    }
    if (col_due) {
      CHAIN_TRY(adjoint_col(sg - 1));
      pending = true;
    }
    for (int j = sg - 1; j >= 0; --j) {
      const bool prop_in = j > 0 || s > 0;  // a propagation delivered slice j's entry
      const float2* psi = j > 0 ? scratch + (j - 1) * scratch_field : entry0;
      const long long psi_bs = j > 0 ? c.field_bs : stack_bs;
      const long long z = static_cast<long long>(s) * sg + j;
      CHAIN_TRY(c.row_bwd(src, pending, psi, psi_bs, a_s + j * c.nn, ph_s + j * c.nn, obj_bs,
                          da + z * c.nn, dph + z * c.nn, dobj_bs, prop_in, dpsi, ff_due));
      ff_due = false;
      if (j > 0) CHAIN_TRY(adjoint_col(j - 1));
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
  return dh::reduce(dh_part, dh, c.B, c.pmode, h_shared, c.logn, c.st);
}

Chain make_chain(int B, int pmode, int logn, const float2* h, int h_shared, void* stream) {
  Chain c{};
  c.B = B;
  c.pmode = pmode;
  c.logn = logn;
  c.h = h;
  c.st = static_cast<cudaStream_t>(stream);
  c.h_bs = h_shared ? 0 : (1LL << (2 * logn));
  return c;
}

}  // namespace

extern "C" {

// B5a. psi (B, pmode, N, N) complex64 -> out (same); a, ph: slice 0 of the
// segment, (B, ., N, N) f32 with per-sample stride obj_bs (elements) and
// the sg slices adjacent; h (1 or B, N, N) complex64, corner-centred. With
// far_field (needs last) out is the exit's centred spectrum.
int ptyrad_chain_segment_fwd(const float2* psi, const float* a, const float* ph,
                             long long obj_bs, const float2* h, float2* out, int B, int pmode,
                             int sg, int logn, int h_shared, int last, int far_field,
                             void* stream) {
  Chain c = make_chain(B, pmode, logn, h, h_shared, stream);
  if (sg < 1 || (far_field && !last)) return static_cast<int>(cudaErrorInvalidValue);
  CHAIN_TRY(c.init(far_field != 0));
  return static_cast<int>(chain_fwd(c, psi, out, a, ph, obj_bs, nullptr, 1, sg, sg, last != 0,
                                    far_field != 0));
}

// B5b. g: cotangent of the exit (B, pmode, N, N), of its centred spectrum
// with far_field; psi: the segment's entry.
// scratch: (sg - 1) fields, work: one field (B, pmode, N, N). Writes d a,
// d phi (B, sg, N, N) and d psi (B, pmode, N, N). With dh (H's shape) not
// null, also the propagator cotangent, through kscr (sg fields) and
// dh_part (one field).
int ptyrad_chain_segment_bwd(const float2* g, const float2* psi, const float* a, const float* ph,
                             long long obj_bs, const float2* h, float2* scratch, float2* work,
                             float2* kscr, float2* dh_part, float2* dh, float* da, float* dph,
                             float2* dpsi, int B, int pmode, int sg, int logn, int h_shared,
                             int last, int far_field, void* stream) {
  Chain c = make_chain(B, pmode, logn, h, h_shared, stream);
  if (sg < 1 || (far_field && !last)) return static_cast<int>(cudaErrorInvalidValue);
  CHAIN_TRY(c.init(far_field != 0));
  return static_cast<int>(chain_bwd(c, g, psi, c.field_bs, a, ph, obj_bs, scratch, work, kscr,
                                    dh_part, dh, da, dph, dpsi, 1, sg, last != 0,
                                    far_field != 0));
}

// B6a. n_seg segments of sg slices from psi0; writes the exit to out and the
// segment-entry stack (B, n_seg, pmode, N, N).
int ptyrad_chain_stack_fwd(const float2* psi0, const float* a, const float* ph,
                           long long obj_bs, const float2* h, float2* stack, float2* out, int B,
                           int pmode, int n_seg, int sg, int logn, int h_shared, int last_mega,
                           void* stream) {
  Chain c = make_chain(B, pmode, logn, h, h_shared, stream);
  if (sg < 1 || n_seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  CHAIN_TRY(c.init());
  return static_cast<int>(chain_fwd(c, psi0, out, a, ph, obj_bs, stack, n_seg, sg, n_seg * sg,
                                    last_mega != 0));
}

// B6b. g: cotangent of the exit; stack from B6a. scratch (sg - 1) fields,
// work one field. Writes d a, d phi (B, n_seg * sg, N, N) and d psi0; with
// dh, the propagator cotangent as B5b does.
int ptyrad_chain_stack_bwd(const float2* g, const float2* stack, const float* a, const float* ph,
                           long long obj_bs, const float2* h, float2* scratch, float2* work,
                           float2* kscr, float2* dh_part, float2* dh, float* da, float* dph,
                           float2* dpsi0, int B, int pmode, int n_seg, int sg, int logn,
                           int h_shared, int last_mega, void* stream) {
  Chain c = make_chain(B, pmode, logn, h, h_shared, stream);
  if (sg < 1 || n_seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  CHAIN_TRY(c.init());
  return static_cast<int>(chain_bwd(c, g, stack, n_seg * c.field_bs, a, ph, obj_bs, scratch,
                                    work, kscr, dh_part, dh, da, dph, dpsi0, n_seg, sg,
                                    last_mega != 0));
}

}  // extern "C"
