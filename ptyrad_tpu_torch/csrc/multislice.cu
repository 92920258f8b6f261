// Mixed-state multislice chain for sm_90a at N <= 128, forward and backward:
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
//    dT sums over modes: each block adds its d(a, phi) contribution (linear
//    in dT) into zeroed outputs with atomicAdd, and a shared probe's
//    gradient is summed over samples the same way; the order of those adds
//    varies from run to run.
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
//  * FP32 throughout, accurate sincosf, twiddles from double precision.

#include <cuda_runtime.h>

#include "dh_reduce.cuh"
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
// A chain block's threads at N = 128 (one block an SM either way). The
// forward's 1,024 threads fit 64 registers with a 60-byte spill and beat
// 512; the backward needs 128 registers, and at 1,024 threads (64 each) a
// backward spilled 500-700 bytes and ran no faster (PERF.md §6).
constexpr int kFwdThreads = 1024;
constexpr int kBwdThreads = 512;
constexpr int kSumThreads = 256;

template <int LOGN, int kMaxThreads>
struct FPlan {
  using Line = regfft::LinePlan<LOGN>;
  static constexpr int kLogN = LOGN;
  static constexpr int kN = Line::kN, kE = Line::kE, kLogTl = Line::kLogTl, kTl = Line::kTl;
  static constexpr int kNN = kN * kN;
  static constexpr int kLine = kN + (kN >= 16 ? kN / 16 : 1);  // a padded row
  static constexpr int kSlots = kN * kTl;  // a phase's threads: TL for each of N lines
  static constexpr int kThreads = kSlots < kMaxThreads ? kSlots : kMaxThreads;
  static constexpr int kSweeps = kSlots / kThreads;  // lines a thread takes in a phase
  static constexpr int kLinesPerSweep = kThreads >> kLogTl;
  static constexpr int kGroupThreads = 32 * kTl;  // a column phase's 32 adjacent columns
  static constexpr size_t kSmem = sizeof(float2) * kN * kLine;
};

// the two chain kernels' block sizes at N (no comma for __launch_bounds__)
template <int LOGN>
constexpr int kFwdBlock = FPlan<LOGN, kFwdThreads>::kThreads;
template <int LOGN>
constexpr int kBwdBlock = FPlan<LOGN, kBwdThreads>::kThreads;

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
  float2* s;
  int bar;
  __device__ __forceinline__ void store(int a, float2 x) const { s[a * P::kLine] = x; }
  __device__ __forceinline__ float2 load(int a) const { return s[a * P::kLine]; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" : : "r"(bar), "r"(P::kGroupThreads) : "memory");
  }
};

// f(y, t, line) for every row y of the field: thread t of the row's TL
template <class P, class F>
__device__ __forceinline__ void for_rows(float2* s, F&& f) {
  const int t = threadIdx.x & (P::kTl - 1);
  for (int sw = 0; sw < P::kSweeps; ++sw) {
    const int y = sw * P::kLinesPerSweep + (threadIdx.x >> P::kLogTl);
    f(y, t, FieldRow{s + y * P::kLine});
  }
}

// f(x, t, line) for every column x of the field: warp w holds 32 adjacent
// columns with one t, and a column's TL warps are adjacent
template <class P, class F>
__device__ __forceinline__ void for_cols(float2* s, F&& f) {
  const int w = threadIdx.x >> 5;
  const int group = w >> P::kLogTl;
  const int t = w & (P::kTl - 1);
  for (int sw = 0; sw < P::kSweeps; ++sw) {
    const int x = sw * P::kLinesPerSweep + group * 32 + (threadIdx.x & 31);
    f(x, t, FieldCol<P>{s + x + (x >> 4), 1 + group});
  }
}

// The thread's points t + TL m of a line, from and to the field
template <class P, class Ex>
__device__ __forceinline__ void load_line(float2 (&v)[P::kE], int t, const Ex& ex) {
  static_for<0, P::kE>([&](auto m) { v[m] = ex.load(t + m * P::kTl); });
}

template <class P, class Ex>
__device__ __forceinline__ void store_line(const float2 (&v)[P::kE], int t, const Ex& ex) {
  static_for<0, P::kE>([&](auto m) { ex.store(t + m * P::kTl, v[m]); });
}

// The thread's frequencies dif_freq(t, i) of a line, from and to the field;
// the store waits first for the exchange loads of line_dif
template <class P, class Ex>
__device__ __forceinline__ void load_freq(float2 (&v)[P::kE], int t, const Ex& ex) {
  static_for<0, P::kE>([&](auto i) { v[i] = ex.load(regfft::dif_freq<P::kLogN>(t, i)); });
}

template <class P, class Ex>
__device__ __forceinline__ void store_freq(const float2 (&v)[P::kE], int t, const Ex& ex) {
  if constexpr (P::kTl > 1) ex.sync();
  static_for<0, P::kE>([&](auto i) { ex.store(regfft::dif_freq<P::kLogN>(t, i), v[i]); });
}

// d probe: stored, or summed over the samples for a shared probe
__device__ __forceinline__ void put_probe(float2* out, float2 v, int shared_probe) {
  if (shared_probe) {
    atomicAdd(&out->x, v.x);
    atomicAdd(&out->y, v.y);
  } else {
    *out = v;
  }
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
  constexpr int kN = P::kN, kE = P::kE, kTl = P::kTl, kNN = P::kNN, kLogN = P::kLogN;
  constexpr float kInvNN = 1.0f / kNN;
  if (kspace) {  // the spectrum's inverse column transforms, straight from device memory
    for_cols<P>(s, [&](int x, int t, const auto& ex) {
      float2 v[kE];
      static_for<0, kE>([&](auto i) { v[i] = pr[regfft::dif_freq<kLogN>(t, i) * kN + x]; });
      line_dit<kLogN>(v, t, ex);
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
      const int row = y * kN + t;
      if (z == 0 && !kspace) {
        static_for<0, kE>([&](auto m) { v[m] = pr[row + m * kTl]; });
      } else {
        load_freq<P>(v, t, ex);
        line_dit<kLogN>(v, t, ex);
        if (z == 0) static_for<0, kE>([&](auto m) { v[m] = cscale(v[m], kInvNN); });
      }
      if (st != nullptr) {
        static_for<0, kE>([&](auto m) { st[z * kNN + row + m * kTl] = v[m]; });
      }
      static_for<0, kE>([&](auto m) {
        const int k = row + m * kTl;
        float sn, cs;
        sincosf(phi_z[k], &sn, &cs);
        const float a = a_z[k];
        v[m] = cmul(v[m], make_float2(a * cs, a * sn));
      });
      line_dif<kLogN>(v, t, ex);
      store_freq<P>(v, t, ex);
    });
    __syncthreads();
    if (z == nz - 1) break;
    // the propagation's column phase: forward transform, (K_z), H / N^2, inverse
    for_cols<P>(s, [&](int x, int t, const auto& ex) {
      float2 v[kE];
      load_line<P>(v, t, ex);
      line_dif<kLogN>(v, t, ex);
      static_for<0, kE>([&](auto i) {
        const int k = regfft::dif_freq<kLogN>(t, i) * kN + x;
        if constexpr (kDh) kst[z * kNN + k] = v[i];
        const float2 hv = __ldg(h + k);
        v[i] = cmul(v[i], make_float2(hv.x * kInvNN, hv.y * kInvNN));
      });
      line_dit<kLogN>(v, t, ex);
      store_line<P>(v, t, ex);
    });
    __syncthreads();
  }
}

template <int LOGN>
__global__ void __launch_bounds__(kFwdBlock<LOGN>)
chain_fwd_kernel(const float* __restrict__ obja, const float* __restrict__ objp,
                 const float2* __restrict__ probe, const float2* __restrict__ h,
                 float* __restrict__ inten, int pmode, int nz, int shared_probe, int h_shared,
                 int kspace) {
  using P = FPlan<LOGN, kFwdThreads>;
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
    load_line<P>(v, t, ex);
    line_dif<LOGN>(v, t, ex);
    static_for<0, kE>([&](auto i) {
      out[regfft::dif_freq<LOGN>(t, i) * kN + x] = (v[i].x * v[i].x + v[i].y * v[i].y) * kInvNN;
    });
  });
}

// dp = the sum over modes of inten, in mode order (B4a)
__global__ void __launch_bounds__(kSumThreads)
mode_sum_kernel(const float* __restrict__ inten, float* __restrict__ dp, int pmode, int logn2,
                size_t total) {
  const size_t nn = size_t(1) << logn2;
  for (size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = t >> logn2;
    const float* src = inten + b * pmode * nn + (t & (nn - 1));
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
// N^2 pixels, sums the modes into dp in mode order, and writes the masked
// partial sums of s1 and s2 over its pixels to partial (B, chunks, 2).
__global__ void __launch_bounds__(kSumThreads)
loss_reduce_kernel(const float* __restrict__ inten, const float* __restrict__ meas,
                   const float* __restrict__ mask, float* __restrict__ dp,
                   float* __restrict__ partial, int pmode, int logn2, float p, float eps) {
  __shared__ float red[kSumThreads / 32];
  const size_t nn = size_t(1) << logn2;
  const size_t b = blockIdx.y;
  const size_t per = nn / gridDim.x;
  const size_t first = b * nn + blockIdx.x * per;
  float s1 = 0.0f;
  float s2 = 0.0f;
  for (size_t i = first + threadIdx.x; i < first + per; i += blockDim.x) {
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
// (B4b) it is read from g. kDh (need_dh): the recompute stores each K_z in
// kstack (B pmode, nz - 1, N, N) and the walk accumulates this wavefield's
// sum_z U_z conj(K_z) into its dh_part field, in natural order; without it
// both pointers are ignored.
template <int LOGN, bool kLoss, bool kDh>
__global__ void __launch_bounds__(kBwdBlock<LOGN>)
chain_bwd_kernel(const float* __restrict__ obja, const float* __restrict__ objp,
                 const float2* __restrict__ probe, const float2* __restrict__ h,
                 const float* __restrict__ g, const float* __restrict__ meas,
                 const float* __restrict__ mask, const float* __restrict__ dp,
                 const float* __restrict__ c, float2* __restrict__ stack, float2* kstack,
                 float2* dh_part, float* __restrict__ d_obja, float* __restrict__ d_objp,
                 float2* __restrict__ d_probe, int pmode, int nz, int shared_probe,
                 int h_shared, int kspace, float p, float eps) {
  using P = FPlan<LOGN, kBwdThreads>;
  constexpr int kN = P::kN, kE = P::kE, kTl = P::kTl, kNN = P::kNN;
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
    load_line<P>(v, t, ex);
    line_dif<LOGN>(v, t, ex);
    static_for<0, kE>([&](auto i) {
      const int k = regfft::dif_freq<LOGN>(t, i) * kN + x;
      float gk;
      if constexpr (kLoss) {
        const float d = g_b[k] + eps;
        gk = (pow_p(d, p) - pow_p(m_b[k], p)) * pow_pm1(d, p);
      } else {
        gk = g_b[k];
      }
      v[i] = cscale(v[i], coef * gk);
    });
    line_dit<LOGN>(v, t, ex);
    store_line<P>(v, t, ex);
  });
  __syncthreads();

  float* da_b = d_obja + static_cast<size_t>(b) * nz * kNN;
  float* dphi_b = d_objp + static_cast<size_t>(b) * nz * kNN;
  float2* out = d_probe + pr_off;
  for (int z = nz - 1; z >= 0; --z) {
    const bool probe_rows = z == 0 && !kspace;  // d probe leaves from the row phase
    // the inverse row transform (of the far field's adjoint or the adjoint
    // propagation): d chi; dT against the entry state; d psi = d chi conj(T);
    // the forward row transform of the adjoint propagation to slice z - 1
    for_rows<P>(smem, [&](int y, int t, const auto& ex) {
      float2 v[kE];
      load_freq<P>(v, t, ex);
      line_dit<LOGN>(v, t, ex);
      const int row = z * kNN + y * kN + t;
      static_for<0, kE>([&](auto m) {
        const int k = row + m * kTl;
        float sn, cs;
        sincosf(phi_b[k], &sn, &cs);
        const float a = a_b[k];
        const float2 dt = cmul_conj(v[m], st[k]);  // dT = d chi conj(psi)
        atomicAdd(da_b + k, dt.x * cs + dt.y * sn);
        atomicAdd(dphi_b + k, a * (dt.y * cs - dt.x * sn));
        v[m] = cmul_conj(v[m], make_float2(a * cs, a * sn));
      });
      if (probe_rows) {
        static_for<0, kE>([&](auto m) {
          put_probe(out + y * kN + t + m * kTl, v[m], shared_probe);
        });
      } else {
        line_dif<LOGN>(v, t, ex);
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
        load_line<P>(v, t, ex);
        line_dif<LOGN>(v, t, ex);
        static_for<0, kE>([&](auto i) {
          const int k = regfft::dif_freq<LOGN>(t, i) * kN + x;
          if constexpr (kDh) {
            float2 d = cmul_conj(v[i], kst[(z - 1) * kNN + k]);
            if (z != nz - 1) d = make_float2(d.x + dacc[k].x, d.y + dacc[k].y);
            dacc[k] = d;
          }
          const float2 hv = __ldg(h_b + k);
          v[i] = cmul_conj(v[i], make_float2(hv.x * kInvNN, hv.y * kInvNN));
        });
        line_dit<LOGN>(v, t, ex);
        store_line<P>(v, t, ex);
      });
      __syncthreads();
    } else {
      // kspace: the spectrum's cotangent, fft2(d psi_0) / N^2
      for_cols<P>(smem, [&](int x, int t, const auto& ex) {
        float2 v[kE];
        load_line<P>(v, t, ex);
        line_dif<LOGN>(v, t, ex);
        static_for<0, kE>([&](auto i) {
          put_probe(out + regfft::dif_freq<LOGN>(t, i) * kN + x, cscale(v[i], kInvNN),
                    shared_probe);
        });
      });
    }
  }
}

// Set-up once per (device, log2 N) (regfft::prepare_once): the twiddle table
// and the shared-memory limits of the five chain kernels of that N. After
// it a launch checks one flag and does no set-up (ptyrad_fused_prepare).
cudaError_t prepare(int logn) {
  return regfft::prepare_once<kMaxLogN>(logn, [](int logn) {
    return with_logn<kMaxLogN>(logn, [](auto L) -> cudaError_t {
      constexpr int kL = decltype(L)::value;
      constexpr size_t smem = FPlan<kL, kFwdThreads>::kSmem;  // both kernels'
      REGFFT_TRY(set_smem(chain_fwd_kernel<kL>, smem));
      REGFFT_TRY(set_smem(chain_bwd_kernel<kL, false, false>, smem));
      REGFFT_TRY(set_smem(chain_bwd_kernel<kL, false, true>, smem));
      REGFFT_TRY(set_smem(chain_bwd_kernel<kL, true, false>, smem));
      return set_smem(chain_bwd_kernel<kL, true, true>, smem);
    });
  });
}

cudaError_t launch_chain_fwd(const float* obja, const float* objp, const float2* probe,
                             const float2* h, float* inten, int B, int pmode, int nz, int logn,
                             int shared_probe, int h_shared, int kspace, cudaStream_t st) {
  REGFFT_TRY(prepare(logn));
  return with_logn<kMaxLogN>(logn, [&](auto L) -> cudaError_t {
    constexpr int kL = decltype(L)::value;
    using P = FPlan<kL, kFwdThreads>;
    chain_fwd_kernel<kL><<<B * pmode, P::kThreads, P::kSmem, st>>>(
        obja, objp, probe, h, inten, pmode, nz, shared_probe, h_shared, kspace);
    return cudaGetLastError();
  });
}

// Zeroes the outputs the backward accumulates into with atomics, then
// launches it; with dh (need_dh), then reduces the partials into dh (zero
// for a single slice, which propagates nowhere).
template <bool kLoss>
cudaError_t launch_chain_bwd(const float* obja, const float* objp, const float2* probe,
                             const float2* h, const float* g, const float* meas,
                             const float* mask, const float* dp, const float* c, float2* stack,
                             float2* kstack, float2* dh_part, float2* dh, float* d_obja,
                             float* d_objp, float2* d_probe, int B, int pmode, int nz, int logn,
                             int shared_probe, int h_shared, int kspace, float p, float eps,
                             cudaStream_t st) {
  REGFFT_TRY(prepare(logn));
  const size_t nn = size_t(1) << (2 * logn);
  const size_t obj_bytes = sizeof(float) * static_cast<size_t>(B) * nz * nn;
  const bool with_dh = dh != nullptr && nz > 1;
  REGFFT_TRY(cudaMemsetAsync(d_obja, 0, obj_bytes, st));
  REGFFT_TRY(cudaMemsetAsync(d_objp, 0, obj_bytes, st));
  if (shared_probe) {
    REGFFT_TRY(cudaMemsetAsync(d_probe, 0, sizeof(float2) * static_cast<size_t>(pmode) * nn, st));
  }
  if (dh != nullptr && !with_dh) {
    REGFFT_TRY(cudaMemsetAsync(dh, 0, sizeof(float2) * (h_shared ? 1 : B) * nn, st));
  }
  REGFFT_TRY(with_logn<kMaxLogN>(logn, [&](auto L) -> cudaError_t {
    constexpr int kL = decltype(L)::value;
    using P = FPlan<kL, kBwdThreads>;
    // without dH the instantiation that never touches the dH scratch
    auto kernel = with_dh ? chain_bwd_kernel<kL, kLoss, true> : chain_bwd_kernel<kL, kLoss, false>;
    kernel<<<B * pmode, P::kThreads, P::kSmem, st>>>(
        obja, objp, probe, h, g, meas, mask, dp, c, stack, kstack, dh_part, d_obja, d_objp,
        d_probe, pmode, nz, shared_probe, h_shared, kspace, p, eps);
    return cudaGetLastError();
  }));
  if (!with_dh) return cudaSuccess;
  return dh::reduce(dh_part, dh, B, pmode, h_shared, logn, st);
}

// B3a's epilogue blocks per sample: min(N, 16)
constexpr int chunks(int logn) { return 1 << (logn < 4 ? logn : 4); }

}  // namespace

extern "C" {

// B4a. obja, objp (B, 1, nz, N, N) f32; probe (B or 1, pmode, N, N)
// complex64; h (B or 1, N, N) complex64 (h_shared: one H for all). Writes
// the inten (B, pmode, N, N) scratch and dp (B, N, N), corner-centred.
int ptyrad_dp_fwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                  float* inten, float* dp, int B, int pmode, int nz, int logn, int shared_probe,
                  int h_shared, int kspace, void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_chain_fwd(obja, objp, probe, h, inten, B, pmode, nz, logn,
                                     shared_probe, h_shared, kspace, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) << (2 * logn);
  const size_t blocks = (total + kSumThreads - 1) / kSumThreads;
  mode_sum_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), kSumThreads, 0, st>>>(
      inten, dp, pmode, 2 * logn, total);
  return static_cast<int>(cudaGetLastError());
}

// B4b. As ptyrad_dp_fwd, plus g (B, N, N) the dp cotangent, corner-centred,
// and stack (B, pmode, nz, N, N) complex64 scratch. Writes d_obja, d_objp
// (B, 1, nz, N, N) and d_probe (the probe's shape); all three are zeroed
// here where they accumulate. With dh (H's shape) not null it also writes
// the propagator cotangent, through the scratches kstack (B, pmode, nz - 1,
// N, N) and dh_part (B, pmode, N, N).
int ptyrad_dp_bwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                  const float* g, float2* stack, float2* kstack, float2* dh_part, float2* dh,
                  float* d_obja, float* d_objp, float2* d_probe, int B, int pmode, int nz,
                  int logn, int shared_probe, int h_shared, int kspace, void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_chain_bwd<false>(
      obja, objp, probe, h, g, nullptr, nullptr, nullptr, nullptr, stack, kstack, dh_part, dh,
      d_obja, d_objp, d_probe, B, pmode, nz, logn, shared_probe, h_shared, kspace, 1.0f, 0.0f,
      static_cast<cudaStream_t>(stream)));
}

// B3a. As ptyrad_dp_fwd, plus meas (B, N, N) f32 corner-centred and mask
// (B,) f32. Writes the inten (B, pmode, N, N) and partial (B, chunks, 2)
// scratch (chunks = min(N, 16), ptyrad_fused_plan), dp (B, N, N) and
// sums (2,) = (s1, s2).
int ptyrad_loss_fwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                    const float* meas, const float* mask, float* inten, float* dp,
                    float* partial, float* sums, int B, int pmode, int nz, int logn,
                    int shared_probe, int h_shared, int kspace, float p, float eps,
                    void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_chain_fwd(obja, objp, probe, h, inten, B, pmode, nz, logn,
                                     shared_probe, h_shared, kspace, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_reduce_kernel<<<dim3(chunks(logn), B), kSumThreads, 0, st>>>(inten, meas, mask, dp,
                                                                   partial, pmode, 2 * logn, p,
                                                                   eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, 32, 0, st>>>(partial, sums, B * chunks(logn));
  return static_cast<int>(cudaGetLastError());
}

// B3b. As ptyrad_loss_fwd, plus dp (the forward's residual), c (scalar
// cotangent of s1, on the device) and stack (B, pmode, nz, N, N) complex64
// scratch. Writes d_obja, d_objp, d_probe and (with dh) the propagator
// cotangent as ptyrad_dp_bwd does.
int ptyrad_loss_bwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                    const float* meas, const float* mask, const float* dp, const float* c,
                    float2* stack, float2* kstack, float2* dh_part, float2* dh, float* d_obja,
                    float* d_objp, float2* d_probe, int B, int pmode, int nz, int logn,
                    int shared_probe, int h_shared, int kspace, float p, float eps,
                    void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_chain_bwd<true>(
      obja, objp, probe, h, nullptr, meas, mask, dp, c, stack, kstack, dh_part, dh, d_obja,
      d_objp, d_probe, B, pmode, nz, logn, shared_probe, h_shared, kspace, p, eps,
      static_cast<cudaStream_t>(stream)));
}

// The set-up of N = 2^logn on the current device (prepare): a launch after it
// does none.
int ptyrad_fused_prepare(int logn) { return static_cast<int>(prepare(logn)); }

// The plan for N = 2^logn, which the card-only tests hold against
// tests/test_torch_fused_plan.py's: out gets N, E, TL, the padded row
// length, the forward and the backward chain block's threads and sweeps, a
// column group's threads, the blocks' shared bytes and the B3a epilogue's
// blocks per sample.
int ptyrad_fused_plan(int logn, int* out) {
  return static_cast<int>(with_logn<kMaxLogN>(logn, [&](auto L) -> cudaError_t {
    using F = FPlan<decltype(L)::value, kFwdThreads>;
    using B = FPlan<decltype(L)::value, kBwdThreads>;
    const int v[] = {F::kN, F::kE, F::kTl, F::kLine, F::kThreads, F::kSweeps, B::kThreads,
                     B::kSweeps, F::kGroupThreads, static_cast<int>(F::kSmem), chunks(logn)};
    for (int i = 0; i < 11; ++i) out[i] = v[i];
    return cudaSuccess;
  }));
}

}  // extern "C"
