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
// Contract (omode 1, shared propagator H, no dH):
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
//   probe's shape).
//
// Bound on the card: FP32 arithmetic. A 128^2 complex 2D FFT is about
// 10 N^2 log2 N = 1.15 MFLOP. The forward runs 12 of them per (sample, mode)
// wavefield (kspace probe load, 5 propagations of 2, the far field), the
// backward 24 (the recompute plus the adjoint walk). At B=32, pmode=6 that
// is about 2.7 GFLOP forward and 5.3 GFLOP backward: 40 us and 80 us at
// 67 TFLOP/s. The forward reads about 52 MB, 16 us at 3.35 TB/s.
//
// Design:
//  * One block per (sample, mode) wavefield: 192 blocks at tBL. The 128^2
//    complex64 field (128 KB) lives in dynamic shared memory for the whole
//    chain; the 2D DFTs run there as radix-2 butterfly passes, fused with the
//    T and H multiplies, so the wavefield never touches device memory. The
//    DFT is computed, not called: no cuFFT, no library.
//  * No bit-reversal passes. The forward transform is decimation in
//    frequency (natural order in, bit-reversed out) and the inverse is
//    decimation in time (bit-reversed in, natural out), so a propagation
//    multiplies by H read at bit-reversed indices and needs no permutation.
//    Far-field values, the kspace probe, the measurement and the dp
//    cotangent are addressed through the same index map. The adjoint of one
//    transform is the other with the conjugate twiddles, so the backward
//    reuses both.
//  * Mode reduction: dp sums over modes, which live in different blocks.
//    The chain kernel writes |Y|^2/N^2 to a (B, pmode, N, N) scratch. For B4a
//    an elementwise kernel sums the modes into dp in mode order. For B3a a
//    second kernel, one block per sample, forms dp (kept as the residual for
//    the backward, 2 MB) and the masked s1/s2 partial sums per sample; a
//    one-warp third kernel adds the B partials in a fixed order. Both
//    forwards are deterministic. One block per sample looping over modes
//    would fill only 32 of 132 SMs.
//  * Backward: the recompute writes the Nz slice-entry states of each
//    wavefield to a device scratch (B pmode Nz N^2 8 B = 151 MB at tBL); each
//    thread later reads back exactly the elements it wrote, so no extra
//    synchronisation is needed. dT sums over modes: each block adds its
//    d(a, phi) contribution (linear in dT) into zeroed outputs with
//    atomicAdd, and a shared probe's gradient is summed over samples the
//    same way; the order of those adds varies from run to run.
//  * FP32 throughout, accurate sincosf, twiddles from double sincospi.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kReduceThreads = 256;
constexpr int kSumThreads = 256;
constexpr int kMaxLogN = 7;  // N <= 128: the field and twiddles fit 227 KB of shared memory

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

__device__ __forceinline__ int bitrev(int i, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - logn));
}

// Natural (row-major, corner-centred) index of the spectrum element held at
// shared position i after a 2D forward transform; an involution, so it also
// gives the shared position of natural index i.
__device__ __forceinline__ int spectral_index(int i, int n, int logn) {
  return bitrev(i >> logn, logn) * n + bitrev(i & (n - 1), logn);
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

// tw[k] = exp(-2 pi i k / n), k < n/2
__device__ void init_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
    double sn, cs;
    sincospi(-2.0 * k / n, &sn, &cs);
    tw[k] = make_float2(static_cast<float>(cs), static_cast<float>(sn));
  }
}

// One radix-2 stage along x (rows) or y (columns) of the N x N tile.
// kDit: decimation in time with conjugate twiddles (inverse direction);
// else decimation in frequency with forward twiddles.
template <bool kAlongX, bool kDit>
__device__ __forceinline__ void butterfly_stage(float2* s, const float2* tw, int n, int logn,
                                                int lh) {
  const int half = 1 << lh;
  const int tshift = logn - 1 - lh;  // twiddle stride n / (2 half)
  const int nbfly = (n * n) >> 1;
  for (int t = threadIdx.x; t < nbfly; t += blockDim.x) {
    int line, b;
    if (kAlongX) {
      line = t >> (logn - 1);
      b = t & ((n >> 1) - 1);
    } else {
      line = t & (n - 1);  // neighbouring threads on neighbouring columns
      b = t >> logn;
    }
    const int j = b & (half - 1);
    const int i0 = ((b >> lh) << (lh + 1)) + j;
    const int i1 = i0 + half;
    const int a0 = kAlongX ? line * n + i0 : i0 * n + line;
    const int a1 = kAlongX ? line * n + i1 : i1 * n + line;
    float2 w = tw[j << tshift];
    const float2 u = s[a0];
    const float2 v = s[a1];
    if (kDit) {
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

// Unnormalized forward 2D DFT in place: natural order in, bit-reversed out.
// Callers synchronise before; returns synchronised.
__device__ void fft2_fwd(float2* s, const float2* tw, int n, int logn) {
  for (int lh = logn - 1; lh >= 0; --lh) {
    butterfly_stage<true, false>(s, tw, n, logn, lh);
    __syncthreads();
  }
  for (int lh = logn - 1; lh >= 0; --lh) {
    butterfly_stage<false, false>(s, tw, n, logn, lh);
    __syncthreads();
  }
}

// Unnormalized inverse 2D DFT in place: bit-reversed in, natural out.
__device__ void fft2_inv(float2* s, const float2* tw, int n, int logn) {
  for (int lh = 0; lh < logn; ++lh) {
    butterfly_stage<false, true>(s, tw, n, logn, lh);
    __syncthreads();
  }
  for (int lh = 0; lh < logn; ++lh) {
    butterfly_stage<true, true>(s, tw, n, logn, lh);
    __syncthreads();
  }
}

// psi <- ifft2(H * fft2(psi)), with the 1/N^2 of ifft2 folded into H. With
// kConjH it is the adjoint step: inv(conj(H)/N^2 * fwd(.)) unnormalized.
template <bool kConjH>
__device__ void propagate(float2* s, const float2* tw, const float2* __restrict__ h, int n,
                          int logn) {
  const int nn = n * n;
  const float inv_nn = 1.0f / static_cast<float>(nn);
  fft2_fwd(s, tw, n, logn);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const float2 hv = cscale(h[spectral_index(i, n, logn)], inv_nn);
    s[i] = kConjH ? cmul_conj(s[i], hv) : cmul(s[i], hv);
  }
  __syncthreads();
  fft2_inv(s, tw, n, logn);
}

// Initial wavefield of this block's mode; for a kspace probe, the
// UNNORMALIZED inverse transform of its spectrum (the caller applies 1/N^2).
__device__ void load_probe(float2* s, const float2* tw, const float2* __restrict__ pr, int n,
                           int logn, bool kspace) {
  const int nn = n * n;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    s[kspace ? spectral_index(i, n, logn) : i] = pr[i];
  }
  __syncthreads();
  if (kspace) fft2_inv(s, tw, n, logn);
}

// The chain from the loaded probe through the far-field transform: s ends
// as the unnormalized spectrum Y in bit-reversed order. With st, each
// slice's entry state is stored there for the backward.
__device__ void run_chain(float2* s, const float2* tw, const float* __restrict__ a_b,
                          const float* __restrict__ phi_b, const float2* __restrict__ h,
                          float2* __restrict__ st, int nz, int n, int logn, bool kspace) {
  const int nn = n * n;
  const float inv_nn = 1.0f / static_cast<float>(nn);
  for (int z = 0; z < nz; ++z) {
    const float f = (z == 0 && kspace) ? inv_nn : 1.0f;
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      const size_t zi = static_cast<size_t>(z) * nn + i;
      float sn, cs;
      sincosf(phi_b[zi], &sn, &cs);
      const float a = a_b[zi];
      const float2 v = cscale(s[i], f);
      if (st != nullptr) st[zi] = v;
      s[i] = cmul(v, make_float2(a * cs, a * sn));
    }
    __syncthreads();
    if (z < nz - 1) propagate<false>(s, tw, h, n, logn);
  }
  fft2_fwd(s, tw, n, logn);
}

__global__ void __launch_bounds__(kThreads)
chain_fwd_kernel(const float* __restrict__ obja, const float* __restrict__ objp,
                 const float2* __restrict__ probe, const float2* __restrict__ h,
                 float* __restrict__ inten, int pmode, int nz, int logn, int shared_probe,
                 int kspace) {
  extern __shared__ float2 smem[];
  const int n = 1 << logn;
  const int nn = n * n;
  float2* s = smem;
  float2* tw = smem + nn;
  const int b = blockIdx.x / pmode;
  const int p = blockIdx.x % pmode;
  const float inv_nn = 1.0f / static_cast<float>(nn);

  init_twiddles(tw, n);
  load_probe(s, tw, probe + (static_cast<size_t>(shared_probe ? 0 : b) * pmode + p) * nn, n,
             logn, kspace);
  run_chain(s, tw, obja + static_cast<size_t>(b) * nz * nn,
            objp + static_cast<size_t>(b) * nz * nn, h, nullptr, nz, n, logn, kspace);
  float* out = inten + static_cast<size_t>(blockIdx.x) * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const float2 v = s[spectral_index(i, n, logn)];
    out[i] = (v.x * v.x + v.y * v.y) * inv_nn;
  }
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

// One block per sample: dp = sum over modes, then the masked partial sums (B3a).
__global__ void __launch_bounds__(kReduceThreads)
loss_reduce_kernel(const float* __restrict__ inten, const float* __restrict__ meas,
                   const float* __restrict__ mask, float* __restrict__ dp,
                   float* __restrict__ partial, int pmode, int nn, float p, float eps) {
  __shared__ float red[kReduceThreads / 32];
  const int b = blockIdx.x;
  float s1 = 0.0f;
  float s2 = 0.0f;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    float d = 0.0f;
    for (int q = 0; q < pmode; ++q) d += inten[(static_cast<size_t>(b) * pmode + q) * nn + i];
    dp[static_cast<size_t>(b) * nn + i] = d;
    const float mp = pow_p(meas[static_cast<size_t>(b) * nn + i], p);
    const float diff = pow_p(d + eps, p) - mp;
    s1 += diff * diff;
    s2 += mp;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    partial[2 * b] = mask[b] * s1;
    partial[2 * b + 1] = mask[b] * s2;
  }
}

// s1, s2 = the sums of the B per-sample partials, in sample order
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                                    int B) {
  if (threadIdx.x < 2) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += partial[2 * b + threadIdx.x];
    sums[threadIdx.x] = acc;
  }
}

// The backward of one (sample, mode) wavefield. kLoss (B3b): the dp
// cotangent is formed here from meas, mask, the forward's dp and c; else
// (B4b) it is read from g.
template <bool kLoss>
__global__ void __launch_bounds__(kThreads)
chain_bwd_kernel(const float* __restrict__ obja, const float* __restrict__ objp,
                 const float2* __restrict__ probe, const float2* __restrict__ h,
                 const float* __restrict__ g, const float* __restrict__ meas,
                 const float* __restrict__ mask, const float* __restrict__ dp,
                 const float* __restrict__ c, float2* __restrict__ stack,
                 float* __restrict__ d_obja, float* __restrict__ d_objp,
                 float2* __restrict__ d_probe, int pmode, int nz, int logn, int shared_probe,
                 int kspace, float p, float eps) {
  extern __shared__ float2 smem[];
  const int n = 1 << logn;
  const int nn = n * n;
  float2* s = smem;
  float2* tw = smem + nn;
  const int b = blockIdx.x / pmode;
  const int pm = blockIdx.x % pmode;
  const float inv_nn = 1.0f / static_cast<float>(nn);

  init_twiddles(tw, n);
  load_probe(s, tw, probe + (static_cast<size_t>(shared_probe ? 0 : b) * pmode + pm) * nn, n,
             logn, kspace);

  // recompute the chain, keeping each slice's entry state
  const float* a_b = obja + static_cast<size_t>(b) * nz * nn;
  const float* phi_b = objp + static_cast<size_t>(b) * nz * nn;
  float2* st = stack + static_cast<size_t>(blockIdx.x) * nz * nn;
  run_chain(s, tw, a_b, phi_b, h, st, nz, n, logn, kspace);

  // dY = 2 g Y / N^2, g the cotangent of dp
  if constexpr (kLoss) {
    // g = c mask 2p ((dp+eps)^p - meas^p) (dp+eps)^(p-1)
    const float coef = c[0] * mask[b] * 2.0f * p * 2.0f * inv_nn;
    const float* dp_b = dp + static_cast<size_t>(b) * nn;
    const float* m_b = meas + static_cast<size_t>(b) * nn;
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      const int k = spectral_index(i, n, logn);
      const float d = dp_b[k] + eps;
      const float gk = (pow_p(d, p) - pow_p(m_b[k], p)) * pow_pm1(d, p);
      s[i] = cscale(s[i], coef * gk);
    }
  } else {
    const float coef = 2.0f * inv_nn;
    const float* g_b = g + static_cast<size_t>(b) * nn;
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      s[i] = cscale(s[i], coef * g_b[spectral_index(i, n, logn)]);
    }
  }
  __syncthreads();
  fft2_inv(s, tw, n, logn);  // adjoint of the far-field transform

  float* da_b = d_obja + static_cast<size_t>(b) * nz * nn;
  float* dphi_b = d_objp + static_cast<size_t>(b) * nz * nn;
  for (int z = nz - 1; z >= 0; --z) {
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      const size_t zi = static_cast<size_t>(z) * nn + i;
      float sn, cs;
      sincosf(phi_b[zi], &sn, &cs);
      const float a = a_b[zi];
      const float2 dchi = s[i];
      const float2 dt = cmul_conj(dchi, st[zi]);  // dT = dchi conj(psi)
      atomicAdd(da_b + zi, dt.x * cs + dt.y * sn);
      atomicAdd(dphi_b + zi, a * (dt.y * cs - dt.x * sn));
      s[i] = cmul_conj(dchi, make_float2(a * cs, a * sn));  // dpsi = dchi conj(T)
    }
    __syncthreads();
    if (z > 0) propagate<true>(s, tw, h, n, logn);
  }

  // s holds the cotangent of the (scaled) entry state psi_0
  if (kspace) fft2_fwd(s, tw, n, logn);  // adjoint of ifft2: fft2 / N^2
  float2* out = d_probe + (static_cast<size_t>(shared_probe ? 0 : b) * pmode + pm) * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const float2 v = kspace ? cscale(s[spectral_index(i, n, logn)], inv_nn) : s[i];
    if (shared_probe) {
      atomicAdd(&out[i].x, v.x);
      atomicAdd(&out[i].y, v.y);
    } else {
      out[i] = v;
    }
  }
}

size_t chain_smem_bytes(int logn) {
  const size_t n = size_t(1) << logn;
  return (n * n + n / 2) * sizeof(float2);
}

cudaError_t launch_chain_fwd(const float* obja, const float* objp, const float2* probe,
                             const float2* h, float* inten, int B, int pmode, int nz, int logn,
                             int shared_probe, int kspace, cudaStream_t st) {
  const size_t smem = chain_smem_bytes(logn);
  cudaError_t err = cudaFuncSetAttribute(chain_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  chain_fwd_kernel<<<B * pmode, kThreads, smem, st>>>(obja, objp, probe, h, inten, pmode, nz,
                                                     logn, shared_probe, kspace);
  return cudaGetLastError();
}

// Zeroes the outputs the backward accumulates into with atomics, then
// launches it.
template <bool kLoss>
cudaError_t launch_chain_bwd(const float* obja, const float* objp, const float2* probe,
                             const float2* h, const float* g, const float* meas,
                             const float* mask, const float* dp, const float* c, float2* stack,
                             float* d_obja, float* d_objp, float2* d_probe, int B, int pmode,
                             int nz, int logn, int shared_probe, int kspace, float p, float eps,
                             cudaStream_t st) {
  const size_t nn = size_t(1) << (2 * logn);
  const size_t obj_bytes = sizeof(float) * static_cast<size_t>(B) * nz * nn;
  cudaError_t err = cudaMemsetAsync(d_obja, 0, obj_bytes, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(d_objp, 0, obj_bytes, st);
  if (err == cudaSuccess && shared_probe) {
    err = cudaMemsetAsync(d_probe, 0, sizeof(float2) * static_cast<size_t>(pmode) * nn, st);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = chain_smem_bytes(logn);
  err = cudaFuncSetAttribute(chain_bwd_kernel<kLoss>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  chain_bwd_kernel<kLoss><<<B * pmode, kThreads, smem, st>>>(
      obja, objp, probe, h, g, meas, mask, dp, c, stack, d_obja, d_objp, d_probe, pmode, nz,
      logn, shared_probe, kspace, p, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B4a. obja, objp (B, 1, nz, N, N) f32; probe (B or 1, pmode, N, N)
// complex64; h (N, N) complex64. Writes the inten (B, pmode, N, N) scratch
// and dp (B, N, N), corner-centred.
int ptyrad_dp_fwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                  float* inten, float* dp, int B, int pmode, int nz, int logn, int shared_probe,
                  int kspace, void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_chain_fwd(obja, objp, probe, h, inten, B, pmode, nz, logn,
                                     shared_probe, kspace, st);
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
// here where they accumulate.
int ptyrad_dp_bwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                  const float* g, float2* stack, float* d_obja, float* d_objp, float2* d_probe,
                  int B, int pmode, int nz, int logn, int shared_probe, int kspace,
                  void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_chain_bwd<false>(
      obja, objp, probe, h, g, nullptr, nullptr, nullptr, nullptr, stack, d_obja, d_objp,
      d_probe, B, pmode, nz, logn, shared_probe, kspace, 1.0f, 0.0f,
      static_cast<cudaStream_t>(stream)));
}

// B3a. As ptyrad_dp_fwd, plus meas (B, N, N) f32 corner-centred and mask
// (B,) f32. Writes the inten (B, pmode, N, N) and partial (B, 2) scratch, dp
// (B, N, N) and sums (2,) = (s1, s2).
int ptyrad_loss_fwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                    const float* meas, const float* mask, float* inten, float* dp,
                    float* partial, float* sums, int B, int pmode, int nz, int logn,
                    int shared_probe, int kspace, float p, float eps, void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_chain_fwd(obja, objp, probe, h, inten, B, pmode, nz, logn,
                                     shared_probe, kspace, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_reduce_kernel<<<B, kReduceThreads, 0, st>>>(inten, meas, mask, dp, partial, pmode,
                                                   1 << (2 * logn), p, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, 32, 0, st>>>(partial, sums, B);
  return static_cast<int>(cudaGetLastError());
}

// B3b. As ptyrad_loss_fwd, plus dp (the forward's residual), c (scalar
// cotangent of s1, on the device) and stack (B, pmode, nz, N, N) complex64
// scratch. Writes d_obja, d_objp and d_probe as ptyrad_dp_bwd does.
int ptyrad_loss_bwd(const float* obja, const float* objp, const float2* probe, const float2* h,
                    const float* meas, const float* mask, const float* dp, const float* c,
                    float2* stack, float* d_obja, float* d_objp, float2* d_probe, int B,
                    int pmode, int nz, int logn, int shared_probe, int kspace, float p,
                    float eps, void* stream) {
  if (logn < 1 || logn > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_chain_bwd<true>(
      obja, objp, probe, h, nullptr, meas, mask, dp, c, stack, d_obja, d_objp, d_probe, B,
      pmode, nz, logn, shared_probe, kspace, p, eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
