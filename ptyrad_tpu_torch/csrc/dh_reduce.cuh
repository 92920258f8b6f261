// The last step of every backward that returns a propagator cotangent
// (need_dh): B3b/B4b (multislice.cu) and B5b/B6b (chain.cu) leave one
// partial field of sum U conj(K) per (sample, mode), laid out as a
// (B, pmode, N, N) field in natural order (the register transforms of
// reg_fft.cuh are natural in and out). dh::reduce sums them into dH
// (h_b, N, N) times 1/N^2 (the inverse transform's normalisation folded
// into H):
// element k of H row r sums the partials of the samples it serves (all B
// for a shared H, else sample r) over their modes, in sample then mode
// order, at any N (reduce_pix; reduce for N = 2^logn). A fixed order and
// no atomics: dH is deterministic, since the dz and tilt scalars that
// autograd contracts out of it are dominated by cancellation.

#pragma once

#include <cuda_runtime.h>

#include "reg_fft.cuh"

namespace {
namespace dh {

constexpr int kThreads = 256;

template <class Pix>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float2* __restrict__ part, float2* __restrict__ out, int B, int pmode,
              int h_shared, Pix pix) {
  const size_t nn = pix.nn();
  const size_t total = (h_shared ? 1 : B) * nn;
  const float inv_nn = 1.0f / static_cast<float>(nn);
  for (size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(pix.div(t));
    const size_t k = pix.mod(t);
    const int b0 = h_shared ? 0 : r;
    const int b1 = h_shared ? B : r + 1;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int b = b0; b < b1; ++b) {
      for (int q = 0; q < pmode; ++q) {
        const float2 v = part[(static_cast<size_t>(b) * pmode + q) * nn + k];
        acc.x += v.x;
        acc.y += v.y;
      }
    }
    out[t] = make_float2(acc.x * inv_nn, acc.y * inv_nn);
  }
}

// pix: the field's pixel arithmetic (regfft::Pow2Pix, regfft::FixedPix)
template <class Pix>
inline cudaError_t reduce_pix(const float2* part, float2* out, int B, int pmode, int h_shared,
                              Pix pix, cudaStream_t st) {
  const size_t total = static_cast<size_t>(h_shared ? 1 : B) * pix.nn();
  const size_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  reduce_kernel<<<grid, kThreads, 0, st>>>(part, out, B, pmode, h_shared, pix);
  return cudaGetLastError();
}

// N = 2^logn
inline cudaError_t reduce(const float2* part, float2* out, int B, int pmode, int h_shared,
                          int logn, cudaStream_t st) {
  return reduce_pix(part, out, B, pmode, h_shared, regfft::Pow2Pix{2 * logn}, st);
}

}  // namespace dh
}  // namespace
