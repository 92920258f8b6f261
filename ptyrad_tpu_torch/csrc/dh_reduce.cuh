// The last step of every backward that returns a propagator cotangent
// (need_dh): B3b/B4b (multislice.cu) and B5b/B6b (chain.cu) leave one
// partial field of sum U conj(K) per (sample, mode), laid out as a
// (B, pmode, N, N) field in the transforms' order: (bitrev ky, bitrev kx)
// for B3b/B4b's radix-2 passes (kBitrev, the default), natural for B5b/B6b's
// register passes. dh::reduce sums them into dH (h_b, N, N), natural order,
// times 1/N^2 (the inverse transform's normalisation folded into H):
// element k of H row r sums the partials of the samples it serves (all B
// for a shared H, else sample r) over their modes, in sample then mode
// order. A fixed order and
// no atomics: dH is deterministic, since the dz and tilt scalars that
// autograd contracts out of it are dominated by cancellation.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace dh {

constexpr int kThreads = 256;

__device__ __forceinline__ int bitrev(int i, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - logn));
}

template <bool kBitrev>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float2* __restrict__ part, float2* __restrict__ out, int B, int pmode,
              int h_shared, int logn) {
  const int n = 1 << logn;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t total = (h_shared ? 1 : B) * nn;
  const float inv_nn = 1.0f / static_cast<float>(nn);
  for (size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(t >> (2 * logn));
    const int k = static_cast<int>(t & (nn - 1));
    const size_t pos = kBitrev ? static_cast<size_t>(bitrev(k >> logn, logn)) * n +
                                     bitrev(k & (n - 1), logn)
                               : static_cast<size_t>(k);
    const int b0 = h_shared ? 0 : r;
    const int b1 = h_shared ? B : r + 1;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int b = b0; b < b1; ++b) {
      for (int q = 0; q < pmode; ++q) {
        const float2 v = part[(static_cast<size_t>(b) * pmode + q) * nn + pos];
        acc.x += v.x;
        acc.y += v.y;
      }
    }
    out[t] = make_float2(acc.x * inv_nn, acc.y * inv_nn);
  }
}

template <bool kBitrev = true>
inline cudaError_t reduce(const float2* part, float2* out, int B, int pmode, int h_shared,
                          int logn, cudaStream_t st) {
  const size_t total = static_cast<size_t>(h_shared ? 1 : B) << (2 * logn);
  const size_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  reduce_kernel<kBitrev><<<grid, kThreads, 0, st>>>(part, out, B, pmode, h_shared, logn);
  return cudaGetLastError();
}

}  // namespace dh
}  // namespace
