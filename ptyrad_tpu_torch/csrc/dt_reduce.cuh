// The last step of B3b/B4b (multislice.cu): the chain backward leaves, for
// each (sample, mode) wavefield, the transmission cotangent dT_z = d chi_z
// conj(psi_z) of every slice in place of that slice's entry state in the
// (B, pmode, nz, N, N) stack, and, for a shared probe, the wavefield's probe
// cotangent in a (B, pmode, N, N) partial field. dt::obj sums dT over the
// modes in mode order and only then forms the object cotangents, which are
// linear in dT (a and phi do not depend on the mode):
//   d obja = Re(S e^{-i phi}),  d objp = a Im(S e^{-i phi}),  S = sum_p dT_p;
// dt::probe sums the partials over the samples in sample order. A fixed
// order and no atomics: two runs of a backward agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace dt {

constexpr int kThreads = 256;

inline unsigned grid_for(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
}

// t over (b, z, k) of d obja/d objp (B, 1, nz, N, N): the modes of sample b
// sit pmode fields of nz N^2 apart in the stack
__global__ void __launch_bounds__(kThreads)
obj_kernel(const float2* __restrict__ stack, const float* __restrict__ obja,
           const float* __restrict__ objp, float* __restrict__ d_obja,
           float* __restrict__ d_objp, int pmode, size_t per_sample, size_t total) {
  for (size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = t / per_sample;
    const float2* src = stack + b * pmode * per_sample + (t - b * per_sample);
    float2 s = make_float2(0.0f, 0.0f);
    for (int q = 0; q < pmode; ++q) {
      const float2 v = src[q * per_sample];
      s.x += v.x;
      s.y += v.y;
    }
    float sn, cs;
    sincosf(objp[t], &sn, &cs);
    d_obja[t] = s.x * cs + s.y * sn;
    d_objp[t] = obja[t] * (s.y * cs - s.x * sn);
  }
}

// t over (mode, k) of the shared probe's cotangent (1, pmode, N, N)
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float2* __restrict__ part, float2* __restrict__ d_probe, int B,
             size_t per_sample, size_t total) {
  for (size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float2 s = make_float2(0.0f, 0.0f);
    for (int b = 0; b < B; ++b) {
      const float2 v = part[b * per_sample + t];
      s.x += v.x;
      s.y += v.y;
    }
    d_probe[t] = s;
  }
}

// d obja, d objp from the dT stack (nn = N^2)
inline cudaError_t obj(const float2* stack, const float* obja, const float* objp, float* d_obja,
                       float* d_objp, int B, int pmode, int nz, size_t nn, cudaStream_t st) {
  const size_t per_sample = static_cast<size_t>(nz) * nn;
  const size_t total = static_cast<size_t>(B) * per_sample;
  obj_kernel<<<grid_for(total), kThreads, 0, st>>>(stack, obja, objp, d_obja, d_objp, pmode,
                                                    per_sample, total);
  return cudaGetLastError();
}

// a shared probe's cotangent from the (B, pmode, N, N) partials
inline cudaError_t probe(const float2* part, float2* d_probe, int B, int pmode, size_t nn,
                         cudaStream_t st) {
  const size_t per_sample = static_cast<size_t>(pmode) * nn;
  probe_kernel<<<grid_for(per_sample), kThreads, 0, st>>>(part, d_probe, B, per_sample,
                                                          per_sample);
  return cudaGetLastError();
}

}  // namespace dt
}  // namespace
