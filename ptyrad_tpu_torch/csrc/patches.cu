// Patch gather (B1) and its scatter-add adjoint (B2) for sm_90a.
//
// Replaces the TPU kernels of ptyrad_tpu/ops/patches.py:
//   B1  _gather_kernel  (:136, launched by pallas_gather      :159/:179)
//   B2  _scatter_kernel (:98,  launched by pallas_scatter_add :201/:224)
//
// Contract: B windows of shape (L, Ny, Nx) are cut from an f32 canvas
// (L, H, W) at int32 top-left corners (y, x); the corner is clamped to
// [0, H-Ny] x [0, W-Nx] exactly as lax.dynamic_slice clamps its start. The
// scatter is the adjoint: B patch cotangents are added into a zeroed canvas
// at the same clamped corners, overlapping windows accumulating.
//
// Bound on the card: both move bytes and do almost no arithmetic. At the
// tBL shapes (canvas 6x520x520 f32 = 6.5 MB, B=32 windows of 6x128x128 =
// 12.6 MB) a call moves about 19 MB, a few microseconds at 3.35 TB/s.
//
// Design: the TPU kept the whole canvas in VMEM and rolled tile-aligned
// windows because Mosaic needs aligned vector accesses. Hopper has no such
// rule, so here one thread handles one patch element, neighbouring threads
// on neighbouring x: reads (gather) and atomic adds (scatter) coalesce along
// the canvas row. The scatter's canvas stays in the 50 MB L2, where the
// atomics resolve; the order of the adds varies from run to run, so the
// scatter agrees with its plain version to rounding, not bit for bit. The
// gather is bit-exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long canvas_offset(long long i, const int* __restrict__ pos,
                                                   int L, int H, int W, int ny, int nx) {
  const int x = static_cast<int>(i % nx);
  long long r = i / nx;
  const int y = static_cast<int>(r % ny);
  r /= ny;
  const int l = static_cast<int>(r % L);
  const int b = static_cast<int>(r / L);
  const int y0 = min(max(pos[2 * b], 0), H - ny);
  const int x0 = min(max(pos[2 * b + 1], 0), W - nx);
  return (static_cast<long long>(l) * H + y0 + y) * W + x0 + x;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ canvas, const int* __restrict__ pos,
              float* __restrict__ out, int L, int H, int W, int ny, int nx, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = canvas[canvas_offset(i, pos, L, H, W, ny, nx)];
}

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const float* __restrict__ patches, const int* __restrict__ pos,
                   float* __restrict__ canvas, int L, int H, int W, int ny, int nx,
                   long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  atomicAdd(canvas + canvas_offset(i, pos, L, H, W, ny, nx), patches[i]);
}

unsigned grid_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* ptyrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// canvas (L, H, W) f32, pos (B, 2) int32, out (B, L, ny, nx) f32
int ptyrad_gather_patches(const float* canvas, const int* pos, float* out, int B, int L,
                          int H, int W, int ny, int nx, void* stream) {
  const long long total = static_cast<long long>(B) * L * ny * nx;
  if (total == 0) return 0;
  gather_kernel<<<grid_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      canvas, pos, out, L, H, W, ny, nx, total);
  return static_cast<int>(cudaGetLastError());
}

// patches (B, L, ny, nx) f32, pos (B, 2) int32, canvas (L, H, W) f32 (zeroed here)
int ptyrad_scatter_add_patches(const float* patches, const int* pos, float* canvas, int B,
                               int L, int H, int W, int ny, int nx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      canvas, 0, sizeof(float) * static_cast<size_t>(L) * H * W, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * L * ny * nx;
  if (total == 0) return 0;
  scatter_add_kernel<<<grid_for(total), kThreads, 0, s>>>(patches, pos, canvas, L, H, W,
                                                          ny, nx, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
