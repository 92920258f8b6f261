// Patch gather (B1) and its scatter-add adjoint (B2) for sm_90a; one launch
// serves one canvas or two (obja and objp share the corners).
//
// Replaces the TPU kernels of ptyrad_tpu/ops/patches.py:
//   B1  _gather_kernel  (:136, launched by pallas_gather      :159/:179)
//   B2  _scatter_kernel (:98,  launched by pallas_scatter_add :201/:224)
//
// Contract: B windows of shape (L, Ny, Nx) are cut from an f32 canvas
// (L, H, W) at int32 top-left corners (y, x); each corner is clamped to
// [0, H-Ny] x [0, W-Nx] as the Pallas kernels clamp it (a negative corner
// goes to 0; lax.dynamic_slice, the JAX package's XLA path, would wrap it).
// The scatter is the adjoint: B patch cotangents are summed into a zero
// canvas at the same clamped corners. Each canvas element is the sum of its
// covering windows in ascending b, from zero: the order of _scatter_kernel,
// which keeps the canvas chunk resident while its grid walks the batch, and
// of index_add_ on the CPU (the plain version), so the two agree bit for bit
// and the kernel repeats bit for bit.
//
// Bound on the card: bytes; neither kernel does arithmetic beyond B2's adds.
// At the PSO shapes (canvas 21 x 436 x 436 = 16.0 MB, B = 32 windows of
// 21 x 256 x 256 = 176.2 MB) one canvas moves 192 MB, 0.057 ms at
// 3.35 TB/s; at the tBL shapes (6 x 520 x 520, B = 32 of 6 x 128 x 128)
// 19 MB, 0.006 ms, where the launch and the tail set the pace.
//
// B1, the gather: a block writes kGatherRows whole rows of one output
// window (canvas, b, l decoded once from blockIdx, in 32-bit arithmetic; no
// thread divides). A warp takes a row: lane t writes 16 bytes of it as one
// float4 (column 4v .. 4v+3 for v = t, t + 32, ...), loaded as four scalar
// __ldg reads, since the corner x0 is arbitrary and the canvas row is not
// 16-byte aligned there. The four loads of a warp touch the same 512 bytes,
// which the L1 serves after the first: device memory and L2 see each byte
// once, and the loads cost fewer instructions than an aligned vector load
// rebuilt with shuffles for each of four residues. The stores are
// streaming (__stcs, evict first), faster than plain stores in
// patches_sweep.py (PERF.md). A width that is not a multiple of 4 (9 or
// 33, say; 96 and 120 are multiples), or an output that is not 16-byte
// aligned, takes the scalar path of the same kernel, slower where both
// apply: lane t writes columns t, t + 32, ...
//
// B2, the scatter-add, owner computes: a block owns a kTileRows x kTileCols
// tile of one canvas plane (l) and writes each of its elements once, zeros
// included: no memset, no atomics. It loads up to kChunk clamped corners
// into shared memory, tests them against its tile (one window a thread) and
// compacts the overlapping ones in ascending b (a ballot a warp, a prefix
// over the warps); then it walks that list in order, adding each window's
// overlapping patch rows into register sums (thread (warp, lane) holds rows
// warp + 8 r and columns lane + 32 j of the tile). A warp reads 32
// consecutive floats of a patch row per load. The tiles partition the
// canvas, so each patch element is read once, by the owner of its canvas
// element. The overlap test costs a block B / kThreads comparisons a
// thread, so thousands of windows cost a few loop trips. The tile is the
// fastest of patches_sweep.py's variants at the PSO shapes (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;                     // both kernels: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGatherRows = 16;                   // output rows a gather block writes
constexpr int kTileRows = 16;                     // scatter tile: rows
constexpr int kTileCols = 64;                     //   by columns
constexpr int kRowSums = kTileRows / kWarps;      // rows of a thread's sums
constexpr int kColSums = kTileCols / 32;          // columns of a thread's sums
constexpr int kChunk = 1024;                      // corners a scatter block holds at once
constexpr int kMaxGridZ = 65535;
static_assert(kTileRows % kWarps == 0 && kTileCols % 32 == 0, "tile must split over the warps");
static_assert(kChunk % kThreads == 0, "a chunk is whole passes of the block");

__device__ __forceinline__ int clamp_corner(int v, int hi) { return min(max(v, 0), hi); }

// grid (ceil(ny / kGatherRows), L, min(B * n_canvas, kMaxGridZ))
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ canvas0, const float* __restrict__ canvas1,
              const int* __restrict__ pos, float* __restrict__ out0, float* __restrict__ out1,
              int B, int L, int H, int W, int ny, int nx, int vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kGatherRows;
  const int rows = min(kGatherRows, ny - row0);
  const int l = blockIdx.y;
  const int n_win = canvas1 ? 2 * B : B;
  for (int bc = blockIdx.z; bc < n_win; bc += gridDim.z) {
    const bool second = bc >= B;
    const int b = second ? bc - B : bc;
    const int y0 = clamp_corner(__ldg(pos + 2 * b), H - ny);
    const int x0 = clamp_corner(__ldg(pos + 2 * b + 1), W - nx);
    const float* src = (second ? canvas1 : canvas0) +
                       (static_cast<size_t>(l) * H + y0 + row0) * W + x0;
    float* dst = (second ? out1 : out0) +
                 (static_cast<size_t>(b) * L + l) * ny * nx + static_cast<size_t>(row0) * nx;
    if (vec) {
      // rows r and r + kWarps at once: eight loads in flight before a store
      const int nv = nx >> 2;
      for (int r = warp; r < rows; r += 2 * kWarps) {
        const bool two = r + kWarps < rows;
        const float* s0 = src + static_cast<size_t>(r) * W;
        const float* s1 = two ? s0 + static_cast<size_t>(kWarps) * W : s0;
        float4* d0 = reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * nx);
        float4* d1 = d0 + kWarps * nv;
        for (int v = lane; v < nv; v += 32) {
          const float* p0 = s0 + 4 * v;
          const float* p1 = s1 + 4 * v;
          const float4 f0 = make_float4(__ldg(p0), __ldg(p0 + 1), __ldg(p0 + 2), __ldg(p0 + 3));
          const float4 f1 = make_float4(__ldg(p1), __ldg(p1 + 1), __ldg(p1 + 2), __ldg(p1 + 3));
          __stcs(d0 + v, f0);
          if (two) __stcs(d1 + v, f1);
        }
      }
    } else {
      for (int r = warp; r < rows; r += kWarps) {
        const float* s = src + static_cast<size_t>(r) * W;
        float* d = dst + static_cast<size_t>(r) * nx;
        for (int x = lane; x < nx; x += 32) __stcs(d + x, __ldg(s + x));
      }
    }
  }
}

// grid (ceil(W / kTileCols), ceil(H / kTileRows), L * n_canvas)
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const float* __restrict__ patches0, const float* __restrict__ patches1,
                   const int* __restrict__ pos, float* __restrict__ canvas0,
                   float* __restrict__ canvas1, int B, int L, int H, int W, int ny, int nx) {
  __shared__ int2 corner[kChunk];  // clamped (y0, x0) of the chunk's windows
  __shared__ int hits[kChunk];     // the chunk's windows over this tile, ascending
  __shared__ int warp_hits[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool second = blockIdx.z >= L;
  const int l = second ? blockIdx.z - L : blockIdx.z;
  const float* patches = second ? patches1 : patches0;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const size_t plane = static_cast<size_t>(ny) * nx;

  float sum[kRowSums][kColSums];
#pragma unroll
  for (int r = 0; r < kRowSums; ++r)
#pragma unroll
    for (int j = 0; j < kColSums; ++j) sum[r][j] = 0.0f;

  for (int base = 0; base < B; base += kChunk) {
    const int n = min(kChunk, B - base);
    // the chunk's windows over this tile, compacted in ascending order
    int n_hits = 0;
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      bool over = false;
      if (i < n) {
        const int y0 = clamp_corner(__ldg(pos + 2 * (base + i)), H - ny);
        const int x0 = clamp_corner(__ldg(pos + 2 * (base + i) + 1), W - nx);
        corner[i] = make_int2(y0, x0);
        over = y0 < ty0 + kTileRows && y0 + ny > ty0 && x0 < tx0 + kTileCols && x0 + nx > tx0;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, over);
      if (lane == 0) warp_hits[warp] = __popc(ballot);
      __syncthreads();
      int before = n_hits, pass_hits = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_hits[w] : 0;
        pass_hits += warp_hits[w];
      }
      if (over) hits[before + __popc(ballot & ((1u << lane) - 1u))] = i;
      n_hits += pass_hits;
      __syncthreads();  // hits and corner complete; warp_hits free for the next pass
    }
    // a point outside the window loads nothing and adds +0.0f, which leaves
    // a sum's bits as they are (a sum that starts at +0 is never -0): the
    // loads stay free of branches, so all of a window's are in flight before
    // its adds
    for (int k = 0; k < n_hits; ++k) {
      const int i = hits[k];
      const int2 c = corner[i];
      const float* src = patches + (static_cast<size_t>(base + i) * L + l) * plane;
      const int dy = ty0 + warp - c.x, dx = tx0 + lane - c.y;
      float v[kRowSums][kColSums];
#pragma unroll
      for (int r = 0; r < kRowSums; ++r)
#pragma unroll
        for (int j = 0; j < kColSums; ++j) {
          const int py = dy + kWarps * r, px = dx + 32 * j;
          const bool in = static_cast<unsigned>(py) < static_cast<unsigned>(ny) &&
                          static_cast<unsigned>(px) < static_cast<unsigned>(nx);
          v[r][j] = in ? __ldg(src + (py * nx + px)) : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < kRowSums; ++r)
#pragma unroll
        for (int j = 0; j < kColSums; ++j) sum[r][j] += v[r][j];
    }
    __syncthreads();  // before the next chunk overwrites corner and hits
  }

  float* canvas = (second ? canvas1 : canvas0) + static_cast<size_t>(l) * H * W;
#pragma unroll
  for (int r = 0; r < kRowSums; ++r) {
    const int y = ty0 + warp + kWarps * r;
    if (y >= H) continue;
#pragma unroll
    for (int j = 0; j < kColSums; ++j) {
      const int x = tx0 + lane + 32 * j;
      if (x < W) canvas[static_cast<size_t>(y) * W + x] = sum[r][j];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* ptyrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// canvas0/1 (L, H, W) f32, pos (B, 2) int32, out0/1 (B, L, ny, nx) f32;
// canvas1 and out1 NULL for one canvas. L <= 65535.
int ptyrad_gather_patches(const float* canvas0, const float* canvas1, const int* pos,
                          float* out0, float* out1, int B, int L, int H, int W, int ny, int nx,
                          void* stream) {
  if (B == 0 || L == 0 || ny == 0 || nx == 0) return 0;
  const int n_win = canvas1 ? 2 * B : B;
  const int vec = nx % 4 == 0 && aligned16(out0) && (out1 == nullptr || aligned16(out1));
  const dim3 grid((ny + kGatherRows - 1) / kGatherRows, L, min(n_win, kMaxGridZ));
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      canvas0, canvas1, pos, out0, out1, B, L, H, W, ny, nx, vec);
  return static_cast<int>(cudaGetLastError());
}

// patches0/1 (B, L, ny, nx) f32, pos (B, 2) int32, canvas0/1 (L, H, W) f32,
// every element written; patches1 and canvas1 NULL for one canvas.
// L * n_canvas <= 65535.
int ptyrad_scatter_add_patches(const float* patches0, const float* patches1, const int* pos,
                               float* canvas0, float* canvas1, int B, int L, int H, int W,
                               int ny, int nx, void* stream) {
  if (L == 0 || H == 0 || W == 0) return 0;
  const dim3 grid((W + kTileCols - 1) / kTileCols, (H + kTileRows - 1) / kTileRows,
                  patches1 ? 2 * L : L);
  scatter_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      patches0, patches1, pos, canvas0, canvas1, B, L, H, W, ny, nx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
