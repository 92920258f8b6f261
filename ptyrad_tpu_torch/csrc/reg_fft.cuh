// Register line transforms of the chain kernels: chain.cu (B5, B6) runs the
// Stockham passes (line_fft), multislice.cu (B3, B4) the radix-2 pair
// (line_dif, line_dit, below). Both share the line layout (LinePlan), the
// twiddle table, the exchange policies and the set-up.
//
// An N-point line (N = 2 ... 512, a power of two) is held by TL = N / E
// threads, E = 16 points each (N itself below 16), thread t holding
// positions t + TL m (m < E) in registers. Stockham radix passes run there:
// N = 128 is 16 x 8, N = 256 16 x 16, N = 512 16 x 16 x 2. Each radix-R
// butterfly is an unrolled radix-2 network on compile-time indices; the
// only trip through shared memory is one exchange between two passes, at
// addresses an exchange policy (Ex) maps. The last pass leaves frequency
// t + TL m in the registers that held position t + TL m, so both transforms
// are natural order in and out.
//
// Pass twiddles exp(-2 pi i r k / (NS R)) come from a table in device memory
// (g_twiddle), filled once per device from double precision by
// prepare_once; each file that includes this header has its own table.
//
// An exchange policy provides store(a, x) and load(a) of line position a
// and sync(), which waits for the line's threads.
//
// kBf16 (the bfloat16 compute policy; a template flag of line_fft, line_dif
// and line_dit, false by default): the line's points are rounded to
// bfloat16 and back before the first stage, one rounding per 1-D pass, as
// the JAX kernels round each DFT pass's GEMM operand
// (ptyrad_tpu/ops/kernel_util.py:47-61 cpass). Butterflies and twiddles stay
// FP32; without the flag the code is what it was.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <mutex>
#include <type_traits>

#define REGFFT_TRY(expr)                        \
  do {                                          \
    const cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

namespace {
namespace regfft {

constexpr int kMaxDevices = 64;

// The pass twiddles exp(-2 pi i r k / M) of every pass that has them, M = NS R
// the size of the sub-transforms it completes: NS = 16 for M = 32 ... 256
// (the second pass of N = 32 ... 512) and NS = 256 for M = 512 (the third of
// N = 512). Pass M's table starts at M - 32 and holds entry (r, k) at r NS + k,
// so the threads of a line, which differ in k, read adjacent entries.
// After them, at kUnit + e, exp(-2 pi i e / 128) for e < 64: the twiddles of
// the radix-2 transforms (line_dif, line_dit) for every N <= 128.
constexpr int kUnit = 2 * 512 - 32;
constexpr int kTwEntries = kUnit + 64;
__device__ float2 g_twiddle[kTwEntries];

__host__ __device__ constexpr int twiddle_ns(int m) { return m == 512 ? 256 : 16; }

// How TL threads of E points transform an N-point line
template <int LOGN>
struct LinePlan {
  static constexpr int kN = 1 << LOGN;
  static constexpr int kLogE = LOGN < 4 ? LOGN : 4;
  static constexpr int kE = 1 << kLogE;            // points of a line per thread
  static constexpr int kLogTl = LOGN - kLogE;
  static constexpr int kTl = 1 << kLogTl;          // threads per line
  static constexpr int kPasses = (LOGN + 3) / 4;   // radix 16, ..., then the rest
  static constexpr int kR0 = kPasses == 1 ? kN : 16;
  static constexpr int kR1 = kPasses == 2 ? (kN >> 4) : 16;
  static constexpr int kR2 = kN >> 8;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

__host__ __device__ constexpr int bitrev_const(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((k >> i) & 1);
  return r;
}

// A compile-time index that converts to int in device code
template <int I>
struct Idx {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(Idx<i>) for i = I ... End - 1: register arrays indexed through it are
// indexed by constants, so they stay in registers
template <int I, int End, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < End) {
    f(Idx<I>{});
    static_for<I + 1, End>(f);
  }
}

// exp(-2 pi i k / 16), k < 8
__host__ __device__ constexpr float2 w16(int k) {
  constexpr float c1 = 0.923879532511286756f;  // cos(pi / 8)
  constexpr float s1 = 0.382683432365089772f;  // sin(pi / 8)
  constexpr float c2 = 0.707106781186547524f;  // cos(pi / 4)
  return k == 0   ? float2{1.0f, 0.0f}
         : k == 1 ? float2{c1, -s1}
         : k == 2 ? float2{c2, -c2}
         : k == 3 ? float2{s1, -c1}
         : k == 4 ? float2{0.0f, -1.0f}
         : k == 5 ? float2{-s1, -c1}
         : k == 6 ? float2{-c2, -c2}
                  : float2{-c1, -s1};
}

// d * exp(-2 pi i K / 16) (kInv: exp(+2 pi i K / 16)), K < 8
template <bool kInv, int K>
__device__ __forceinline__ float2 rot16(float2 d) {
  if constexpr (K == 0) {
    return d;
  } else if constexpr (K == 4) {
    return kInv ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  } else {
    constexpr float2 w = w16(K);
    return kInv ? cmul_conj(d, w) : cmul(d, w);
  }
}

// Unnormalised R-point DFT (kInv: inverse) of u in registers, natural order
// in and out: a radix-2 decimation-in-frequency network, then the
// bit-reversal as a renaming of registers.
template <int R, bool kInv>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  static_for<0, log2i(R)>([&](auto stage) {
    constexpr int len = R >> decltype(stage)::value;
    static_for<0, R / len>([&](auto blk) {
      static_for<0, len / 2>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        constexpr int i0 = decltype(blk)::value * len + j;
        const float2 a = u[i0];
        const float2 b = u[i0 + len / 2];
        u[i0] = make_float2(a.x + b.x, a.y + b.y);
        u[i0 + len / 2] = rot16<kInv, j * (16 / len)>(make_float2(a.x - b.x, a.y - b.y));
      });
    });
  });
  float2 tmp[R];
  static_for<0, R>([&](auto k) { tmp[k] = u[bitrev_const(decltype(k)::value, log2i(R))]; });
  static_for<0, R>([&](auto k) { u[k] = tmp[k]; });
}

// x rounded to bfloat16 (round to nearest even) and back
__device__ __forceinline__ float2 round_bf16(float2 x) {
  return make_float2(__bfloat162float(__float2bfloat16_rn(x.x)),
                     __bfloat162float(__float2bfloat16_rn(x.y)));
}

// The operand rounding of a pass under kBf16: every point of the line
template <bool kBf16, int E>
__device__ __forceinline__ void round_operand(float2 (&v)[E]) {
  if constexpr (kBf16) {
    static_for<0, E>([&](auto m) { v[m] = round_bf16(v[m]); });
  }
}

// A row's line in shared memory, padded (element a at a + a / 16); the
// row's threads share a warp.
struct RowExchange {
  float2* s;
  __device__ __forceinline__ void store(int a, float2 x) const { s[a + (a >> 4)] = x; }
  __device__ __forceinline__ float2 load(int a) const { return s[a + (a >> 4)]; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// The column tile: element a of column c at s[a * cols + c].
template <int LOGC>
struct ColExchange {
  float2* s;
  int c;
  __device__ __forceinline__ void store(int a, float2 x) const { s[(a << LOGC) + c] = x; }
  __device__ __forceinline__ float2 load(int a) const { return s[(a << LOGC) + c]; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// One Stockham radix-R pass over a line whose sub-transforms so far have
// NS points. The thread holds the pass's inputs at positions t + TL m in
// v[m]; butterfly j = t + q TL takes inputs j + r N / R = v[q + r E / R],
// twiddles them by exp(-2 pi i r (j mod NS) / (NS R)), transforms, and puts
// output r at (j / NS) NS R + (j mod NS) + r NS: through the exchange, read
// back at t + TL m for the next pass, or (kLast, where that position is
// t + TL (q + r E / R)) straight into v.
template <int LOGN, int R, int NS, bool kLast, bool kInv, class Ex>
__device__ __forceinline__ void stockham_pass(float2 (&v)[LinePlan<LOGN>::kE], int t,
                                              const Ex& ex) {
  using P = LinePlan<LOGN>;
  constexpr int kQ = P::kE / R;
  static_for<0, kQ>([&](auto qq) {
    constexpr int q = decltype(qq)::value;
    float2 u[R];
    static_for<0, R>([&](auto r) { u[r] = v[q + r * kQ]; });
    const int j = t + q * P::kTl;
    const int k = j & (NS - 1);
    if constexpr (NS > 1) {
      static_assert(twiddle_ns(NS * R) == NS, "a pass without its twiddle table");
      const float2* tw = g_twiddle + (NS * R - 32) + k;
      static_for<1, R>([&](auto r) {
        const float2 w = __ldg(tw + r * NS);
        u[r] = kInv ? cmul_conj(u[r], w) : cmul(u[r], w);
      });
    }
    dft<R, kInv>(u);
    if constexpr (kLast) {
      static_for<0, R>([&](auto r) { v[q + r * kQ] = u[r]; });
    } else {
      const int base = (j & ~(NS - 1)) * R + k;
      static_for<0, R>([&](auto r) { ex.store(base + r * NS, u[r]); });
    }
  });
  if constexpr (!kLast) {
    ex.sync();
    static_for<0, P::kE>([&](auto m) { v[m] = ex.load(t + m * P::kTl); });
    ex.sync();  // the next exchange may overwrite what this one read
  }
}

// Unnormalised N-point transform (kInv: inverse) of one line held by TL
// threads, natural order in and out (see LinePlan for the passes); kBf16:
// the points are rounded to bfloat16 first.
template <int LOGN, bool kInv, bool kBf16 = false, class Ex>
__device__ __forceinline__ void line_fft(float2 (&v)[LinePlan<LOGN>::kE], int t, const Ex& ex) {
  using P = LinePlan<LOGN>;
  round_operand<kBf16>(v);
  if constexpr (P::kPasses == 1) {
    stockham_pass<LOGN, P::kR0, 1, true, kInv>(v, t, ex);
  } else if constexpr (P::kPasses == 2) {
    stockham_pass<LOGN, P::kR0, 1, false, kInv>(v, t, ex);
    stockham_pass<LOGN, P::kR1, P::kR0, true, kInv>(v, t, ex);
  } else {
    stockham_pass<LOGN, P::kR0, 1, false, kInv>(v, t, ex);
    stockham_pass<LOGN, P::kR1, P::kR0, false, kInv>(v, t, ex);
    stockham_pass<LOGN, P::kR2, P::kR0 * P::kR1, true, kInv>(v, t, ex);
  }
}

// The radix-2 pair of B3/B4 (multislice.cu), N <= 128: decimation in
// frequency forward, its conjugate transpose (decimation in time,
// conjugate twiddles) inverse, so the inverse undoes the forward butterfly
// by butterfly. Their rounding is the arithmetic of in-place radix-2
// stages: the cotangents of a chain keep its exact identities, such as the
// invariance of |fft2(psi)|^2 under a global phase of H that the dz
// gradient cancels against, as well as such stages do. The TL threads of a
// line hold E points each at t + TL m and run the stages of span N/2 ... TL
// in registers; one exchange gives thread t the positions E t + i, where
// the stages of span TL/2 ... 1 run. The forward leaves in v[i] the
// frequency dif_freq(t, i) = bitrev(E t + i); the inverse takes that layout
// and ends with position t + TL m in v[m].

// exp(-2 pi i jj / (2 h)), 2 h <= 128
__device__ __forceinline__ float2 unit_twiddle(int jj, int h) {
  return __ldg(g_twiddle + kUnit + jj * (64 / h));
}

// The frequency that line_dif leaves in v[i] of thread t: bitrev(E t + i)
template <int LOGN>
__device__ __forceinline__ int dif_freq(int t, int i) {
  using P = LinePlan<LOGN>;
  const int tr = P::kLogTl > 0
                     ? static_cast<int>(__brev(static_cast<unsigned>(t)) >> (32 - P::kLogTl))
                     : 0;
  return bitrev_const(i, P::kLogE) * P::kTl + tr;
}

// Unnormalised forward transform of one line (see above). The exchange
// loads other threads' positions: the caller waits (ex.sync()) before it
// stores to the line's slots. kBf16: the points are rounded to bfloat16
// first.
template <int LOGN, bool kBf16 = false, class Ex>
__device__ __forceinline__ void line_dif(float2 (&v)[LinePlan<LOGN>::kE], int t, const Ex& ex) {
  using P = LinePlan<LOGN>;
  static_assert(P::kN <= 128 && P::kTl <= P::kE, "the radix-2 pair serves N <= 128");
  round_operand<kBf16>(v);
  // span h = hm TL: pairs (m, m + hm) of the thread's points, twiddle of
  // jj = (t + TL m) mod 2h
  static_for<0, P::kLogE>([&](auto s) {
    constexpr int hm = (P::kE >> 1) >> decltype(s)::value;
    static_for<0, P::kE>([&](auto mm) {
      constexpr int m = decltype(mm)::value;
      if constexpr ((m & hm) == 0) {
        const float2 a = v[m];
        const float2 b = v[m + hm];
        const float2 w = unit_twiddle(t + P::kTl * (m & (2 * hm - 1)), hm * P::kTl);
        v[m] = make_float2(a.x + b.x, a.y + b.y);
        v[m + hm] = cmul(make_float2(a.x - b.x, a.y - b.y), w);
      }
    });
  });
  if constexpr (P::kTl > 1) {
    ex.sync();  // the exchange overwrites slots other threads of the line loaded
    static_for<0, P::kE>([&](auto m) { ex.store(t + m * P::kTl, v[m]); });
    ex.sync();
    static_for<0, P::kE>([&](auto i) { v[i] = ex.load(P::kE * t + i); });
    // span h <= TL / 2 on positions E t + i: twiddle of jj = i mod h, a constant
    static_for<0, P::kLogTl>([&](auto s) {
      constexpr int h = (P::kTl >> 1) >> decltype(s)::value;
      static_for<0, P::kE>([&](auto ii) {
        constexpr int i = decltype(ii)::value;
        if constexpr ((i & h) == 0) {
          const float2 a = v[i];
          const float2 b = v[i + h];
          v[i] = make_float2(a.x + b.x, a.y + b.y);
          v[i + h] = rot16<false, (i & (h - 1)) * (8 / h)>(make_float2(a.x - b.x, a.y - b.y));
        }
      });
    });
  }
}

// Unnormalised inverse transform of one line, the conjugate transpose of
// line_dif: v[i] holds frequency dif_freq(t, i) on entry and position
// t + TL m in v[m] on return. kBf16: the points are rounded to bfloat16
// first.
template <int LOGN, bool kBf16 = false, class Ex>
__device__ __forceinline__ void line_dit(float2 (&v)[LinePlan<LOGN>::kE], int t, const Ex& ex) {
  using P = LinePlan<LOGN>;
  static_assert(P::kN <= 128 && P::kTl <= P::kE, "the radix-2 pair serves N <= 128");
  round_operand<kBf16>(v);
  if constexpr (P::kTl > 1) {
    static_for<0, P::kLogTl>([&](auto s) {
      constexpr int h = 1 << decltype(s)::value;
      static_for<0, P::kE>([&](auto ii) {
        constexpr int i = decltype(ii)::value;
        if constexpr ((i & h) == 0) {
          const float2 a = v[i];
          const float2 b = rot16<true, (i & (h - 1)) * (8 / h)>(v[i + h]);
          v[i] = make_float2(a.x + b.x, a.y + b.y);
          v[i + h] = make_float2(a.x - b.x, a.y - b.y);
        }
      });
    });
    ex.sync();  // the exchange overwrites slots other threads of the line loaded
    static_for<0, P::kE>([&](auto i) { ex.store(P::kE * t + i, v[i]); });
    ex.sync();
    static_for<0, P::kE>([&](auto m) { v[m] = ex.load(t + m * P::kTl); });
  }
  static_for<0, P::kLogE>([&](auto s) {
    constexpr int hm = 1 << decltype(s)::value;
    static_for<0, P::kE>([&](auto mm) {
      constexpr int m = decltype(mm)::value;
      if constexpr ((m & hm) == 0) {
        const float2 a = v[m];
        const float2 b =
            cmul_conj(v[m + hm], unit_twiddle(t + P::kTl * (m & (2 * hm - 1)), hm * P::kTl));
        v[m] = make_float2(a.x + b.x, a.y + b.y);
        v[m + hm] = make_float2(a.x - b.x, a.y - b.y);
      }
    });
  });
}

template <int L, int kMax, class F>
cudaError_t call_with_logn(F& f) {
  if constexpr (L <= kMax) {
    return f(std::integral_constant<int, L>{});
  } else {
    return cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<int, logn>) for logn = 1 ... kMax (kMax <= 9)
template <int kMax, class F>
cudaError_t with_logn(int logn, F&& f) {
  switch (logn) {
    case 1: return call_with_logn<1, kMax>(f);
    case 2: return call_with_logn<2, kMax>(f);
    case 3: return call_with_logn<3, kMax>(f);
    case 4: return call_with_logn<4, kMax>(f);
    case 5: return call_with_logn<5, kMax>(f);
    case 6: return call_with_logn<6, kMax>(f);
    case 7: return call_with_logn<7, kMax>(f);
    case 8: return call_with_logn<8, kMax>(f);
    case 9: return call_with_logn<9, kMax>(f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// This file's twiddle table on the current device, from double precision
inline cudaError_t upload_twiddles() {
  constexpr double kPi = 3.14159265358979323846;
  float2 host[kTwEntries];
  for (int m = 32; m <= 512; m *= 2) {
    const int ns = twiddle_ns(m);
    for (int r = 0; r < m / ns; ++r) {
      for (int k = 0; k < ns; ++k) {
        const double ang = -2.0 * kPi * r * k / m;
        host[m - 32 + r * ns + k] =
            make_float2(static_cast<float>(std::cos(ang)), static_cast<float>(std::sin(ang)));
      }
    }
  }
  for (int e = 0; e < 64; ++e) {
    const double ang = -2.0 * kPi * e / 128;
    host[kUnit + e] =
        make_float2(static_cast<float>(std::cos(ang)), static_cast<float>(std::sin(ang)));
  }
  host[kUnit + 32] = make_float2(0.0f, -1.0f);  // exact, as the twiddle 1 of e = 0 is
  REGFFT_TRY(cudaMemcpyToSymbol(g_twiddle, host, sizeof(host)));
  return cudaDeviceSynchronize();  // later streams see the table
}

// Set-up once per (device, log2 N) of the including file: its twiddle table
// (once per device), then set(logn), which sets its kernels' shared-memory
// limits for that N. After it a launch checks one flag and does no set-up,
// so a caller that warms up every N first can capture the launches in a
// CUDA graph.
template <int kMaxLogN, class F>
cudaError_t prepare_once(int logn, F&& set) {
  static std::atomic<bool> done[kMaxDevices][kMaxLogN + 1];
  static std::mutex mu;
  static bool twiddles[kMaxDevices] = {};
  if (logn < 1 || logn > kMaxLogN) return cudaErrorInvalidValue;
  int dev = 0;
  REGFFT_TRY(cudaGetDevice(&dev));
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev][logn].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev][logn].load(std::memory_order_relaxed)) return cudaSuccess;
  if (!twiddles[dev]) {
    REGFFT_TRY(upload_twiddles());
    twiddles[dev] = true;
  }
  REGFFT_TRY(set(logn));
  done[dev][logn].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace regfft
}  // namespace
