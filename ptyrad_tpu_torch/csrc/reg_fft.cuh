// Register line transforms of the chain kernels: chain.cu (B5, B6) runs the
// Stockham passes (line_fft) at N a power of two, multislice.cu (B3, B4) the
// radix-2 pair (line_dif, line_dit, below) there; both run the mixed-radix
// pair (line_dif_mr, line_dit_mr, further below) at any other N, up to 128
// in multislice.cu and in (128, 512] in chain.cu, where a build of either may
// wrap an M-point mixed-radix line in a Bluestein line (line_dif_bl,
// line_dit_bl; PTYRAD_BLUESTEIN builds only). The first three share the line layout
// (LinePlan), the twiddle table, the exchange policies and the set-up.
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
#include <tuple>
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

// The column tile: element a of column c at s[a * cols + c]. It serves a
// mixed-radix line too (chain.cu's mixed build: 16 columns of T threads):
// each thread stores and loads its own column's slots only, so a column
// past N (its threads idle) writes nothing another column reads, and a
// half-warp's 16 columns of one row are 128 adjacent bytes.
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

// The mixed-radix pair of B3/B4 (multislice.cu, N <= 128) and of B5/B6
// (chain.cu, N in (128, 512]) at N that is not a power of two
// (ptyrad_tpu_torch/ops/fused_plan.py and ops/chain_plan.py choose the
// plans and document them; the file is built once per such N with its
// plan as macros). The
// N-point transform is an in-place decimation in frequency with one stage
// per prime factor of N; the inverse is its conjugate transpose, stage by
// stage backwards (conjugate twiddles first, then the conjugate
// butterfly), as line_dit is line_dif's. The stages run in passes:
// a register pass (Pass<false, r...>, radices 2, 3, 5, 7) on whole
// cosets: its radices multiply to R, the N / R cosets are the positions
// that differ only in its digits, and thread t of the line's T holds the
// cosets t + T u (u < c, while below N / R), point D of slot u in register
// u + c D. An N with a prime factor above 7 takes a Bluestein line (below)
// over such passes.
// Between two passes the line goes through its slots once (store, sync,
// load). The forward leaves frequency
// digitrev(position) in each register of the last pass's layout (freq);
// the inverse takes that layout and ends in the first pass's (pos), the
// layout of a line's points. Registers past a pass's, and slots past its
// cosets, hold nothing (ok() is false there).

#ifdef PTYRAD_BLUESTEIN
constexpr int kMaxMixedN = 1024;  // the M-point line inside a Bluestein line (below)
#else
constexpr int kMaxMixedN = 512;
#endif
// exp(-2 pi i e / N) for e < N of the including file's mixed-radix N
// (upload_mixed): every twiddle of the pair, W_M^x = W_N^(x N / M)
__device__ float2 g_mixed[kMaxMixedN];

// A register pass of radices R; the flag is false (the plan sources of
// ops/fused_plan.py and ops/chain_plan.py spell a pass Pass<false, r...>)
template <bool kSum, int... R>
struct Pass {
  static_assert(!kSum, "every pass is a register pass");
  static constexpr int kStages = sizeof...(R);
  static constexpr int kProd = (R * ... * 1);
  __host__ __device__ static constexpr int radix(int s) {
    constexpr int r[] = {R...};
    return r[s];
  }
};

// The unrolled butterflies' constants cos(2 pi m / r), sin(2 pi m / r), m <= (r - 1) / 2
template <int r>
__host__ __device__ constexpr float cos_r(int m) {
  if constexpr (r == 3) {
    return -0.5f;
  } else if constexpr (r == 5) {
    return m == 1 ? 0.309016994374947424f : -0.809016994374947424f;
  } else {
    return m == 1 ? 0.623489801858733531f : m == 2 ? -0.222520933956314404f
                                                   : -0.900968867902419126f;
  }
}

template <int r>
__host__ __device__ constexpr float sin_r(int m) {
  if constexpr (r == 3) {
    return 0.866025403784438647f;
  } else if constexpr (r == 5) {
    return m == 1 ? 0.951056516295153572f : 0.587785252292473129f;
  } else {
    return m == 1 ? 0.781831482468029809f : m == 2 ? 0.974927912181823607f
                                                   : 0.433883739117558120f;
  }
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Unnormalised r-point DFT (kInv: the inverse, its conjugate) of x, natural
// order in and out, r = 2, 3, 5, 7: for odd r the conjugate-symmetric
// pairs, y_q = x_0 + sum_k cos(2 pi q k / r) (x_k + x_{r-k})
//             -/+ i sum_k sin(2 pi q k / r) (x_k - x_{r-k}).
template <int r, bool kInv>
__device__ __forceinline__ void small_dft(float2 (&x)[r]) {
  if constexpr (r == 2) {
    const float2 a = x[0];
    x[0] = cadd(a, x[1]);
    x[1] = csub(a, x[1]);
  } else {
    constexpr int h = (r - 1) / 2;
    float2 sp[h], dm[h];
    static_for<0, h>([&](auto kk) {
      constexpr int k = decltype(kk)::value + 1;
      sp[k - 1] = cadd(x[k], x[r - k]);
      dm[k - 1] = csub(x[k], x[r - k]);
    });
    float2 y0 = x[0];
    static_for<0, h>([&](auto k) { y0 = cadd(y0, sp[k]); });
    static_for<0, h>([&](auto qq) {
      constexpr int q = decltype(qq)::value + 1;
      float2 a = x[0];
      float2 b = make_float2(0.0f, 0.0f);
      static_for<0, h>([&](auto kk) {
        constexpr int k = decltype(kk)::value + 1;
        constexpr int m = (q * k) % r;
        constexpr float c = cos_r<r>(m <= h ? m : r - m);
        constexpr float s = m <= h ? sin_r<r>(m) : -sin_r<r>(r - m);
        a = make_float2(a.x + c * sp[k - 1].x, a.y + c * sp[k - 1].y);
        b = make_float2(b.x + s * dm[k - 1].x, b.y + s * dm[k - 1].y);
      });
      // forward y_q = a - i b, y_{r-q} = a + i b; the inverse the other way
      const float2 minus = make_float2(a.x + b.y, a.y - b.x);
      const float2 plus = make_float2(a.x - b.y, a.y + b.x);
      x[q] = kInv ? plus : minus;
      x[r - q] = kInv ? minus : plus;
    });
    x[0] = y0;
  }
}

// The compile-time arithmetic of a mixed-radix line (MixedLine below): a
// base of its own, so the line's constants can call it
template <int N, int T, class... Ps>
struct MixedBase {
  static constexpr int kPasses = sizeof...(Ps);
  static constexpr int kStages = (Ps::kStages + ... + 0);

  __host__ __device__ static constexpr int prod(int k) {
    constexpr int p[] = {Ps::kProd...};
    return p[k];
  }
  // radix of stage g of the whole transform
  __host__ __device__ static constexpr int stage_radix(int g) {
    int out = 0, base = 0;
    ((g >= base && g < base + Ps::kStages ? (out = Ps::radix(g - base), 0) : 0,
      base += Ps::kStages), ...);
    return out;
  }
  __host__ __device__ static constexpr int first_stage(int k) {
    int g = 0;
    for (int i = 0; i < k; ++i) g += stages(i);
    return g;
  }
  __host__ __device__ static constexpr int stages(int k) {
    constexpr int s[] = {Ps::kStages...};
    return s[k];
  }
  // the product of the earlier passes' radices, the span below pass k
  // (N / (H R)), its cosets and the coset slots of a thread
  __host__ __device__ static constexpr int high(int k) {
    int h = 1;
    for (int i = 0; i < k; ++i) h *= prod(i);
    return h;
  }
  __host__ __device__ static constexpr int span(int k) { return N / (high(k) * prod(k)); }
  __host__ __device__ static constexpr int cosets(int k) { return N / prod(k); }
  __host__ __device__ static constexpr int slots(int k) {
    return (cosets(k) + T - 1) / T;
  }
  __host__ __device__ static constexpr int pass_elems(int k) { return slots(k) * prod(k); }
  __host__ __device__ static constexpr int max_elems() {
    int e = 0;
    for (int k = 0; k < kPasses; ++k) e = pass_elems(k) > e ? pass_elems(k) : e;
    return e;
  }
  __host__ __device__ static constexpr int sub_prod(int s0, int s1) {
    int p = 1;
    for (int g = s0; g < s1; ++g) p *= stage_radix(g);
    return p;
  }
  __host__ __device__ static constexpr int digitrev_const(int x, int s0, int s1) {
    int f = 0;
    for (int g = s0; g < s1; ++g) f += (x / sub_prod(g + 1, s1)) % stage_radix(g) * sub_prod(s0, g);
    return f;
  }
};

// How T threads transform an N-point line with the passes Ps (see above)
template <int N, int T, class... Ps>
struct MixedLine : MixedBase<N, T, Ps...> {
  using Base = MixedBase<N, T, Ps...>;
  using Base::cosets, Base::digitrev_const, Base::first_stage, Base::high, Base::prod,
      Base::slots, Base::span, Base::stage_radix, Base::sub_prod;
  static constexpr int kN = N, kTl = T, kPasses = Base::kPasses, kStages = Base::kStages;
  static constexpr int kSlots = N;  // the line's slots an exchange uses
  template <int k>
  using PassAt = std::tuple_element_t<k, std::tuple<Ps...>>;
  static constexpr int kE = Base::max_elems();
  static constexpr int kExchanges = kPasses - 1;
  // whether a transform reads slots other threads of the line wrote
  static constexpr bool kReadsSlots = kExchanges > 0 && T > 1;
  static_assert(Base::high(kPasses) == N, "the passes' radices must multiply to N");
  static_assert(kE <= 32 && T <= 32, "a mixed-radix plan out of its register budget");

  // register m of pass k's layout: the line position it holds, and whether it holds one
  template <int k, int m>
  __device__ __forceinline__ static int pos(int t) {
    constexpr int c = slots(k), u = m % c, d = m / c, l = span(k), r = prod(k);
    const int kappa = t + T * u;
    if constexpr (l == 1) {
      return kappa * r + d;
    } else {
      return (kappa / l) * r * l + d * l + kappa % l;
    }
  }
  template <int k, int m>
  __device__ __forceinline__ static bool ok(int t) {
    constexpr int c = slots(k), u = m % c, d = m / c;
    if constexpr (d >= prod(k)) {
      return false;
    } else if constexpr (T * (u + 1) <= cosets(k)) {
      return true;
    } else {
      return t + T * u < cosets(k);
    }
  }
  // x's digits in the radices of stages [s0, s1) (the first most
  // significant), reversed: digit g weighs the product of the radices before it
  template <int s0, int s1>
  __device__ __forceinline__ static int digitrev(int x) {
    int f = 0;
    static_for<s0, s1>([&](auto gg) {
      constexpr int g = decltype(gg)::value;
      constexpr int below = sub_prod(g + 1, s1), weight = sub_prod(s0, g);
      f += (x / below) % stage_radix(g) * weight;
    });
    return f;
  }
  // the frequency the forward leaves in register m of thread t
  template <int m>
  __device__ __forceinline__ static int freq(int t) {
    constexpr int k = kPasses - 1;
    constexpr int c = slots(k), u = m % c, d = m / c;
    constexpr int lo = high(k) * digitrev_const(d < prod(k) ? d : 0, first_stage(k), kStages);
    if constexpr (k == 0) {
      return lo;
    } else {
      return digitrev<0, first_stage(k)>(t + T * u) + lo;
    }
  }
};

__device__ __forceinline__ float2 mixed_twiddle(int e) { return __ldg(g_mixed + e); }

// The product of pass P's radices from stage s on
template <class P>
__host__ __device__ constexpr int pass_suffix(int s) {
  int p = 1;
  for (int i = s; i < P::kStages; ++i) p *= P::radix(i);
  return p;
}

// Thread t's registers of pass k's layout to and from the line's slots
template <class Line, int k, class Ex>
__device__ __forceinline__ void mr_store(const float2 (&v)[Line::kE], int t, const Ex& ex) {
  static_for<0, Line::kE>([&](auto mm) {
    constexpr int m = decltype(mm)::value;
    if (Line::template ok<k, m>(t)) ex.store(Line::template pos<k, m>(t), v[m]);
  });
}

template <class Line, int k, class Ex>
__device__ __forceinline__ void mr_load(float2 (&v)[Line::kE], int t, const Ex& ex) {
  static_for<0, Line::kE>([&](auto mm) {
    constexpr int m = decltype(mm)::value;
    if (Line::template ok<k, m>(t)) v[m] = ex.load(Line::template pos<k, m>(t));
  });
}

// The stages of register pass k on thread t's cosets: forward, stage by
// stage, the butterfly then the twiddles W_M^(j q) (M the stage's
// sub-transform, j the offset below its span); kInv: the conjugate
// transpose, stages backwards, conjugate twiddles then the conjugate butterfly
template <class Line, int k, bool kInv>
__device__ __forceinline__ void mr_stages(float2 (&v)[Line::kE], int t) {
  using P = typename Line::template PassAt<k>;
  constexpr int c = Line::slots(k), l = Line::span(k), R = P::kProd, T = Line::kTl;
  static_for<0, c>([&](auto uu) {
    constexpr int u = decltype(uu)::value;
    const int kappa = t + T * u;
    if constexpr (T * (u + 1) > Line::cosets(k)) {
      if (kappa >= Line::cosets(k)) return;
    }
    const int below = l == 1 ? 0 : kappa % l;  // the coset's offset below the pass's span
    static_for<0, P::kStages>([&](auto ss) {
      constexpr int s = kInv ? P::kStages - 1 - decltype(ss)::value : decltype(ss)::value;
      constexpr int r = P::radix(s);
      constexpr int S = pass_suffix<P>(s + 1);  // the pass's digits after stage s, in points of D
      constexpr int step = Line::kN / (r * S * l);  // N / M of the stage's sub-transform
      static_for<0, R / (r * S)>([&](auto hh) {
        constexpr int hi = decltype(hh)::value;
        static_for<0, S>([&](auto ll) {
          constexpr int lo = decltype(ll)::value;
          constexpr int d0 = hi * r * S + lo;
          const int j = lo * l + below;
          float2 x[r];
          static_for<0, r>([&](auto d) { x[d] = v[u + c * (d0 + d * S)]; });
          if constexpr (kInv) {
            static_for<1, r>([&](auto q) {
              if constexpr (l == 1) {
                constexpr int e = lo * decltype(q)::value * step;
                if constexpr (e != 0) x[q] = cmul_conj(x[q], mixed_twiddle(e));
              } else {
                x[q] = cmul_conj(x[q], mixed_twiddle(j * decltype(q)::value * step));
              }
            });
            small_dft<r, true>(x);
          } else {
            small_dft<r, false>(x);
            static_for<1, r>([&](auto q) {
              if constexpr (l == 1) {
                constexpr int e = lo * decltype(q)::value * step;
                if constexpr (e != 0) x[q] = cmul(x[q], mixed_twiddle(e));
              } else {
                x[q] = cmul(x[q], mixed_twiddle(j * decltype(q)::value * step));
              }
            });
          }
          static_for<0, r>([&](auto d) { v[u + c * (d0 + d * S)] = x[d]; });
        });
      });
    });
  });
}

// Unnormalised forward transform of one line with the mixed-radix pair:
// v in the first pass's layout (the line's points) on entry, frequency
// Line::freq in each register on return. The exchange loads other threads'
// positions: the caller waits (ex.sync()) before it stores to the line's
// slots when Line::kReadsSlots. kBf16: the points are rounded to bfloat16
// first.
template <class Line, bool kBf16 = false, class Ex>
__device__ __forceinline__ void line_dif_mr(float2 (&v)[Line::kE], int t, const Ex& ex) {
  round_operand<kBf16>(v);
  static_for<0, Line::kPasses>([&](auto kk) {
    constexpr int k = decltype(kk)::value;
    if constexpr (k > 0) {
      if constexpr (Line::kTl > 1) ex.sync();  // slots other threads may still read
      mr_store<Line, (k > 0 ? k - 1 : 0)>(v, t, ex);
      if constexpr (Line::kTl > 1) ex.sync();
      mr_load<Line, k>(v, t, ex);
    }
    mr_stages<Line, k, false>(v, t);
  });
}

// Unnormalised inverse transform, the conjugate transpose of line_dif_mr:
// frequency Line::freq in each register on entry, the first pass's layout
// on return. kBf16: the points are rounded to bfloat16 first.
template <class Line, bool kBf16 = false, class Ex>
__device__ __forceinline__ void line_dit_mr(float2 (&v)[Line::kE], int t, const Ex& ex) {
  round_operand<kBf16>(v);
  static_for<0, Line::kPasses>([&](auto kk) {
    constexpr int k = Line::kPasses - 1 - decltype(kk)::value;
    if constexpr (k < Line::kPasses - 1) {
      if constexpr (Line::kTl > 1) ex.sync();
      mr_store<Line, (k < Line::kPasses - 1 ? k + 1 : k)>(v, t, ex);
      if constexpr (Line::kTl > 1) ex.sync();
      mr_load<Line, k>(v, t, ex);
    }
    mr_stages<Line, k, true>(v, t);
  });
}

// The twiddles of the mixed-radix pair at N on the current device
inline cudaError_t upload_mixed(int n) {
  constexpr double kPi = 3.14159265358979323846;
  if (n < 2 || n > kMaxMixedN) return cudaErrorInvalidValue;
  float2 host[kMaxMixedN] = {};
  for (int e = 0; e < n; ++e) {
    const double ang = -2.0 * kPi * e / n;
    host[e] = make_float2(static_cast<float>(std::cos(ang)), static_cast<float>(std::sin(ang)));
  }
  REGFFT_TRY(cudaMemcpyToSymbol(g_mixed, host, sizeof(host)));
  return cudaDeviceSynchronize();
}

#ifdef PTYRAD_BLUESTEIN
// The Bluestein line of chain.cu's and multislice.cu's mixed builds
// (PTYRAD_BLUESTEIN defined): an N-point line whose prime factors include one
// above 7 (ops/chain_plan.py, ops/fused_plan.py plan such N on it). Bluestein's chirp-z
// identity, with c_j = exp(-i pi j^2 / N),
//   X_k = c_k sum_j (x_j c_j) conj(c_(k-j)),
// is a cyclic convolution over M >= 2 N - 1 points (M 7-smooth), done by an
// M-point mixed-radix line (Inner, register passes only) and its conjugate
// transpose: the line's points times the chirp, zero past N; the inner
// forward (line_dif_mr); times the filter, the spectrum of
// g_j = conj(c_|j|) (|j| < N, cyclic over M) over M at the positions the
// inner forward leaves its frequencies; the inner inverse (line_dit_mr),
// which ends in the first pass's layout; points below N times the chirp.
// The spectrum comes out in natural order in the layout the points went in
// (kPasses = 1: the points' layout is the spectrum's, freq = pos). The
// inverse runs the same steps with the conjugate chirp and filter: step by
// step the conjugate transpose of the forward (the crop's adjoint is the
// pad, the inner inverse's adjoint the inner forward). O(M log M) a line
// against a direct sum's O(N p). Under kBf16 the inner forward's operand
// is rounded, once a transform as every other line rounds; the chirp and
// filter products and the inner inverse stay FP32.

constexpr int kMaxBluesteinN = 512;
// c_j = exp(-i pi (j^2 mod 2N) / N) for j < N
__device__ float2 g_chirp[kMaxBluesteinN];
// the filter (above) over M, divided by M, at inner position p: frequency digitrev(p)
__device__ float2 g_filter[kMaxMixedN];

template <int N, class Inner>
struct BluesteinLine {
  using In = Inner;
  static constexpr int kN = N, kTl = In::kTl, kE = In::kE, kSlots = In::kN;
  static constexpr int kPasses = 1, kStages = In::kStages;
  static constexpr bool kReadsSlots = In::kReadsSlots;
  static_assert(kSlots >= 2 * N - 1, "a Bluestein convolution of fewer than 2 N - 1 points");

  // the position inner register m of layout 0 holds in thread t (point d of
  // coset slot u: d * span + t + T u), the least at t = 0, the largest at T - 1
  template <int m>
  __host__ __device__ static constexpr int position(int t) {
    constexpr int c = In::slots(0);
    return (m / c) * In::span(0) + t + kTl * (m % c);
  }
  template <int k, int m>
  __device__ __forceinline__ static int pos(int t) {
    return In::template pos<0, m>(t);
  }
  // register m holds a point of the line: a valid inner register below N
  template <int k, int m>
  __device__ __forceinline__ static bool ok(int t) {
    if constexpr (m / In::slots(0) >= In::prod(0) || position<m>(0) >= N) {
      return false;
    } else if constexpr (position<m>(kTl - 1) < N) {
      return In::template ok<0, m>(t);
    } else {
      return In::template ok<0, m>(t) && position<m>(t) < N;
    }
  }
  template <int m>
  __device__ __forceinline__ static int freq(int t) {
    return position<m>(t);
  }
};

// The Bluestein transform of one line (kInv: its inverse, the conjugate
// transpose), the line's points in v in and its spectrum out (same layout,
// natural order); registers that hold no point end as zero.
template <class Line, bool kInv, bool kBf16, class Ex>
__device__ __forceinline__ void bluestein(float2 (&v)[Line::kE], int t, const Ex& ex) {
  using In = typename Line::In;
  auto chirp = [&](auto mm) {
    constexpr int m = decltype(mm)::value;
    if (Line::template ok<0, m>(t)) {
      const float2 c = __ldg(g_chirp + Line::template position<m>(t));
      v[m] = kInv ? cmul_conj(v[m], c) : cmul(v[m], c);
    } else {
      v[m] = make_float2(0.0f, 0.0f);
    }
  };
  static_for<0, Line::kE>(chirp);
  line_dif_mr<In, kBf16>(v, t, ex);
  static_for<0, In::kE>([&](auto mm) {
    constexpr int m = decltype(mm)::value;
    if (In::template ok<In::kPasses - 1, m>(t)) {
      const float2 f = __ldg(g_filter + In::template pos<In::kPasses - 1, m>(t));
      v[m] = kInv ? cmul_conj(v[m], f) : cmul(v[m], f);
    }
  });
  line_dit_mr<In, false>(v, t, ex);
  static_for<0, Line::kE>(chirp);
}

template <class Line, bool kBf16 = false, class Ex>
__device__ __forceinline__ void line_dif_bl(float2 (&v)[Line::kE], int t, const Ex& ex) {
  bluestein<Line, false, kBf16>(v, t, ex);
}

template <class Line, bool kBf16 = false, class Ex>
__device__ __forceinline__ void line_dit_bl(float2 (&v)[Line::kE], int t, const Ex& ex) {
  bluestein<Line, true, kBf16>(v, t, ex);
}

// The Bluestein line's tables on the current device: the inner line's
// twiddles (upload_mixed at M), the chirp and the filter, each computed in
// double precision and rounded once to float32. The chirp's angle takes
// j^2 mod 2N in integers.
template <class Line>
cudaError_t upload_bluestein() {
  using In = typename Line::In;
  constexpr int n = Line::kN, m = In::kN;
  constexpr double kPi = 3.14159265358979323846;
  static_assert(n <= kMaxBluesteinN && m <= kMaxMixedN, "a Bluestein line past its tables");
  REGFFT_TRY(upload_mixed(m));
  double cr[kMaxBluesteinN], ci[kMaxBluesteinN], wr[kMaxMixedN], wi[kMaxMixedN];
  float2 chirp[kMaxBluesteinN], filter[kMaxMixedN];
  for (int j = 0; j < n; ++j) {
    const long long q = static_cast<long long>(j) * j % (2LL * n);
    cr[j] = std::cos(-kPi * static_cast<double>(q) / n);
    ci[j] = std::sin(-kPi * static_cast<double>(q) / n);
    chirp[j] = make_float2(static_cast<float>(cr[j]), static_cast<float>(ci[j]));
  }
  for (int e = 0; e < m; ++e) {
    wr[e] = std::cos(-2.0 * kPi * e / m);
    wi[e] = std::sin(-2.0 * kPi * e / m);
  }
  for (int p = 0; p < m; ++p) {
    // frequency f of g: sum over |j| < N of conj(c_|j|) exp(-2 pi i j f / M)
    const int f = In::digitrev_const(p, 0, In::kStages);
    double sr = 0.0, si = 0.0;
    for (int j = 1 - n; j < n; ++j) {
      const int a = j < 0 ? -j : j;
      const int e = static_cast<int>((static_cast<long long>(j + m) * f) % m);
      sr += cr[a] * wr[e] + ci[a] * wi[e];  // conj(c) w
      si += cr[a] * wi[e] - ci[a] * wr[e];
    }
    filter[p] = make_float2(static_cast<float>(sr / m), static_cast<float>(si / m));
  }
  REGFFT_TRY(cudaMemcpyToSymbol(g_chirp, chirp, sizeof(float2) * n));
  REGFFT_TRY(cudaMemcpyToSymbol(g_filter, filter, sizeof(float2) * m));
  return cudaDeviceSynchronize();
}
#endif  // PTYRAD_BLUESTEIN

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

// The pixel arithmetic of an N x N field for the elementwise kernels: N a
// power of two (shifts by logn2 = 2 log2 N) or a compile-time N^2 = NN
struct Pow2Pix {
  int logn2;
  __host__ __device__ size_t nn() const { return size_t(1) << logn2; }
  __host__ __device__ size_t div(size_t t) const { return t >> logn2; }
  __host__ __device__ size_t mod(size_t t) const { return t & (nn() - 1); }
};

template <int NN>
struct FixedPix {
  __host__ __device__ constexpr size_t nn() const { return NN; }
  __host__ __device__ size_t div(size_t t) const { return t / NN; }
  __host__ __device__ size_t mod(size_t t) const { return t % NN; }
};

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
