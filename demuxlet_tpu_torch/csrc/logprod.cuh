// A sum of logs kept as a product: the accumulators of the exact pair
// kernels K3' (pair_exact.cu) and K7' (pair_tiled_exact.cu).
//
// sum_s log(x_s) over one lane's slots is kept as m * 2^e: an f64 mantissa
// m in [1, 2) and an int exponent e. Each step multiplies m by x and moves
// the product's exponent field into e (bit operations on the high word, no
// log), so a channel takes one log per lane at the end instead of one per
// slot. This is the TPU kernels' df32 product with exponent tracking
// (demuxlet_tpu/ops/pallas_pair_exact.py: _renorm, the stacked product
// accumulators of _pair_kernel_df, _log_mantissa) in native f64.
//
// Renormalised at every step, and without a branch: an x in the safe range
// [2^-1022, 2^1022) gives a positive normal product whatever m in [1, 2)
// is, so no floor on x is assumed. Any other x (0, subnormal, huge, inf,
// NaN, negative) multiplies in 1 instead and the step reports it; the
// kernels then take the rare path `fix` for the whole warp (a vote per
// slot): a positive subnormal or huge x is split by frexp and multiplied in
// exactly, and 0, inf and NaN (or x < 0) set the channel's bit in one of
// three masks, so the lane's sum ends at -inf, +inf or NaN as the plain
// version's sum of logs does (-inf and +inf together give NaN). A masked
// slot's x == 1 leaves m and e unchanged, so a lane of padding ends at
// log(1) + 0 == 0 exactly.
//
// The exponent: |e| grows by at most 1075 per step, so int32 holds any
// lane of at most kMaxSteps steps (the kernels refuse longer rows).

#pragma once

#include <cuda_runtime.h>

namespace dmx {

constexpr int kMaxSteps = 1 << 20;  // 2^20 * 1075 < 2^31

// ln 2 = kLn2Hi + kLn2Lo; kLn2Hi has 32 significant bits, so e * kLn2Hi is
// exact for |e| < 2^21 (10^5 steps of x ~ 1e-6): nothing is lost at
// |e| ~ 10^5.
constexpr double kLn2Hi = 6.93147180369123816490e-01;
constexpr double kLn2Lo = 1.90821492927058770002e-10;

// x in [2^-1022, 2^1022): its high word in [0x00100000, 0x7fc00000)
__device__ __forceinline__ bool lp_safe(double x) {
  return static_cast<unsigned>(__double2hiint(x) - 0x00100000) < 0x7fb00000u;
}

// One step: m * x renormalised if x is safe, else m * 1; returns
// lp_safe(x). No branch: the kernels vote once per slot and take lp_fix
// for the whole warp when a lane met an unsafe x.
__device__ __forceinline__ bool lp_step(double& m, int& e, double x) {
  const bool safe = lp_safe(x);
  const double p = m * (safe ? x : 1.0);
  const int hp = __double2hiint(p);
  e += (hp >> 20) - 1023;
  m = __hiloint2double((hp & 0x000fffff) | 0x3ff00000, __double2loint(p));
  return safe;
}

// The rare path for an x that lp_step left out (nothing if x is safe).
__device__ __forceinline__ void lp_fix(double& m, int& e, unsigned& zero,
                                       unsigned& inf, unsigned& nan,
                                       unsigned bit, double x) {
  if (lp_safe(x)) return;
  if (x > 0.0 && x <= 1.7976931348623157e308) {
    // subnormal or huge: x = f 2^k exactly, f in [0.5, 1), so the product
    // m f lies in [0.5, 2)
    int k;
    const double p = m * frexp(x, &k);
    const int hp = __double2hiint(p);
    e += k + (hp >> 20) - 1023;
    m = __hiloint2double((hp & 0x000fffff) | 0x3ff00000, __double2loint(p));
  } else if (x == 0.0) {
    zero |= bit;
  } else if (x > 0.0) {
    inf |= bit;
  } else {
    nan |= bit;  // NaN or x < 0
  }
}

// A lane's sum of logs: log(m) + e ln 2, or -inf, +inf, NaN.
__device__ __forceinline__ double lp_sum(double m, int e, unsigned zero,
                                         unsigned inf, unsigned nan,
                                         unsigned bit) {
  if ((nan & bit) || (zero & inf & bit)) {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  if (zero & bit) return -__longlong_as_double(0x7ff0000000000000LL);
  if (inf & bit) return __longlong_as_double(0x7ff0000000000000LL);
  const double ed = static_cast<double>(e);
  return fma(ed, kLn2Hi, fma(ed, kLn2Lo, log(m)));
}

// N product accumulators of one thread in registers: every index is a
// compile-time constant once the kernels' loops are unrolled.
template <int N>
struct Acc {
  static_assert(N <= 32, "one bit per accumulator in the masks");
  double m[N];
  int e[N];
  unsigned zero, inf, nan;  // channels that met x == 0, inf, NaN (or < 0)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      m[i] = 1.0;
      e[i] = 0;
    }
    zero = inf = nan = 0u;
  }
  __device__ __forceinline__ bool step(int i, double x) {
    return lp_step(m[i], e[i], x);
  }
  __device__ __forceinline__ void fix(int i, double x) {
    lp_fix(m[i], e[i], zero, inf, nan, 1u << i, x);
  }
  __device__ __forceinline__ double log_sum(int i) const {
    return lp_sum(m[i], e[i], zero, inf, nan, 1u << i);
  }
};

// N accumulators of one thread in shared memory, stored so that a warp's
// lanes touch consecutive words: accumulator i of thread t at m[i * T + t]
// (T threads; masks: zero, inf, nan at [k * T + t]).
template <int N>
struct SharedAcc {
  double* m;
  int* e;
  unsigned* masks;
  int T;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      m[i * T] = 1.0;
      e[i * T] = 0;
    }
    masks[0] = masks[T] = masks[2 * T] = 0u;
  }
  __device__ __forceinline__ bool step(int i, double x) {
    return lp_step(m[i * T], e[i * T], x);
  }
  __device__ __forceinline__ void fix(int i, double x) {
    lp_fix(m[i * T], e[i * T], masks[0], masks[T], masks[2 * T], 1u << i,
           x);
  }
  __device__ __forceinline__ double log_sum(int i) const {
    return lp_sum(m[i * T], e[i * T], masks[0], masks[T], masks[2 * T],
                  1u << i);
  }
};

// The fixed butterfly over a warp: every lane gets the same sum, in an order
// that does not depend on timing, so two launches give identical bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace dmx
