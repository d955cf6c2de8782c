// A sum of logs kept as a product: the accumulators of the pair kernels,
// in f64 for exact mode (K3' pair_exact.cu, K7' pair_tiled_exact.cu) and in
// f32 for fast mode (K1 pair_fast.cu, K5' pair_tiled_fast.cu).
//
// sum_s log(x_s) over one lane's slots is kept as m * 2^e: a mantissa m in
// [1, 2) of the scalar type F and an int exponent e. Each step multiplies m
// by x and moves the product's exponent field into e (bit operations, no
// log), so a channel takes one log per lane at the end instead of one per
// slot. This is the TPU kernels' df32 product with exponent tracking
// (demuxlet_tpu/ops/pallas_pair_exact.py: _renorm, the stacked product
// accumulators of _pair_kernel_df, _log_mantissa) in native f64, and the
// same in f32.
//
// Renormalised at every step, and without a branch: an x in the safe range
// (f64: [2^-1022, 2^1022); f32: [2^-126, 2^126)) gives a positive normal
// product whatever m in [1, 2) is, so no floor on x is assumed. Any other x
// (0, subnormal, huge, inf, NaN, negative) multiplies in 1 instead and the
// step reports it; the kernels then take the rare path `fix` for the whole
// warp (a vote per slot): a positive subnormal or huge x is split by frexp
// (frexpf) and multiplied in exactly, and 0, inf and NaN (or x < 0) set the
// channel's bit in one of three masks, so the lane's sum ends at -inf, +inf
// or NaN as the plain version's sum of logs does (-inf and +inf together
// give NaN). A masked slot's x == 1 leaves m and e unchanged, so a lane of
// padding ends at log(1) + 0 == 0 exactly.
//
// The lane's sum log(m) + e ln 2 is taken in f64 for both types (one f64
// log per lane and channel); the kernels sum the lanes in f64 too, and the
// f32 kernels round to f32 once per channel. In f32 a lane of n steps
// carries at most n roundings of 2^-24 relative in its product: 8e-6
// absolute at 128 steps (S = 4096), below the f32 sum of logs it replaces.
//
// The exponent: |e| grows by at most 1075 per step (f32: 150), so int32
// holds any lane of at most kMaxSteps steps (the kernels refuse longer
// rows).

#pragma once

#include <cuda_runtime.h>

namespace dmx {

constexpr int kMaxSteps = 1 << 20;  // 2^20 * 1075 < 2^31

// ln 2 = kLn2Hi + kLn2Lo; kLn2Hi has 32 significant bits, so e * kLn2Hi is
// exact for |e| < 2^21 (10^5 steps of x ~ 1e-6): nothing is lost at
// |e| ~ 10^5.
constexpr double kLn2Hi = 6.93147180369123816490e-01;
constexpr double kLn2Lo = 1.90821492927058770002e-10;

// The exponent field of the scalar type: safe(x), renorm(p, e) (p positive
// normal: returns its mantissa in [1, 2) and adds its exponent to e),
// split(x, &k) (frexp) and the largest finite value.
template <class F>
struct Bits;

template <>
struct Bits<double> {
  // x in [2^-1022, 2^1022): its high word in [0x00100000, 0x7fc00000)
  static __device__ __forceinline__ bool safe(double x) {
    return static_cast<unsigned>(__double2hiint(x) - 0x00100000) <
           0x7fb00000u;
  }
  static __device__ __forceinline__ double renorm(double p, int& e) {
    const int hp = __double2hiint(p);
    e += (hp >> 20) - 1023;
    return __hiloint2double((hp & 0x000fffff) | 0x3ff00000,
                            __double2loint(p));
  }
  static __device__ __forceinline__ double split(double x, int* k) {
    return frexp(x, k);
  }
  static constexpr double kMax = 1.7976931348623157e308;
};

template <>
struct Bits<float> {
  // x in [2^-126, 2^126): its bits in [0x00800000, 0x7e800000)
  static __device__ __forceinline__ bool safe(float x) {
    return __float_as_uint(x) - 0x00800000u < 0x7e000000u;
  }
  static __device__ __forceinline__ float renorm(float p, int& e) {
    const int hp = __float_as_int(p);
    e += (hp >> 23) - 127;
    return __int_as_float((hp & 0x007fffff) | 0x3f800000);
  }
  static __device__ __forceinline__ float split(float x, int* k) {
    return frexpf(x, k);
  }
  static constexpr float kMax = 3.40282346638528859812e+38f;
};

// One step: m * x renormalised if x is safe, else m * 1; returns
// safe(x). No branch: the kernels vote once per slot and take lp_fix
// for the whole warp when a lane met an unsafe x.
template <class F>
__device__ __forceinline__ bool lp_step(F& m, int& e, F x) {
  const bool safe = Bits<F>::safe(x);
  m = Bits<F>::renorm(m * (safe ? x : F(1)), e);
  return safe;
}

// The rare path for an x that lp_step left out (nothing if x is safe).
template <class F>
__device__ __forceinline__ void lp_fix(F& m, int& e, unsigned& zero,
                                       unsigned& inf, unsigned& nan,
                                       unsigned bit, F x) {
  if (Bits<F>::safe(x)) return;
  if (x > F(0) && x <= Bits<F>::kMax) {
    // subnormal or huge: x = f 2^k exactly, f in [0.5, 1), so the product
    // m f lies in [0.5, 2)
    int k;
    const F p = m * Bits<F>::split(x, &k);
    e += k;
    m = Bits<F>::renorm(p, e);
  } else if (x == F(0)) {
    zero |= bit;
  } else if (x > F(0)) {
    inf |= bit;
  } else {
    nan |= bit;  // NaN or x < 0
  }
}

// A lane's sum of logs in f64: log(m) + e ln 2, or -inf, +inf, NaN.
template <class F>
__device__ __forceinline__ double lp_sum(F m, int e, unsigned zero,
                                         unsigned inf, unsigned nan,
                                         unsigned bit) {
  if ((nan & bit) || (zero & inf & bit)) {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  if (zero & bit) return -__longlong_as_double(0x7ff0000000000000LL);
  if (inf & bit) return __longlong_as_double(0x7ff0000000000000LL);
  const double ed = static_cast<double>(e);
  return fma(ed, kLn2Hi, fma(ed, kLn2Lo, log(static_cast<double>(m))));
}

// N product accumulators of one thread in registers: every index is a
// compile-time constant once the kernels' loops are unrolled.
template <int N, class F = double>
struct Acc {
  static_assert(N <= 32, "one bit per accumulator in the masks");
  F m[N];
  int e[N];
  unsigned zero, inf, nan;  // channels that met x == 0, inf, NaN (or < 0)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      m[i] = F(1);
      e[i] = 0;
    }
    zero = inf = nan = 0u;
  }
  __device__ __forceinline__ bool step(int i, F x) {
    return lp_step(m[i], e[i], x);
  }
  __device__ __forceinline__ void fix(int i, F x) {
    lp_fix(m[i], e[i], zero, inf, nan, 1u << i, x);
  }
  __device__ __forceinline__ double log_sum(int i) const {
    return lp_sum(m[i], e[i], zero, inf, nan, 1u << i);
  }
};

// N accumulators of one thread in shared memory, stored so that a warp's
// lanes touch consecutive words: accumulator i of thread t at m[i * T + t]
// (T threads; masks: zero, inf, nan at [k * T + t]).
template <int N, class F = double>
struct SharedAcc {
  F* m;
  int* e;
  unsigned* masks;
  int T;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      m[i * T] = F(1);
      e[i * T] = 0;
    }
    masks[0] = masks[T] = masks[2 * T] = 0u;
  }
  __device__ __forceinline__ bool step(int i, F x) {
    return lp_step(m[i * T], e[i * T], x);
  }
  __device__ __forceinline__ void fix(int i, F x) {
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
