// K2': exact-mode front for Hopper (sm_90a), in f64.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair_exact.py::
// _onehot_front_kernel (launched by _onehot_prod_front) together with the
// normalisation preamble of _pair_kernel_df (_mixture_table_df,
// _gl_table_df). The TPU kept per-slot products as df32 mantissa/exponent
// planes only because it has no f64 ALUs; Hopper has them, so this front
// works in the log domain of models/likelihood.py.
//
// What it computes, per cell b and slot s (one thread each), with
// lut (R, C) the log LUT of the run's deduplicated channels (row R-1 is the
// 0.0 none row) and codes (B, S, U) the full-lane observation codes:
//   lograw[c] = sum_u lut[min(code_u, R-1)][c]        in lane order
//   t[c]      = (exp(lograw[c] - mx) + 1e-6) / (1 + 1e-6),
//               mx = the max of lograw over the mixture channels (cmask);
//               the max of the smoothed table is exactly 1 + 1e-6, as in
//               likelihood.py:66-69
//   gl[l]     = the pass-1 GL table of likelihood.py:41-45 from the three
//               singlet channels gsel: exp(ls - max), /sum, +1e-6, /sum,
//               each sum in l order; (1, 0, 0) on a masked slot.
// A padded slot (all lanes none) has lograw == 0, so t == 1 exactly.
//
// What bounds it on this card: per slot it reads U codes and U*C LUT
// values, and writes C + 3 doubles; C exps. At the main shape (C ~ 20,
// U ~ 2) the writes dominate: it is bound by HBM bandwidth on t.
//
// What the design does about it: one thread per (cell, slot), slots
// fastest, so every store of t and gl is coalesced along s. The LUT rows
// are read at random per thread; they are staged once per block in shared
// memory when the table fits (dynamic shared memory, opted in above
// 48 KB), else read through L1 (a narrowed wire-v2 table is a few rows;
// --cap-BQ 126 with a wide grid is not). Blocks loop over slots, so each
// block stages the LUT once. Channels go in tiles of 8 register sums, so
// the codes are read once per tile. lograw is kept in the t output between
// the two passes over channels (the thread's own stores), so no scratch.
//
// Build without --use_fast_math: exp must be the accurate one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChanTile = 8;

struct Params {
  const int* codes;          // (n, U)
  const double* lut;         // (R, C)
  const unsigned char* msk;  // (n,) bool
  const int* cmask;          // (C,) 1 = a mixture channel
  double* t;                 // (C, n)
  double* gl;                // (3, n)
  long long n;               // B * S
  int U, R, C, g0, g1, g2;
};

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) front_exact_kernel(Params p) {
  extern __shared__ double lut_smem[];
  const double* lut = p.lut;
  if (kSmem) {
    const int n_lut = p.R * p.C;
    for (int i = threadIdx.x; i < n_lut; i += blockDim.x) lut_smem[i] = p.lut[i];
    __syncthreads();
    lut = lut_smem;
  }
  const long long n = p.n;
  const int U = p.U, C = p.C, last = p.R - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int* cd = p.codes + i * U;
    double mx = -INFINITY;
    // pass 1: lograw, kept in t
    for (int c0 = 0; c0 < C; c0 += kChanTile) {
      double acc[kChanTile];
#pragma unroll
      for (int k = 0; k < kChanTile; ++k) acc[k] = 0.0;
      for (int u = 0; u < U; ++u) {
        const int r = min(max(cd[u], 0), last);
        const double* row = lut + (long long)r * C + c0;
#pragma unroll
        for (int k = 0; k < kChanTile; ++k) {
          if (c0 + k < C) acc[k] += row[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kChanTile; ++k) {
        if (c0 + k < C) {
          p.t[(c0 + k) * n + i] = acc[k];
          if (p.cmask[c0 + k]) mx = fmax(mx, acc[k]);
        }
      }
    }
    // the pass-1 GL table from the singlet channels
    const double l0 = p.t[p.g0 * n + i];
    const double l1 = p.t[p.g1 * n + i];
    const double l2 = p.t[p.g2 * n + i];
    double q0 = 1.0, q1 = 0.0, q2 = 0.0;
    if (p.msk[i]) {
      const double lm = fmax(fmax(l0, l1), l2);
      const double e0 = exp(l0 - lm), e1 = exp(l1 - lm), e2 = exp(l2 - lm);
      const double s1 = (e0 + e1) + e2;
      q0 = e0 / s1 + 1e-6;
      q1 = e1 / s1 + 1e-6;
      q2 = e2 / s1 + 1e-6;
      const double s2 = (q0 + q1) + q2;
      q0 = q0 / s2;
      q1 = q1 / s2;
      q2 = q2 / s2;
    }
    p.gl[i] = q0;
    p.gl[n + i] = q1;
    p.gl[2 * n + i] = q2;
    // pass 2: the mixture table
    for (int c = 0; c < C; ++c) {
      double* tc = p.t + c * n + i;
      *tc = (exp(*tc - mx) + 1e-6) / (1.0 + 1e-6);
    }
  }
}

int g_sms = 0;

}  // namespace

extern "C" {

// Launches K2' on `stream` and returns the first CUDA error (0 on success).
// codes (B*S, U) int32, lut (R, C) f64, msk (B*S) bool, cmask (C) int32 on
// the device; t (C, B*S) and gl (3, B*S) f64 allocated by the caller.
// use_smem: stage the LUT in shared memory (R*C*8 bytes, at most 227 KB).
int dmx_front_exact(const int* codes, const double* lut,
                    const unsigned char* msk, const int* cmask, double* t,
                    double* gl, long long n, int U, int R, int C, int g0,
                    int g1, int g2, int use_smem, void* stream) {
  Params p;
  p.codes = codes;
  p.lut = lut;
  p.msk = msk;
  p.cmask = cmask;
  p.t = t;
  p.gl = gl;
  p.n = n;
  p.U = U;
  p.R = R;
  p.C = C;
  p.g0 = g0;
  p.g1 = g1;
  p.g2 = g2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long want = (n + kThreads - 1) / kThreads;
  if (use_smem) {
    const size_t bytes = (size_t)R * C * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(
        front_exact_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, front_exact_kernel<true>, kThreads, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long cap = (long long)g_sms * per_sm;
    const int blocks = (int)(want < cap ? want : cap);
    front_exact_kernel<true><<<blocks, kThreads, bytes, st>>>(p);
  } else {
    const long long cap = (long long)g_sms * 8;
    const int blocks = (int)(want < cap ? want : cap);
    front_exact_kernel<false><<<blocks, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
