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
// 0.0 none row), from the wire-v2 parts: dense (B, S, U0) codes of the
// first U0 lanes and the cell's tail, K2p (position, code) entries sorted
// by position, a position being s * D + the lane past U0 (D = U - U0 deep
// lanes; pads sit at S * D or past it, with the none code). Full-lane codes
// are the case with no tail (U0 = U):
//   lograw[c] = sum over the slot's lanes of lut[min(code, R-1)][c], the
//               dense lanes in order, then the slot's tail entries in lane
//               order (the deep lanes without an entry are the none row,
//               +0.0, so the sum equals the one over the rebuilt lanes bit
//               for bit)
//   t[c]      = (exp(lograw[c] - mx) + 1e-6) / (1 + 1e-6),
//               mx = the max of lograw over the mixture channels (cmask);
//               the max of the smoothed table is exactly 1 + 1e-6, as in
//               likelihood.py:66-69
//   gl[l]     = the pass-1 GL table of likelihood.py:41-45 from the three
//               singlet channels gsel: exp(ls - max), /sum, +1e-6, /sum,
//               each sum in l order; (1, 0, 0) on a masked slot.
// A padded slot (all lanes none) has lograw == 0, so t == 1 exactly.
//
// What bounds it on this card: its bound is the bytes of its outputs. Per
// slot it writes C + 3 doubles and reads U0 codes, the slot's share of the
// tail and ~(U0 + 1.15) LUT rows (the engine's profile: 1 + Poisson(0.15)
// UMIs per slot, a few PCR-hot slots of 32-64), against C + 3 exps. It runs
// at 4-5x that bound, held by its instructions (the C + 3 f64 exps, the
// lane loop and the two binary searches a slot), not by its bytes. The first
// version read the full lanes that ops/wire.py rebuilt from the tail (U =
// 32 or 64 on every block that holds a PCR-hot slot, almost all of them
// none), one thread's U codes at a 4U-byte stride, and summed U LUT rows
// per channel tile; the rebuild itself (a (B, S*D + 1) plane, a scatter
// and a cat) cost as much again (PERF.md).
//
// What the design does about it: one block takes a cell at a time (blocks
// loop over cells), its threads over the cell's slots, slots fastest, so
// every store of t and gl is coalesced along s. A thread reads its U0 dense
// codes, finds its slot's run of tail entries by a binary search of the
// cell's tail, staged in shared memory when it fits (else read through
// L1), and adds only the LUT rows of codes that are there. The LUT is
// staged once per block in shared memory when the table fits (dynamic
// shared memory, opted in above 48 KB), else read through L1 (a narrowed
// wire-v2 table is a few rows; --cap-BQ 126 with a wide grid is not).
// Channels go in tiles of 8 register sums. lograw is kept in the t output
// between the two passes over channels (the thread's own stores), so no
// scratch.
//
// Build without --use_fast_math: exp must be the accurate one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChanTile = 8;

struct Params {
  const int* dense;          // (B, S, U0)
  const int* tpos;           // (B, K2p) sorted positions, or null
  const int* tcode;          // (B, K2p)
  const double* lut;         // (R, C)
  const unsigned char* msk;  // (B*S,) bool
  const int* cmask;          // (C,) 1 = a mixture channel
  double* t;                 // (C, B*S)
  double* gl;                // (3, B*S)
  long long n;               // B * S
  int B, S, U0, K2p, D, R, C, g0, g1, g2;
  bool tail_smem;            // stage each cell's tail in shared memory
};

// The first of the n sorted positions that is >= key.
__device__ __forceinline__ int lower_bound(const int* pos, int n, int key) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (pos[lo + half] < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) front_exact_kernel(Params p) {
  extern __shared__ double smem[];  // the LUT (kSmem), then the tail
  const double* lut = p.lut;
  const int n_lut = kSmem ? p.R * p.C : 0;
  if (kSmem) {
    for (int i = threadIdx.x; i < n_lut; i += blockDim.x) smem[i] = p.lut[i];
    lut = smem;
  }
  int* tail_s = reinterpret_cast<int*>(smem + n_lut);
  const long long n = p.n;
  const int S = p.S, U0 = p.U0, K2p = p.K2p, D = p.D, C = p.C;
  const int last = p.R - 1;
  for (long long b = blockIdx.x; b < p.B; b += gridDim.x) {
    const int* tp = p.tpos + b * K2p;
    const int* tc = p.tcode + b * K2p;
    if (p.tail_smem) {
      __syncthreads();  // the previous cell's tail is read no more
      for (int i = threadIdx.x; i < K2p; i += blockDim.x) {
        tail_s[i] = tp[i];
        tail_s[K2p + i] = tc[i];
      }
      tp = tail_s;
      tc = tail_s + K2p;
    }
    __syncthreads();  // the LUT and the tail have landed
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const long long i = b * S + s;
      const int* cd = p.dense + i * U0;
      // the slot's tail entries: positions in [s * D, (s + 1) * D)
      int lo = 0, hi = 0;
      if (K2p) {
        lo = lower_bound(tp, K2p, s * D);
        hi = lo + lower_bound(tp + lo, K2p - lo, (s + 1) * D);
      }
      double mx = -INFINITY;
      // pass 1: lograw, kept in t
      for (int c0 = 0; c0 < C; c0 += kChanTile) {
        double acc[kChanTile];
#pragma unroll
        for (int k = 0; k < kChanTile; ++k) acc[k] = 0.0;
        for (int u = 0; u < U0 + hi - lo; ++u) {
          const int code = u < U0 ? cd[u] : tc[lo + u - U0];
          const int r = min(max(code, 0), last);
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
        double* tcp = p.t + c * n + i;
        *tcp = (exp(*tcp - mx) + 1e-6) / (1.0 + 1e-6);
      }
    }
  }
}

int g_sms = 0;

size_t smem_bytes(int R, int C, int K2p, int lut_smem, int tail_smem) {
  return (lut_smem ? (size_t)R * C * sizeof(double) : 0) +
         (tail_smem ? (size_t)K2p * 2 * sizeof(int) : 0);
}

template <bool kSmem>
int launch(const Params& p, size_t bytes, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      front_exact_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, front_exact_kernel<kSmem>, kThreads, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long cap = (long long)g_sms * per_sm;
  const int blocks = (int)(p.B < cap ? p.B : cap);
  front_exact_kernel<kSmem><<<blocks, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The dynamic shared memory K2' takes (bytes): the LUT's R*C doubles if
// lut_smem, the tail's K2p (position, code) pairs if tail_smem.
int dmx_front_exact_smem(int R, int C, int K2p, int lut_smem,
                         int tail_smem) {
  return (int)smem_bytes(R, C, K2p, lut_smem, tail_smem);
}

// Launches K2' on `stream` and returns the first CUDA error (0 on success).
// dense (B, S, U0) int32, tpos and tcode (B, K2p) int32 (null when K2p is
// 0; positions sorted per cell, D = U - U0 deep lanes a slot), lut (R, C)
// f64, msk (B*S) bool, cmask (C) int32 on the device; t (C, B*S) and gl
// (3, B*S) f64 allocated by the caller. lut_smem: stage the LUT in shared
// memory; tail_smem: stage each cell's tail (at most 227 KB together).
int dmx_front_exact(const int* dense, const int* tpos, const int* tcode,
                    const double* lut, const unsigned char* msk,
                    const int* cmask, double* t, double* gl, int B, int S,
                    int U0, int K2p, int D, int R, int C, int g0, int g1,
                    int g2, int lut_smem, int tail_smem, void* stream) {
  if (B < 1 || S < 1 || U0 < 0 || K2p < 0 || (K2p && (D < 1 || !tpos)) ||
      (long long)S * (D + 1) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.dense = dense;
  p.tpos = tpos;
  p.tcode = tcode;
  p.lut = lut;
  p.msk = msk;
  p.cmask = cmask;
  p.t = t;
  p.gl = gl;
  p.n = (long long)B * S;
  p.B = B;
  p.S = S;
  p.U0 = U0;
  p.K2p = K2p;
  p.D = D;
  p.R = R;
  p.C = C;
  p.g0 = g0;
  p.g1 = g1;
  p.g2 = g2;
  p.tail_smem = tail_smem && K2p;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t bytes = smem_bytes(R, C, K2p, lut_smem, p.tail_smem);
  return lut_smem ? launch<true>(p, bytes, st) : launch<false>(p, bytes, st);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
