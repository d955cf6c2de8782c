// K6': the O(V) channels of the exact-mode tiled pair search, for Hopper
// (sm_90a), in f64.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair_exact.py::
// _extras_kernel_df (its pallas_call in _call_pair_kernel_df_tiled), the
// companion of K7' (pair_tiled_exact.cu) on pools with V*V*A > 384. Like the
// TPU kernel, it multiplies each column's inner values into a product with
// exponent tracking and takes one log per accumulator (logprod.cuh), in
// native f64 instead of df32.
//
// What it computes, per cell b, as columns of out (B, n_x) in the order of
// ops/pair_tiled.py::extras_keys (g rows j*3 + l for the V samples and
// j = V for the host background gp0; gl the pass-1 GL table; t the front's
// mixture table, expand mapping the A*9 logical channels onto its rows):
//   s[j]   = sum_s log(gl . g[j])                        j = 0..V
// and, when the alpha == 0 plane is separable (a0_sep),
//   d[j]   = sum_s log(g[j] . t[0,:,0])                  j = 0..V-1
//   gs[k]  = sum_s log(g[k,0] + g[k,1] + g[k,2])         k = 0..V-1
//   u00    = d of gp0,  g0s = gs of gp0,
// then, for every alpha a that is not the separable one,
//   m0[a]  = sum_s log(g0 . (g0 t[a]))
// A masked slot carries t == 1, neutral rows (1, 0, 0) and gl == (1, 0, 0),
// so it leaves every product as it was.
//
// What bounds it on this card: the bytes. Per slot it reads the 3V + 3 g
// rows, gl, and up to 3 + 9 (A - 1) t rows, against ~3V + A columns of a
// 3-term dot and a multiply each (K7' does ~V*V*A on the same rows). The
// first version took one accurate f64 log per column per slot, its warps
// walking the columns one after another and re-reading gl, the t column
// and g0 from L2 for every column that used them: 2.0 ms at V=32, A=2,
// B=2048, S=1024, 3.7x the bytes (PERF.md).
//
// What the design does about it (extras.cuh, the body K4' shares, over
// stage.cuh and logprod.cuh as K3' and K7' use them): one block owns one
// cell and streams its slots in chunks of CH slots (128, or 64 where that
// takes fewer rounds) through two shared-memory stages (cp.async; chunk
// c + 1 lands while chunk c is computed), so every row is read from HBM
// once per cell. A unit is sample j with its s, d and gs columns (they read
// g_j once), or one non-separable alpha with its m0 column; each of 16
// warps owns up to 3 units of a round, its lanes over slots, one product
// accumulator per column in registers: one f64 log per lane and column,
// then the fixed warp-shuffle butterfly, so runs give identical bits. A
// round stages gl, the alpha == 0 t column and g0 (9 rows), 3 rows per
// sample and 9 per alpha; pools whose rows exceed the shared memory take
// several rounds, each a pass over the slots. V, A, a0_sep and expand are
// runtime arguments. Sharing the body with K4' left its bits as they were
// and its time within 3%. It runs at ~1.5x
// its bytes: the staging alone and the arithmetic alone each take ~70% of
// its time, so their overlap sets it (PERF.md).
//
// Build without --use_fast_math: log must be the accurate f64 one.

#include <cuda_runtime.h>

#include "extras.cuh"

namespace {

// 16 warps of up to 3 units each (up to 9 f64 accumulators a thread), one
// block an SM
using Cfg = dmx::ExtrasCfg<double, true, 16, 3, 1>;

template <int CH>
__global__ void __launch_bounds__(Cfg::kWarps * 32, Cfg::kBlocks)
extras_exact_kernel(dmx::ExtrasParams<double> p) {
  extern __shared__ __align__(16) double smem[];  // stages, row pointers
  dmx::extras_body<Cfg, CH, dmx::Acc<Cfg::kCols * Cfg::kUnits>>(p, smem);
}

}  // namespace

extern "C" {

// The dynamic shared memory K6' takes for a pool (bytes).
int dmx_extras_exact_smem(int V, int A, int a0_sep) {
  int ch;
  const dmx::ExtrasParams<double> p = dmx::extras_params<Cfg>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, V, A,
      a0_sep, &ch);
  return dmx::extras_smem<Cfg>(ch, p.stride);
}

// Launches K6' on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V+3, B, S), gl (3, B, S) and expand (A*9) on the device;
// out (B, n_x) allocated by the caller, n_x = V + 1 + (a0_sep ? 2V + 2 : 0)
// + the number of non-separable alphas.
int dmx_extras_exact(const double* t, const double* g, const double* gl,
                     const int* expand, double* out, int B, int S, int V,
                     int A, int a0_sep, void* stream) {
  int ch;
  const dmx::ExtrasParams<double> p = dmx::extras_params<Cfg>(
      t, g, g + 3LL * V * B * S, gl, expand, out, B, S, V, A, a0_sep, &ch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch == 128) {
    return dmx::launch_extras<Cfg, 128>(extras_exact_kernel<128>, p, B, st);
  }
  if (ch == 64) {
    return dmx::launch_extras<Cfg, 64>(extras_exact_kernel<64>, p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
