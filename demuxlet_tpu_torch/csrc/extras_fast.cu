// K4': the O(V) channels of the fast-mode tiled pair search, for Hopper
// (sm_90a), in f32.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair.py::_extras_kernel
// (launched by _call_extras_only), the companion of K5' (pair_tiled_fast.cu)
// on pools with V*V*A > 384; on a single-point alpha == 0 grid it carries
// the whole pair search alone. The TPU kernel multiplied up to four slots'
// inner values per log (`halves`); this one multiplies every slot's into a
// product with exponent tracking and takes one log per lane and column
// (logprod.cuh).
//
// What it computes: the columns of extras.cuh without the singlets (fast
// mode's front computes them), per cell b as out (B, n_x) in the order of
// ops/pair_tiled.py::extras_keys(..., singlets=False): with a separable
// alpha == 0 plane d[j], gs[k], u00 and g0s, then m0[a] for every other
// alpha. g0 is the three host background rows gp0 through their own
// pointer (the TPU's host-exact gp0 planes, not a mean taken here), so the
// caller never concatenates them to g.
//
// What bounds it on this card: the bytes. Per slot it reads the 3V g rows,
// g0 and up to 3 + 9 (A - 1) t rows (104 distinct f32 rows at V=32, A=2:
// 0.26 ms at B=2048, S=1024), against ~2V + A columns of a 3-term dot and
// a multiply each. The first version took one accurate logf per column per
// slot, its warps walking whole columns and re-reading the t column and g0
// from L2 for every column that used them: 0.64 ms, 2.4x the bytes.
//
// What the design does about it: K6''s body (extras.cuh) in f32. One block
// owns one cell and streams its slots through two shared-memory stages of
// 128-slot chunks (64 where 128's would keep two blocks from sharing an
// SM: A=5 at V=32), so every row is read from HBM once per cell; without a
// separable plane no sample row is staged. Each of 16 warps owns up to 3
// units (a sample's d and gs columns, g0's u00 and g0s, or an alpha's m0),
// its lanes over slots, one f32 product per column in registers; the
// lane's log and the butterfly are f64, rounded to f32 once per column: no
// atomics, so runs give identical bits. 63 registers, two blocks an SM.
// Measured (chip_steps.py, PERF.md): 0.33 ms at V=32, A=2, 1.3x the bytes
// (1.1x at S=4096); staging alone takes 0.30 ms and the arithmetic alone
// 0.25, so their overlap sets it. One logf per column per slot in place of
// the products was 12-18% slower, 8 warps of up to 5 units (84 registers)
// 12-16%, and a third stage within 4% either way.
//
// Build without --use_fast_math: the lane's log must be the accurate one.

#include <cuda_runtime.h>

#include "extras.cuh"

namespace {

// 16 warps of up to 3 units each (up to 6 f32 accumulators a thread), two
// blocks an SM
using Cfg = dmx::ExtrasCfg<float, false, 16, 3, 2>;

template <int CH>
__global__ void __launch_bounds__(Cfg::kWarps * 32, Cfg::kBlocks)
extras_fast_kernel(dmx::ExtrasParams<float> p) {
  extern __shared__ __align__(16) float smem[];  // stages, row pointers
  dmx::extras_body<Cfg, CH, dmx::Acc<Cfg::kCols * Cfg::kUnits, float>>(
      p, smem);
}

}  // namespace

extern "C" {

// The dynamic shared memory K4' takes for a pool (bytes).
int dmx_extras_fast_smem(int V, int A, int a0_sep) {
  int ch;
  const dmx::ExtrasParams<float> p = dmx::extras_params<Cfg>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, V, A,
      a0_sep, &ch);
  return dmx::extras_smem<Cfg>(ch, p.stride);
}

// Launches K4' on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V, B, S), g0 (3, B, S) and expand (A*9) on the device;
// out (B, n_x) allocated by the caller, n_x = (a0_sep ? 2V + 2 : 0) + the
// number of non-separable alphas.
int dmx_extras_fast(const float* t, const float* g, const float* g0,
                    const int* expand, float* out, int B, int S, int V, int A,
                    int a0_sep, void* stream) {
  int ch;
  const dmx::ExtrasParams<float> p = dmx::extras_params<Cfg>(
      t, g, g0, nullptr, expand, out, B, S, V, A, a0_sep, &ch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch == 128) {
    return dmx::launch_extras<Cfg, 128>(extras_fast_kernel<128>, p, B, st);
  }
  if (ch == 64) {
    return dmx::launch_extras<Cfg, 64>(extras_fast_kernel<64>, p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
