// K7': exact-mode tiled pair search for Hopper (sm_90a), in f64.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair_exact.py::
// _pair_kernel_df_tiled (launched by _call_pair_kernel_df_tiled) on pools
// with V*V*A > 384, where the unrolled K3' (pair_exact.cu) would need more
// accumulators than a block holds. Like the TPU kernel, it multiplies each
// channel's inner values into a product with exponent tracking and takes one
// log per accumulator (logprod.cuh), in native f64 instead of df32.
//
// What it computes, per cell b and slot s (t: the front's mixture table, C
// deduplicated channels that expand maps onto the A*9 logical (a, l, m)
// channels; g: per-slot genotype posteriors, rows j*3 + l for the V
// samples, then three background rows this kernel does not read):
//   U[j,a,m]        = sum_l g[j,l] * t[a,l,m]
//   llk_ab[b,j,k,a] = sum_s log(sum_m g[k,m] * U[j,a,m])
// for every (j, k) of the planned tiles and every alpha of each tile's
// alpha list (ops/pair_tiled.py::plan_tiles). An item is one tile of one
// alpha group: (j0, k0, a_begin, a_count, sym). sym marks the symmetric
// alpha == 0.5 plane's upper-triangle tiles: channels with k < j are
// skipped and those with k > j are also written at (k, j), so the mirrored
// channel is an exact copy. A masked slot carries t == 1 and neutral rows
// (1, 0, 0), so its inner value is exactly 1 and leaves the product as it
// was.
//
// What limits it on this card: the function reads 3V + the used t channels
// (doubles) per slot and spends a 3-term dot and a multiply per (j, k,
// alpha) channel per slot: bytes bound it at V=32, A=2 (0.54 ms at B=2048,
// S=1024) and f64 operations at A=5 (1.70 ms). PR 4's kernel took an f64
// log per channel per slot and re-read the tile's g_k rows through L1/L2
// from each of the tile's rows. Step by step at V=32, A=2, B=2048, S=1024
// (chip_steps.py; H100 80GB HBM3, 700 W): 10.43 ms; products in place of
// logs 8.04; slot chunks staged in shared memory (1 x 8 patches) 6.57;
// 4 x 8 patches 3.95; the branch-free step 3.66; 4 x 4 patches at 16 warps
// 2.70; chunks of 128 slots 2.54, 4.7x the bound. What bounds it now is the
// arithmetic at the occupancy its registers allow: staging alone takes
// 0.80 ms, the patches alone 2.23 (chip_steps.py with DMX_PROBE); a
// channel's step is a dot, a multiply and ~7 integer operations, which run
// at half rate, on 16 warps of 127 registers per SM.
//
// What the design does about it (tiled.cuh over stage.cuh, the body K5'
// shares in f32): one block owns one (cell, item) and streams the cell's
// slots in chunks of 128 through two shared-memory stages (cp.async; chunk c
// + 1 lands while chunk c is computed): the tile's j rows, its k rows (once,
// on diagonal tiles) and the 9 t rows of the alphas in flight, each read
// from L2 once per block. Each warp owns one 4 x 4 patch of (j, k) channels
// of one alpha, its lanes over slots; per slot a thread loads 4 g_j rows, 9
// t values and 4 g_k rows from shared memory for 16 channels (2.1 loads per
// channel, against ~3.7 through L1/L2 before). A 16 x 16 tile is 16 patches
// per alpha, one per warp: with more alphas than that, the block takes them
// in rounds, each a pass over the slots. The products (logprod.cuh) end in
// one log per lane and a fixed warp-shuffle butterfly: no atomics, so runs
// give identical bits. Blocks of one cell are adjacent in the grid, so the
// cell's rows come from HBM about once and then from L2. Shapes, V, A, the
// tile list and expand are runtime arguments; the tile extent KT (8 or 16)
// is compile-time.
//
// Build without --use_fast_math: log must be the accurate f64 one.

#include <cuda_runtime.h>

#include "tiled.cuh"

namespace {

template <int KT>
__global__ void __launch_bounds__(dmx::kTiledWarps<dmx::PK> * 32, 1)
pair_tiled_exact_kernel(dmx::TiledParams<double> p) {
  extern __shared__ double smem[];  // 2 stages, then the row pointers
  dmx::pair_tiled_body<KT, dmx::PK>(p, smem);
}

}  // namespace

extern "C" {

// The dynamic shared memory K7' takes with tile extent `tile` (bytes), or 0
// for an extent it does not take.
int dmx_pair_tiled_exact_smem(int tile) {
  return tile == 8    ? dmx::Tile<8, dmx::PK, double>::kSmem
         : tile == 16 ? dmx::Tile<16, dmx::PK, double>::kSmem
                      : 0;
}

// Launches K7' on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V+3, B, S), expand (A*9), items (n_items, 5) and alist
// on the device; out (B, V*V*A) allocated by the caller, which also fills
// the channels no item writes. tile: the items' extent, 8 or 16.
int dmx_pair_tiled_exact(const double* t, const double* g, const int* expand,
                         const int* items, const int* alist, double* out,
                         int B, int S, int V, int A, int n_items, int tile,
                         void* stream) {
  const dmx::TiledParams<double> p = dmx::tiled_params(
      t, g, expand, items, alist, out, B, S, V, A, n_items);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 8) {
    return dmx::launch_tiled<8, dmx::PK>(pair_tiled_exact_kernel<8>, p, B,
                                         st);
  }
  if (tile == 16) {
    return dmx::launch_tiled<16, dmx::PK>(pair_tiled_exact_kernel<16>, p, B,
                                          st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
