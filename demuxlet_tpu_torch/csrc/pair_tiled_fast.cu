// K5': fast-mode tiled pair search for Hopper (sm_90a), in f32.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair.py::_pair_kernel_tiled
// (launched by _call_pair_kernel_tiled) on pools with V*V*A > 384, where the
// unrolled K1 (pair_fast.cu) would need more accumulators than a block
// holds. The TPU kernel took up to 4 slot products per log (`halves`); this
// kernel multiplies every slot's inner value into a product with exponent
// tracking and takes one log per lane and channel (logprod.cuh).
//
// What it computes, per cell b and slot s (t: the front's mixture table, C
// deduplicated channels that expand maps onto the A*9 logical (a, l, m)
// channels; g: per-slot genotype posteriors, rows j*3 + l for the V
// samples):
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
// (floats) per slot and spends a 3-term dot and a multiply per (j, k,
// alpha) channel per slot: bytes bound it at V=32, A=2 (0.26 ms at B=2048,
// S=1024) and f32 operations at A=5 (0.86 ms). The first port of it took
// one accurate logf per channel per slot and each of the tile's (j, alpha)
// rows re-read the tile's g_k rows through L1/L2. Step by step at V=32,
// A=2, B=2048, S=1024 (chip_steps.py; H100 80GB HBM3, 700 W): 5.74 ms;
// products in place of logf in that layout 7.31 (slower: the re-reads
// stay, and a product's integer work on the exponent field runs at half
// the FP32 rate); K7''s design below with 4 x 4 patches at 16 warps 2.03;
// 4 x 8 patches at 8 warps, two blocks an SM, 1.75, 7x the bound. What
// bounds it now is that arithmetic: a channel's step is a dot, a multiply
// and ~5 integer operations; staging alone takes a fifth of the time
// (DMX_PROBE, PERF.md).
//
// What the design does about it: K7''s design (tiled.cuh over stage.cuh)
// instantiated in f32. One block owns one (cell, item) and streams the
// cell's slots in chunks of 128 through two shared-memory stages (cp.async,
// 16 bytes = 4 slots a copy when S % 4 == 0 and the tensors are aligned;
// chunk c + 1 lands while chunk c is computed): the tile's j rows, its k
// rows (once, on diagonal tiles) and the 9 t rows of the alphas in flight,
// each read from L2 once per block. 128 floats are 512 bytes a row, so a
// warp's load is 128 consecutive bytes with no bank conflict. Each warp
// owns one 4 x 8 patch of (j, k) channels of one alpha, its lanes over
// slots: per slot a thread loads 4 g_j rows, 9 t values and 8 g_k rows from
// shared memory for 32 channels, and each channel's step is a dot, a
// multiply and a few integer operations on the f32 exponent field (no
// log). An f32 accumulator takes 2 registers (mantissa, exponent), not 3 as
// in f64, so the 32 fit in 128 registers at 8 warps a block and two blocks
// an SM. The lane's log(m) + e ln 2 and the warp-shuffle butterfly are f64,
// rounded to f32 once per channel: no atomics, so runs give identical bits.
// Blocks of one cell are adjacent in the grid, so the cell's rows come from
// HBM about once and then from L2. Shapes, V, A, the tile list and expand
// are runtime arguments; the tile extent KT (8 or 16), the patch and the
// chunk are compile-time.
//
// Build without --use_fast_math: the lane's log must be the accurate one.

#include <cuda_runtime.h>

#include "tiled.cuh"

namespace {

// 4 x 8 patches: 8 warps of up to 128 registers, two blocks an SM (4 x 4
// at 16 warps took 13-16% longer: PERF.md)
constexpr int kNK = 8;

template <int KT>
__global__ void __launch_bounds__(dmx::kTiledWarps<kNK> * 32, 2)
pair_tiled_fast_kernel(dmx::TiledParams<float> p) {
  extern __shared__ __align__(16) float smem[];  // 2 stages, row pointers
  dmx::pair_tiled_body<KT, kNK>(p, smem);
}

}  // namespace

extern "C" {

// The dynamic shared memory K5' takes with tile extent `tile` (bytes), or 0
// for an extent it does not take.
int dmx_pair_tiled_fast_smem(int tile) {
  return tile == 8    ? dmx::Tile<8, kNK, float>::kSmem
         : tile == 16 ? dmx::Tile<16, kNK, float>::kSmem
                      : 0;
}

// Launches K5' on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V, B, S), expand (A*9), items (n_items, 5) and alist on
// the device; out (B, V*V*A) allocated by the caller, which also fills the
// channels no item writes. tile: the items' extent, 8 or 16.
int dmx_pair_tiled_fast(const float* t, const float* g, const int* expand,
                        const int* items, const int* alist, float* out, int B,
                        int S, int V, int A, int n_items, int tile,
                        void* stream) {
  const dmx::TiledParams<float> p = dmx::tiled_params(
      t, g, expand, items, alist, out, B, S, V, A, n_items);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 8) {
    return dmx::launch_tiled<8, kNK>(pair_tiled_fast_kernel<8>, p, B, st);
  }
  if (tile == 16) {
    return dmx::launch_tiled<16, kNK>(pair_tiled_fast_kernel<16>, p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
