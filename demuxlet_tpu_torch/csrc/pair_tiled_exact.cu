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
// What the design does about it (stage.cuh): one block owns one (cell,
// item) and streams the cell's slots in chunks of 128 through two
// shared-memory stages (cp.async; chunk c + 1 lands while chunk c is
// computed): the tile's j rows, its k rows (once, on diagonal tiles) and
// the 9 t rows of the alphas in flight, each read from L2 once per block.
// Each warp owns one 4 x 4 patch of (j, k) channels of one alpha, its lanes
// over slots; per slot a thread loads 4 g_j rows, 9 t values and 4 g_k rows
// from shared memory for 16 channels (2.1 loads per channel, against ~3.7
// through L1/L2 before). A 16 x 16 tile is 16 patches per alpha, one per
// warp: with more alphas than that, the block takes them in rounds, each a
// pass over the slots. The products (logprod.cuh) end in one log per lane
// and a fixed warp-shuffle butterfly: no atomics, so runs give identical
// bits. Blocks of one cell are adjacent in the grid, so the cell's rows come
// from HBM about once and then from L2. Shapes, V, A, the tile list and
// expand are runtime arguments; the tile extent KT (8 or 16) is
// compile-time.
//
// Build without --use_fast_math: log must be the accurate f64 one.

#include <cuda_runtime.h>

#include "logprod.cuh"
#include "stage.cuh"

namespace {

using dmx::PJ;
using dmx::PK;

// Warps per block: one per patch of a 16 x 16 tile's alpha (each thread
// up to 128 registers).
constexpr int kWarps = (16 / PJ) * (16 / PK);
constexpr int kItem = 5;  // ints per item: j0, k0, a_begin, a_count, sym
constexpr int kChunk = 128;  // 6% faster than 64 (PERF.md, PR 5)

struct Params {
  const double* t;    // (C, B, S)
  const double* g;    // (3V + 3, B, S)
  const int* expand;  // (A*9,) rows of t
  const int* items;   // (n_items, kItem)
  const int* alist;   // the alpha indices the items' slices index
  double* out;        // (B, V*V*A)
  long long plane;    // B*S: stride between channels
  int S, V, A, n_items;
  bool vec;  // S even and the tensors 16-byte aligned: 16-byte copies
};

// A KT tile's patches and the most rows a round stages: j rows, k rows,
// and the 9 t rows of each alpha its warps' patches can touch.
template <int KT>
struct Tile {
  static_assert(KT % PJ == 0 && KT % PK == 0, "patches must tile KT");
  static constexpr int kNk = KT / PK;
  static constexpr int kPatches = (KT / PJ) * kNk;
  // a round's units are kWarps consecutive ones, alpha-major: it touches
  // kWarps / kPatches alphas, or one
  static_assert(kWarps % kPatches == 0 || kPatches % kWarps == 0,
                "rounds must not straddle alphas unevenly");
  static constexpr int kRoundAlphas =
      kWarps > kPatches ? kWarps / kPatches : 1;
  static constexpr int kRows = 6 * KT + 9 * kRoundAlphas;
  static constexpr int kSmem =
      2 * kRows * kChunk * sizeof(double) + kRows * sizeof(const double*);
};

template <int KT>
__global__ void __launch_bounds__(kWarps * 32, 1)
pair_tiled_exact_kernel(Params p) {
  using T = Tile<KT>;
  extern __shared__ double smem[];  // 2 stages, then the row pointers
  const double** rows =
      reinterpret_cast<const double**>(smem + 2 * T::kRows * kChunk);
  const int item = blockIdx.x % p.n_items;
  const long long b = blockIdx.x / p.n_items;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* it = p.items + item * kItem;
  const int j0 = it[0], k0 = it[1], a_begin = it[2], a_count = it[3];
  const bool sym = it[4] != 0;
  const int S = p.S, V = p.V, A = p.A;
  const long long plane = p.plane;
  const double* t = p.t + b * S;
  const double* g = p.g + b * S;
  double* out = p.out + b * V * V * A;
  // stage rows: 3*KT j rows, then (off the diagonal) 3*KT k rows, then 9 t
  // rows per alpha of the round
  const bool diag = j0 == k0;
  const int krow = diag ? 0 : 3 * KT;
  const int trow = diag ? 3 * KT : 6 * KT;
  const int n_units = a_count * T::kPatches;

  for (int u0 = 0; u0 < n_units; u0 += kWarps) {
    const int a_lo = u0 / T::kPatches;
    const int n_ra = (min(u0 + kWarps, n_units) - 1) / T::kPatches - a_lo + 1;
    const int n_rows = trow + 9 * n_ra;
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
      const double* src = nullptr;
      if (r < trow) {
        const bool is_k = r >= 3 * KT;
        const int q = is_k ? r - 3 * KT : r;
        const int first = is_k ? k0 : j0;
        if (first + q / 3 < V) src = g + (3LL * first + q) * plane;
      } else {
        const int ai = (r - trow) / 9, c = (r - trow) % 9;
        const int a = p.alist[a_begin + a_lo + ai];
        src = t + static_cast<long long>(p.expand[a * 9 + c]) * plane;
      }
      rows[r] = src;
    }
    __syncthreads();

    const int u = u0 + warp;
    const int ai = u / T::kPatches, patch = u % T::kPatches;
    const int jb = j0 + (patch / T::kNk) * PJ;
    const int kb = k0 + (patch % T::kNk) * PK;
    const unsigned act = u < n_units ? dmx::patch_mask(jb, kb, V, sym) : 0u;
    const int gj = 3 * (jb - j0), gk = krow + 3 * (kb - k0);
    int to[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) to[c] = (trow + 9 * (ai - a_lo) + c) * kChunk;
    dmx::Acc<PJ * PK> acc;
    acc.init();
    dmx::stream_chunks<kChunk>(
        smem, rows, n_rows, S, p.vec, [&](const double* stage, int n) {
          dmx::patch_chunk_any<kChunk>(stage, n, gj, gk, to, act, acc);
        });
    if (act != 0) {
      const int a = p.alist[a_begin + ai];
#pragma unroll
      for (int dj = 0; dj < PJ; ++dj) {
#pragma unroll
        for (int dk = 0; dk < PK; ++dk) {
          if ((act >> (dj * PK + dk)) & 1u) {
            const double v = dmx::warp_sum(acc.log_sum(dj * PK + dk));
            const int j = jb + dj, k = kb + dk;
            if (lane == 0) {
              out[(j * V + k) * A + a] = v;
              if (sym && k > j) out[(k * V + j) * A + a] = v;
            }
          }
        }
      }
    }
    // stream_chunks ended on a barrier after every read of the row
    // pointers, so the next round may rewrite them
  }
}

template <int KT>
int launch(const Params& p, long long n_blocks, cudaStream_t stream) {
  constexpr int bytes = Tile<KT>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      pair_tiled_exact_kernel<KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tiled_exact_kernel<KT>
      <<<static_cast<unsigned>(n_blocks), kWarps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// The dynamic shared memory K7' takes with tile extent `tile` (bytes), or 0
// for an extent it does not take.
int dmx_pair_tiled_exact_smem(int tile) {
  return tile == 8 ? Tile<8>::kSmem : tile == 16 ? Tile<16>::kSmem : 0;
}

// Launches K7' on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V+3, B, S), expand (A*9), items (n_items, 5) and alist
// on the device; out (B, V*V*A) allocated by the caller, which also fills
// the channels no item writes. tile: the items' extent, 8 or 16.
int dmx_pair_tiled_exact(const double* t, const double* g, const int* expand,
                         const int* items, const int* alist, double* out,
                         int B, int S, int V, int A, int n_items, int tile,
                         void* stream) {
  Params p;
  p.t = t;
  p.g = g;
  p.expand = expand;
  p.items = items;
  p.alist = alist;
  p.out = out;
  p.plane = (long long)B * S;
  p.S = S;
  p.V = V;
  p.A = A;
  p.n_items = n_items;
  p.vec = S % 2 == 0 && aligned16(t) && aligned16(g);
  const long long n_blocks = (long long)B * n_items;
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL ||
      S > 32LL * dmx::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 8) return launch<8>(p, n_blocks, st);
  if (tile == 16) return launch<16>(p, n_blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
