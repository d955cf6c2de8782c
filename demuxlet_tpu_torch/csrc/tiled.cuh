// The tiled pair search over (j, k) tiles: the body of K7'
// (pair_tiled_exact.cu, f64) and K5' (pair_tiled_fast.cu, f32), whose
// sources say what it replaces, what limits it and why it is laid out so.
//
// One block owns one (cell, item) and streams the cell's slots in chunks of
// kTiledChunk through two shared-memory stages (stage.cuh): the tile's j
// rows, its k rows (once, on diagonal tiles) and the 9 t rows of the alphas
// of the current round. Each warp owns one PJ x NK patch of (j, k) channels
// of one alpha (NK: 4 in K7', 8 in K5'); a KT x KT tile is
// (KT / PJ) * (KT / NK) patches per alpha, and a block of kTiledWarps<NK>
// warps takes the item's patches in rounds, each a pass over the slots.
// Products (logprod.cuh) end in one log per lane and a fixed warp-shuffle
// butterfly in f64, rounded to F once per channel.

#pragma once

#include <cuda_runtime.h>

#include "logprod.cuh"
#include "stage.cuh"

namespace dmx {

// Warps per block: one per patch of a 16 x 16 tile's alpha (4 x 4 patches:
// 16 warps of up to 128 registers a thread; 4 x 8 patches: 8 warps, two
// blocks an SM).
template <int NK>
constexpr int kTiledWarps = (16 / PJ) * (16 / NK);
constexpr int kItem = 5;  // ints per item: j0, k0, a_begin, a_count, sym
constexpr int kTiledChunk = 128;  // 6% faster than 64 on K7' (PERF.md)

template <class F>
struct TiledParams {
  const F* t;         // (C, B, S)
  const F* g;         // (3V [+ 3], B, S): rows j*3 + l of the V samples
  const int* expand;  // (A*9,) rows of t
  const int* items;   // (n_items, kItem)
  const int* alist;   // the alpha indices the items' slices index
  F* out;             // (B, V*V*A)
  long long plane;    // B*S: stride between channels
  int S, V, A, n_items;
  bool vec;  // 16-byte copies: S % (16 / sizeof(F)) == 0, tensors aligned
};

// A KT tile's patches and the most rows a round stages: j rows, k rows,
// and the 9 t rows of each alpha its warps' patches can touch.
template <int KT, int NK, class F>
struct Tile {
  static_assert(KT % PJ == 0 && KT % NK == 0, "patches must tile KT");
  static constexpr int kWarps = kTiledWarps<NK>;
  static constexpr int kNk = KT / NK;
  static constexpr int kPatches = (KT / PJ) * kNk;
  // a round's units are kWarps consecutive ones, alpha-major: it touches
  // kWarps / kPatches alphas, or one
  static_assert(kWarps % kPatches == 0 || kPatches % kWarps == 0,
                "rounds must not straddle alphas unevenly");
  static constexpr int kRoundAlphas =
      kWarps > kPatches ? kWarps / kPatches : 1;
  static constexpr int kRows = 6 * KT + 9 * kRoundAlphas;
  static constexpr int kSmem = 2 * kRows * kTiledChunk * sizeof(F) +
                               kRows * sizeof(const F*);
};

// The kernel body; smem: the block's dynamic shared memory (Tile::kSmem).
template <int KT, int NK, class F>
__device__ __forceinline__ void pair_tiled_body(const TiledParams<F>& p,
                                                F* smem) {
  using T = Tile<KT, NK, F>;
  constexpr int CH = kTiledChunk;
  const F** rows = reinterpret_cast<const F**>(smem + 2 * T::kRows * CH);
  const int item = blockIdx.x % p.n_items;
  const long long b = blockIdx.x / p.n_items;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* it = p.items + item * kItem;
  const int j0 = it[0], k0 = it[1], a_begin = it[2], a_count = it[3];
  const bool sym = it[4] != 0;
  const int S = p.S, V = p.V, A = p.A;
  const long long plane = p.plane;
  const F* t = p.t + b * S;
  const F* g = p.g + b * S;
  F* out = p.out + b * V * V * A;
  // stage rows: 3*KT j rows, then (off the diagonal) 3*KT k rows, then 9 t
  // rows per alpha of the round
  const bool diag = j0 == k0;
  const int krow = diag ? 0 : 3 * KT;
  const int trow = diag ? 3 * KT : 6 * KT;
  const int n_units = a_count * T::kPatches;

  for (int u0 = 0; u0 < n_units; u0 += T::kWarps) {
    const int a_lo = u0 / T::kPatches;
    const int n_ra =
        (min(u0 + T::kWarps, n_units) - 1) / T::kPatches - a_lo + 1;
    const int n_rows = trow + 9 * n_ra;
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
      const F* src = nullptr;
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
    const int kb = k0 + (patch % T::kNk) * NK;
    const unsigned act = u < n_units ? patch_mask<NK>(jb, kb, V, sym) : 0u;
    const int gj = 3 * (jb - j0), gk = krow + 3 * (kb - k0);
    int to[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) to[c] = (trow + 9 * (ai - a_lo) + c) * CH;
    Acc<PJ * NK, F> acc;
    acc.init();
    stream_chunks<CH, F>(smem, rows, n_rows, S, p.vec,
                         [&](const F* stage, int n) {
                           patch_chunk_any<CH, NK>(stage, n, gj, gk, to,
                                                   act, acc);
                         });
    if (act != 0) {
      const int a = p.alist[a_begin + ai];
#pragma unroll
      for (int dj = 0; dj < PJ; ++dj) {
#pragma unroll
        for (int dk = 0; dk < NK; ++dk) {
          if ((act >> (dj * NK + dk)) & 1u) {
            const F v = static_cast<F>(warp_sum(acc.log_sum(dj * NK + dk)));
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

// Sets the kernel's dynamic shared memory and launches it on B * n_items
// blocks; returns the first CUDA error (0 on success).
template <int KT, int NK, class F>
int launch_tiled(void (*kernel)(TiledParams<F>), const TiledParams<F>& p,
                 int B, cudaStream_t stream) {
  constexpr int bytes = Tile<KT, NK, F>::kSmem;
  const long long n_blocks = static_cast<long long>(B) * p.n_items;
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL ||
      p.S > 32LL * kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_blocks), kTiledWarps<NK> * 32, bytes,
           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch parameters of the tiled kernels' C entry points.
template <class F>
TiledParams<F> tiled_params(const F* t, const F* g, const int* expand,
                            const int* items, const int* alist, F* out,
                            int B, int S, int V, int A, int n_items) {
  TiledParams<F> p;
  p.t = t;
  p.g = g;
  p.expand = expand;
  p.items = items;
  p.alist = alist;
  p.out = out;
  p.plane = static_cast<long long>(B) * S;
  p.S = S;
  p.V = V;
  p.A = A;
  p.n_items = n_items;
  p.vec = S % (16 / static_cast<int>(sizeof(F))) == 0 && aligned16(t) &&
          aligned16(g);
  return p;
}

}  // namespace dmx
