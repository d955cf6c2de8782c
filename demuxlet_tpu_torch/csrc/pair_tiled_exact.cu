// K7': exact-mode tiled pair search for Hopper (sm_90a), in f64.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair_exact.py::
// _pair_kernel_df_tiled (launched by _call_pair_kernel_df_tiled) on pools
// with V*V*A > 384, where the unrolled K3' (pair_exact.cu) would need more
// accumulators than a thread holds. The TPU kernel multiplied df32 products
// with exponent tracking, one log per accumulator, because the TPU has no
// f64; this kernel sums native f64 logs, as K3' does.
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
// (1, 0, 0), so it adds log 1 == 0 exactly.
//
// What limits it on this card: per slot it reads 3V + the used t channels
// (doubles) and spends one f64 log per (j, k, alpha) channel (V=32, A=5:
// ~3,600), each a software routine of a few dozen f64 instructions, so it
// runs on the SMs' f64 pipes, not at HBM speed. The function needs no
// per-slot log (products with exponent renormalisation, one log per
// channel per cell, as the TPU kernel did): its bound is the bytes at
// V=32, A=2 and the dots at A=5, well below this kernel's time.
//
// What the design does about it: K3''s layout over a tile. One block owns
// one (cell, item) and loops over all of the cell's slots; each warp takes
// whole rows (one (j, alpha) of the tile, accumulators over the tile's k);
// lanes stride over slots, so loads are coalesced along s. The KT sums of a
// row live in registers (the k loop unrolled to the compile-time tile
// extent KT, 8 or 16, with uniform guards for the ragged edge k < V and
// the triangle k >= j) and end in a fixed warp-shuffle butterfly: no
// atomics, so runs give identical bits. Blocks of one cell are adjacent in
// the grid, so the cell's t and g rows are read from HBM about once and
// then from L2. Shapes, V, A, the tile list and expand are runtime
// arguments; only the tile extent is compile-time.
//
// Build without --use_fast_math: log must be the accurate f64 one.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kItem = 5;  // ints per item: j0, k0, a_begin, a_count, sym

struct Params {
  const double* t;    // (C, B, S)
  const double* g;    // (3V + 3, B, S)
  const int* expand;  // (A*9,) rows of t
  const int* items;   // (n_items, kItem)
  const int* alist;   // the alpha indices the items' slices index
  double* out;        // (B, V*V*A)
  long long plane;    // B*S: stride between channels
  int S, V, A, n_items;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
pair_tiled_exact_kernel(Params p) {
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
  const double* gk0 = g + (3LL * k0) * plane;
  double* out = p.out + b * V * V * A;
  const int n_rows = KT * a_count;

  for (int r = warp; r < n_rows; r += kWarps) {
    const int j = j0 + r / a_count;
    if (j >= V) continue;  // the ragged edge; uniform across the warp
    const int a = p.alist[a_begin + r % a_count];
    int e[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) e[i] = p.expand[a * 9 + i];
    double acc[KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) acc[i] = 0.0;
    const double* gj = g + (3LL * j) * plane;
    for (int s = lane; s < S; s += 32) {
      const double gj0 = gj[s], gj1 = gj[plane + s], gj2 = gj[2 * plane + s];
      double u[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        u[m] = gj0 * t[e[m] * plane + s] + gj1 * t[e[3 + m] * plane + s] +
               gj2 * t[e[6 + m] * plane + s];
      }
#pragma unroll
      for (int dk = 0; dk < KT; ++dk) {
        const int k = k0 + dk;
        if (k < V && (!sym || k >= j)) {
          const double* gk = gk0 + (3LL * dk) * plane + s;
          acc[dk] += log(gk[0] * u[0] + gk[plane] * u[1] +
                         gk[2 * plane] * u[2]);
        }
      }
    }
#pragma unroll
    for (int dk = 0; dk < KT; ++dk) {
      const int k = k0 + dk;
      if (k < V && (!sym || k >= j)) {
        const double v = warp_sum(acc[dk]);
        if (lane == 0) {
          out[(j * V + k) * A + a] = v;
          if (sym && k > j) out[(k * V + j) * A + a] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches K7' on `stream` and returns cudaGetLastError() (0 on success).
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
  const long long n_blocks = (long long)B * n_items;
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  if (tile == 8) {
    pair_tiled_exact_kernel<8><<<grid, kWarps * 32, 0, st>>>(p);
  } else if (tile == 16) {
    pair_tiled_exact_kernel<16><<<grid, kWarps * 32, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
