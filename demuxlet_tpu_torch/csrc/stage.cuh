// Slot chunks staged in shared memory, and the (j, k) accumulator patch
// that reads them: the common core of the pair kernels, in f64 (K3'
// pair_exact.cu, K7' pair_tiled_exact.cu) and in f32 (K1 pair_fast.cu, K5'
// pair_tiled_fast.cu), and the staging of the O(V) kernels K6' and K4'
// (extras.cuh).
//
// A block streams its cell's S slots through two shared-memory stages of
// n_rows x CH values of the scalar type F (row r of a stage: slots
// [s0, s0 + CH) of one global row; rows of one cell are contiguous in the
// (rows, B, S) layout). The copy of chunk c + 1 is in flight (cp.async, 16
// bytes where the rows allow it: 2 doubles or 4 floats) while the block
// computes on chunk c. Each warp reads the stage with its lanes over slots:
// 32 consecutive values per load, no bank conflict.
//
// A patch is PJ j rows x NK k rows of one alpha in one thread: per slot it
// loads PJ g_j rows, the 9 t values of the alpha and NK g_k rows, forms
// U[j, m] = sum_l g[j,l] t[l,m] once per j, and each g_k load then serves
// PJ channels. The accumulators are logprod.cuh's products; a warp whose
// lanes met no unsafe inner value in a slot (the rule) never branches.

#pragma once

#include <cuda_runtime.h>

#include "logprod.cuh"

// Measurement probes (chip_steps.py), never in a build of the kernels'
// results: 1 stages every chunk and computes nothing; 2 stages the first
// chunk once and computes on it for every chunk.
#ifndef DMX_PROBE
#define DMX_PROBE 0
#endif

namespace dmx {

// The patch of one thread: PJ j rows x NK k rows, one bit each in a
// channel mask. In f64, 4 x 4 at 16 warps (~128 registers a thread) beat
// 4 x 8 at 8 warps (~190) by 26% on K7' (PERF.md): PK, the extent of
// K3' and K7'. In f32 an accumulator takes 2 registers, not 3, so 4 x 8
// fits in 128 registers at 16 warps an SM: 13-17% faster than 4 x 4 on K1
// and K5' (PERF.md), which take NK = 8.
constexpr int PJ = 4;
constexpr int PK = 4;

__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

// Whether a tensor's base allows the stages' 16-byte copies.
inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15) == 0;
}

// cp.async of one value of BYTES (4 or 8; through L1) or of 16 bytes
// (bypassing L1)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copies slots [s0, s0 + n) of rows[0 .. n_rows) into buf (row r at
// buf + r * CH); a null row is skipped. vec: every row pointer and s0 are
// 16-byte aligned, so runs of 16 / sizeof(F) slots go as one 16-byte copy.
template <int CH, class F>
__device__ __forceinline__ void stage_chunk(F* buf, const F* const* rows,
                                            int n_rows, int s0, int n,
                                            bool vec) {
  if (vec) {
    constexpr int W = 16 / static_cast<int>(sizeof(F));
    constexpr int H = CH / W;
    static_assert(CH % W == 0, "whole 16-byte copies per chunk row");
    for (int i = threadIdx.x; i < n_rows * H; i += blockDim.x) {
      const int r = i / H, c = W * (i % H);
      const F* src = rows[r];
      if (src == nullptr || c >= n) continue;
      if (c + W <= n) {
        cp_async<16>(buf + r * CH + c, src + s0 + c);
      } else if constexpr (W == 2) {
        // the one slot left (a loop here cost K7' 3-10%: PERF.md)
        cp_async<sizeof(F)>(buf + r * CH + c, src + s0 + c);
      } else {
#pragma unroll
        for (int q = 0; q < W - 1; ++q) {  // at most W - 1 slots left
          if (c + q < n) {
            cp_async<sizeof(F)>(buf + r * CH + c + q, src + s0 + c + q);
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * CH; i += blockDim.x) {
      const int r = i / CH, c = i % CH;
      const F* src = rows[r];
      if (src != nullptr && c < n) {
        cp_async<sizeof(F)>(buf + i, src + s0 + c);
      }
    }
  }
}

// Streams S slots through the two stages at smem (2 x n_rows x CH values)
// and calls body(stage, n) on every thread once per chunk, n its slots,
// between barriers. Every thread of the block must call it.
template <int CH, class F, class Body>
__device__ __forceinline__ void stream_chunks(F* smem,
                                              const F* const* rows,
                                              int n_rows, int S, bool vec,
                                              Body body) {
  const int n_ch = (S + CH - 1) / CH;
  stage_chunk<CH>(smem, rows, n_rows, 0, min(CH, S), vec);
  cp_async_commit();
  for (int c = 0; c < n_ch; ++c) {
    if (c + 1 < n_ch && DMX_PROBE != 2) {
      const int s1 = (c + 1) * CH;
      stage_chunk<CH>(smem + ((c + 1) & 1) * n_rows * CH, rows, n_rows, s1,
                      min(CH, S - s1), vec);
    }
    cp_async_commit();
    cp_async_wait1();  // chunk c has landed; c + 1 may be in flight
    __syncthreads();
    if (DMX_PROBE != 1) {
      body(smem + (DMX_PROBE == 2 ? 0 : (c & 1) * n_rows * CH),
           min(CH, S - c * CH));
    }
    __syncthreads();  // the stage is free for chunk c + 2
  }
}

// One chunk of a PJ x NK patch, n slots at `stage`: g_j rows at stage rows
// gj + 3 dj + l, g_k rows at gk + 3 dk + l, the alpha's t rows at stage
// element offsets to[0..8] ((l, m) order; in registers or in shared
// memory). kGuard: only the channels whose bit (dj * NK + dk) is set in
// act are updated (ragged edge, triangle).
template <int CH, int NK, bool kGuard, int N, class F>
__device__ __forceinline__ void patch_chunk(const F* stage, int n, int gj,
                                            int gk, const int* to,
                                            unsigned act, Acc<N, F>& a) {
  static_assert(N >= PJ * NK, "the patch's accumulators");
  const F* pj = stage + gj * CH;
  const F* pk = stage + gk * CH;
#pragma unroll 1
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + (threadIdx.x & 31);
    const bool live = s < n;
    F u[PJ][3];
    bool bad = false;
    if (live) {
      // U one column m at a time: 3 t values live, not 9
      F gv[PJ][3];
#pragma unroll
      for (int dj = 0; dj < PJ; ++dj) {
#pragma unroll
        for (int l = 0; l < 3; ++l) gv[dj][l] = pj[(3 * dj + l) * CH + s];
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const F t0 = stage[to[m] + s], t1 = stage[to[3 + m] + s],
                t2 = stage[to[6 + m] + s];
#pragma unroll
        for (int dj = 0; dj < PJ; ++dj) {
          u[dj][m] = gv[dj][0] * t0 + gv[dj][1] * t1 + gv[dj][2] * t2;
        }
      }
#pragma unroll
      for (int dk = 0; dk < NK; ++dk) {
        const F k0 = pk[(3 * dk) * CH + s];
        const F k1 = pk[(3 * dk + 1) * CH + s];
        const F k2 = pk[(3 * dk + 2) * CH + s];
#pragma unroll
        for (int dj = 0; dj < PJ; ++dj) {
          if (!kGuard || ((act >> (dj * NK + dk)) & 1u)) {
            bad |= !a.step(dj * NK + dk,
                           k0 * u[dj][0] + k1 * u[dj][1] + k2 * u[dj][2]);
          }
        }
      }
    }
    // the rare path, taken by the whole warp: the same inner values again
    if (__any_sync(0xffffffffu, bad) && live) {
#pragma unroll
      for (int dk = 0; dk < NK; ++dk) {
        const F k0 = pk[(3 * dk) * CH + s];
        const F k1 = pk[(3 * dk + 1) * CH + s];
        const F k2 = pk[(3 * dk + 2) * CH + s];
#pragma unroll
        for (int dj = 0; dj < PJ; ++dj) {
          if (!kGuard || ((act >> (dj * NK + dk)) & 1u)) {
            a.fix(dj * NK + dk, k0 * u[dj][0] + k1 * u[dj][1] + k2 * u[dj][2]);
          }
        }
      }
    }
  }
}

// The channel mask of a PJ x NK patch at (j, k) = (jb + dj, kb + dk):
// k < V, j < V, and k >= j on the symmetric plane.
template <int NK>
__device__ __forceinline__ unsigned patch_mask(int jb, int kb, int V,
                                               bool sym) {
  unsigned act = 0;
#pragma unroll
  for (int dj = 0; dj < PJ; ++dj) {
#pragma unroll
    for (int dk = 0; dk < NK; ++dk) {
      const int j = jb + dj, k = kb + dk;
      if (j < V && k < V && (!sym || k >= j)) act |= 1u << (dj * NK + dk);
    }
  }
  return act;
}

// Runs patch_chunk with or without the guard, as the mask needs.
template <int CH, int NK, int N, class F>
__device__ __forceinline__ void patch_chunk_any(const F* stage, int n,
                                                int gj, int gk,
                                                const int* to, unsigned act,
                                                Acc<N, F>& a) {
  constexpr unsigned kFull =
      PJ * NK == 32 ? 0xffffffffu : (1u << (PJ * NK)) - 1u;
  if (act == kFull) {
    patch_chunk<CH, NK, false>(stage, n, gj, gk, to, act, a);
  } else if (act != 0) {
    patch_chunk<CH, NK, true>(stage, n, gj, gk, to, act, a);
  }
}

}  // namespace dmx
