// The O(V) columns beside the tiled pair kernels: the body of K6'
// (extras_exact.cu, f64, with the singlet columns) and K4' (extras_fast.cu,
// f32, without them), whose sources say what each replaces and what bounds
// it on this card.
//
// Per cell b, as columns of out (B, n_x) in the order of
// ops/pair_tiled.py::extras_keys (g rows j*3 + l of the V samples; g0 the
// host background rows; gl the pass-1 GL rows; t the front's mixture
// table, expand mapping the A*9 logical channels onto its rows):
//   s[j]   = sum_s log(gl . g[j])    j = 0..V (V: g0)     (K6' only)
// and, when the alpha == 0 plane is separable (a0_sep),
//   d[j]   = sum_s log(g[j] . t[0,:,0])                  j = 0..V-1
//   gs[k]  = sum_s log(g[k,0] + g[k,1] + g[k,2])         k = 0..V-1
//   u00    = d of g0,  g0s = gs of g0,
// then, for every alpha a that is not the separable one,
//   m0[a]  = sum_s log(g0 . (g0 t[a]))
// A masked slot carries t == 1, neutral rows (1, 0, 0) and gl == (1, 0, 0),
// so its inner values are exactly 1.
//
// One block owns one cell and streams its slots in chunks of CH slots
// through two shared-memory stages (stage.cuh), so every row is
// read from HBM once per cell. A unit is sample j (j = V: g0) with its
// columns (they read g_j once), or one non-separable alpha with its m0
// column; a kernel without singlet columns has sample units only when
// a0_sep. Each warp owns up to kUnits units of a round, its lanes over
// slots, one accumulator per column in registers (logprod.cuh's product:
// one f64 log per lane and column), then the fixed warp-shuffle butterfly
// in f64, rounded to F once per column: runs give identical bits. A round
// stages the head (gl, the alpha == 0 column of t and g0), 3 rows per
// sample and 9 per alpha; pools whose rows exceed the shared memory take
// several rounds, each a pass over the slots, planned by one function that
// host and device share (round_end). V, A, a0_sep and expand are runtime
// arguments.

#pragma once

#include <cuda_runtime.h>

#include "logprod.cuh"
#include "stage.cuh"

namespace dmx {

constexpr int kExtrasSmemMax = 227 * 1024;  // a block's
constexpr int kSmSmem = 228 * 1024;         // an SM's
constexpr int kBlockReserved = 1024;        // the system's share a block

// A kernel's compile-time shape: its scalar type F, whether it has the
// singlet columns (and so the gl rows), its warps, the units a warp owns
// in a round and the blocks an SM it is built for (its launch bounds).
template <class F_, bool kGl_, int kWarps_, int kUnits_, int kBlocks_>
struct ExtrasCfg {
  using F = F_;
  static constexpr bool kGl = kGl_;
  static constexpr int kWarps = kWarps_;
  static constexpr int kUnits = kUnits_;
  static constexpr int kBlocks = kBlocks_;
  static constexpr int kRoundUnits = kWarps * kUnits;
  // head rows: gl (kGl), then t[0,:,0] at kT0 and g0 at kG0
  static constexpr int kT0 = kGl ? 3 : 0;
  static constexpr int kG0 = kT0 + 3;
  static constexpr int kHead = kG0 + 3;
  static constexpr int kCols = kGl ? 3 : 2;  // a sample unit's columns
  // the most stage rows a chunk extent CH allows: two stages and a row
  // pointer per row
  template <int CH>
  static constexpr int kMaxRows =
      kExtrasSmemMax /
      (2 * CH * static_cast<int>(sizeof(F)) + static_cast<int>(sizeof(F*)));
};

template <class F>
struct ExtrasParams {
  const F* t;         // (C, B, S)
  const F* g;         // (3V, B, S): rows j*3 + l of the samples
  const F* g0;        // (3, B, S): the background rows
  const F* gl;        // (3, B, S), or null without singlet columns
  const int* expand;  // (A*9,) rows of t
  F* out;             // (B, n_x)
  long long plane;    // B*S: stride between channels
  int S, V, a0_sep, n_x;
  int n_s;       // sample units (V + 1, the last g0), or 0 if no column
                 // needs them
  int n_units;   // the sample units, then the non-separable alphas
  int max_rows;  // a round's row budget
  int stride;    // the stage stride: the largest round's rows
  bool vec;      // 16-byte copies: S a multiple of 16 bytes, aligned
};

// The stage rows of unit u: 3 for a sample, 0 for g0 (the head's), 9 for
// an alpha.
__host__ __device__ __forceinline__ int unit_rows(int u, int n_s) {
  return u < n_s - 1 ? 3 : (u == n_s - 1 ? 0 : 9);
}

// The round that starts at unit u0: its end unit and (rows) its stage rows,
// at most max_rows and kRoundUnits units.
template <class Cfg>
__host__ __device__ __forceinline__ int round_end(int u0, int n_units,
                                                  int n_s, int max_rows,
                                                  int* rows) {
  int r = Cfg::kHead, u = u0;
  while (u < n_units && u - u0 < Cfg::kRoundUnits &&
         r + unit_rows(u, n_s) <= max_rows) {
    r += unit_rows(u, n_s);
    ++u;
  }
  *rows = r;
  return u;
}

// One warp's unit: kind 0 none, 1 sample, 2 alpha; ro its g rows and to
// an alpha's 9 t rows in the stage (element offsets); its columns in out.
template <int C>
struct ExtrasUnit {
  int kind, ro, to, n_cols;
  int col[C];
};

// The inner values of a unit at slot s of the stage: a sample's singlet
// (kGl), d and gs; an alpha's m0.
template <class Cfg, int CH, class F>
__device__ __forceinline__ void unit_values(const F* st, int s,
                                            const ExtrasUnit<Cfg::kCols>& d,
                                            F x[Cfg::kCols]) {
  const F r0 = st[d.ro + s], r1 = st[d.ro + CH + s],
          r2 = st[d.ro + 2 * CH + s];
  if (d.kind == 1) {
    int c = 0;
    if constexpr (Cfg::kGl) {
      x[c++] = st[s] * r0 + st[CH + s] * r1 + st[2 * CH + s] * r2;
    }
    if (d.n_cols == Cfg::kCols) {
      constexpr int T0 = Cfg::kT0 * CH;
      x[c] = r0 * st[T0 + s] + r1 * st[T0 + CH + s] +
             r2 * st[T0 + 2 * CH + s];
      x[c + 1] = r0 + r1 + r2;
    }
  } else {
    const F* ta = st + d.to;
    F u[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      u[m] = r0 * ta[m * CH + s] + r1 * ta[(3 + m) * CH + s] +
             r2 * ta[(6 + m) * CH + s];
    }
    x[0] = r0 * u[0] + r1 * u[1] + r2 * u[2];
  }
}

// The kernel body; smem: the block's dynamic shared memory (the stages,
// then the row pointers). Acc: the accumulators of the warp's columns
// (logprod.cuh's Acc, or an interface like it).
template <class Cfg, int CH, class Acc>
__device__ __forceinline__ void extras_body(
    const ExtrasParams<typename Cfg::F>& p, typename Cfg::F* smem) {
  using F = typename Cfg::F;
  constexpr int kCols = Cfg::kCols;
  const F** rows =
      reinterpret_cast<const F**>(smem + 2 * p.stride * CH);
  const long long b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int V = p.V, n_s = p.n_s;
  const long long plane = p.plane;
  const F* t = p.t + b * p.S;
  const F* g = p.g + b * p.S;
  const F* g0 = p.g0 + b * p.S;
  const F* gl = Cfg::kGl ? p.gl + b * p.S : nullptr;
  const int s_cols = Cfg::kGl ? V + 1 : 0;  // the singlet columns
  const int m0_col = s_cols + (p.a0_sep ? 2 * V + 2 : 0);
  const int a_first = p.a0_sep ? 1 : 0;
  const int n_own = max(n_s - 1, 0);  // samples with rows of their own

  for (int u0 = 0; u0 < p.n_units;) {
    int n_rows;
    const int u1 = round_end<Cfg>(u0, p.n_units, n_s, p.max_rows, &n_rows);
    // samples with rows of their own: [j0, j1); alphas from unit ua
    const int j0 = min(u0, n_own), j1 = min(u1, n_own);
    const int ua = max(u0, n_s);
    const int arow = Cfg::kHead + 3 * (j1 - j0);
    const bool samples = u0 < n_s, need_g0 = u1 >= n_s;
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
      const F* src = nullptr;
      if (r < Cfg::kT0) {
        if (samples) src = gl + r * plane;
      } else if (r < Cfg::kG0) {
        if (samples && p.a0_sep) {
          src = t + static_cast<long long>(p.expand[(r - Cfg::kT0) * 3]) *
                        plane;
        }
      } else if (r < Cfg::kHead) {
        if (need_g0) src = g0 + (r - Cfg::kG0) * plane;
      } else if (r < arow) {
        src = g + (3LL * j0 + r - Cfg::kHead) * plane;
      } else {
        const int q = r - arow;
        const int a = a_first + ua - n_s + q / 9;
        src = t + static_cast<long long>(p.expand[a * 9 + q % 9]) * plane;
      }
      rows[r] = src;
    }
    __syncthreads();

    ExtrasUnit<kCols> un[Cfg::kUnits];
#pragma unroll
    for (int k = 0; k < Cfg::kUnits; ++k) {
      const int u = u0 + warp + k * Cfg::kWarps;
      ExtrasUnit<kCols>& d = un[k];
      d.kind = u >= u1 ? 0 : (u < n_s ? 1 : 2);
      d.to = (arow + 9 * (u - ua)) * CH;
      if (d.kind == 1) {
        d.ro = (u < n_own ? Cfg::kHead + 3 * (u - j0) : Cfg::kG0) * CH;
        d.n_cols = (Cfg::kGl ? 1 : 0) + (p.a0_sep ? 2 : 0);
        int c = 0;
        if constexpr (Cfg::kGl) d.col[c++] = u;
        d.col[c] = s_cols + (u < V ? u : 2 * V);              // d[j], u00
        d.col[c + 1] = s_cols + (u < V ? V + u : 2 * V + 1);  // gs[j], g0s
      } else {
        d.ro = Cfg::kG0 * CH;
        d.n_cols = d.kind == 2 ? 1 : 0;
        d.col[0] = m0_col + u - n_s;
#pragma unroll
        for (int c = 1; c < kCols; ++c) d.col[c] = 0;
      }
    }
    Acc acc;
    acc.init();
    stream_chunks<CH, F>(
        smem, rows, n_rows, p.S, p.vec, [&](const F* st, int n) {
#pragma unroll 1
          for (int s0 = 0; s0 < n; s0 += 32) {
            const int s = s0 + lane;
            const bool live = s < n;
            bool bad = false;
            if (live) {
#pragma unroll
              for (int k = 0; k < Cfg::kUnits; ++k) {
                if (un[k].kind == 0) continue;
                F x[kCols];
                unit_values<Cfg, CH>(st, s, un[k], x);
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                  if (c < un[k].n_cols) bad |= !acc.step(kCols * k + c, x[c]);
                }
              }
            }
            // the rare path, taken by the whole warp: the same values again
            if (__any_sync(0xffffffffu, bad) && live) {
#pragma unroll
              for (int k = 0; k < Cfg::kUnits; ++k) {
                if (un[k].kind == 0) continue;
                F x[kCols];
                unit_values<Cfg, CH>(st, s, un[k], x);
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                  if (c < un[k].n_cols) acc.fix(kCols * k + c, x[c]);
                }
              }
            }
          }
        });
#pragma unroll
    for (int k = 0; k < Cfg::kUnits; ++k) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < un[k].n_cols) {
          const F v = static_cast<F>(warp_sum(acc.log_sum(kCols * k + c)));
          if (lane == 0) p.out[b * p.n_x + un[k].col[c]] = v;
        }
      }
    }
    // stream_chunks ended on a barrier after every read of the row
    // pointers, so the next round may rewrite them
    u0 = u1;
  }
}

// The rounds of a pool at a row budget: their count and (rows) the largest
// round's stage rows.
template <class Cfg>
int plan_rounds(int n_units, int n_s, int max_rows, int* rows) {
  int n = 0, u = 0;
  *rows = 0;
  while (u < n_units) {
    int r;
    u = round_end<Cfg>(u, n_units, n_s, max_rows, &r);
    *rows = r > *rows ? r : *rows;
    ++n;
  }
  return n;
}

template <class Cfg>
int extras_smem(int ch, int stride) {
  using F = typename Cfg::F;
  return stride *
         (2 * ch * static_cast<int>(sizeof(F)) + static_cast<int>(sizeof(F*)));
}

// The chunk extent of a pool, its stage stride and row budget: the extent
// with fewer rounds (more rows fit a round), and on a tie 128 slots unless
// its stages keep Cfg::kBlocks blocks from sharing an SM where 64's do not
// (K4' at V=32, A=5: two blocks of 64-slot chunks took 18% less time than
// one of 128, PERF.md).
template <class Cfg>
int choose_chunk(int n_units, int n_s, int* stride, int* max_rows) {
  int r128, r64;
  const int n128 =
      plan_rounds<Cfg>(n_units, n_s, Cfg::template kMaxRows<128>, &r128);
  const int n64 =
      plan_rounds<Cfg>(n_units, n_s, Cfg::template kMaxRows<64>, &r64);
  const auto shares = [](int bytes) {
    return Cfg::kBlocks * (bytes + kBlockReserved) <= kSmSmem;
  };
  const int ch = n128 != n64 ? (n128 < n64 ? 128 : 64)
                 : shares(extras_smem<Cfg>(128, r128)) ||
                         !shares(extras_smem<Cfg>(64, r64))
                     ? 128
                     : 64;
  *stride = ch == 128 ? r128 : r64;
  *max_rows =
      ch == 128 ? Cfg::template kMaxRows<128> : Cfg::template kMaxRows<64>;
  return ch;
}

// The launch parameters of a pool (chunk: the extent it takes), or the
// chunk 0 for a shape the kernels refuse. g0: the background rows; gl:
// null without singlet columns.
template <class Cfg>
ExtrasParams<typename Cfg::F> extras_params(
    const typename Cfg::F* t, const typename Cfg::F* g,
    const typename Cfg::F* g0, const typename Cfg::F* gl, const int* expand,
    typename Cfg::F* out, int B, int S, int V, int A, int a0_sep,
    int* chunk) {
  using F = typename Cfg::F;
  ExtrasParams<F> p;
  p.t = t;
  p.g = g;
  p.g0 = g0;
  p.gl = gl;
  p.expand = expand;
  p.out = out;
  p.plane = static_cast<long long>(B) * S;
  p.S = S;
  p.V = V;
  p.a0_sep = a0_sep;
  p.n_s = Cfg::kGl || a0_sep ? V + 1 : 0;
  p.n_units = p.n_s + A - (a0_sep ? 1 : 0);
  p.n_x = (Cfg::kGl ? V + 1 : 0) + (a0_sep ? 2 * V + 2 : 0) + A -
          (a0_sep ? 1 : 0);
  *chunk = B < 1 || S < 1 || S > 32LL * kMaxSteps
               ? 0
               : choose_chunk<Cfg>(p.n_units, p.n_s, &p.stride, &p.max_rows);
  constexpr int W = 16 / static_cast<int>(sizeof(F));
  p.vec = S % W == 0 && aligned16(t) && aligned16(g) && aligned16(g0) &&
          (gl == nullptr || aligned16(gl));
  return p;
}

// Sets the kernel's dynamic shared memory and launches it on one block per
// cell; returns the first CUDA error (0 on success).
template <class Cfg, int CH>
int launch_extras(void (*kernel)(ExtrasParams<typename Cfg::F>),
                  const ExtrasParams<typename Cfg::F>& p, int B,
                  cudaStream_t stream) {
  const int bytes = extras_smem<Cfg>(CH, p.stride);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, Cfg::kWarps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dmx
