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
// What the design does about it (stage.cuh and logprod.cuh as K3' and K7'
// use them): one block owns one cell and streams its slots in chunks of CH
// slots (128, or 64 where a round's rows would not fit two stages of 128)
// through two shared-memory stages (cp.async; chunk c + 1 lands while chunk
// c is computed), so every row is read from HBM once per cell. A unit is
// sample j with its s, d and gs columns (they read g_j once), or one
// non-separable alpha with its m0 column; each warp owns up to kUnits units
// of a round, its lanes over slots, one product accumulator per column in
// registers: one f64 log per lane and column, then the fixed warp-shuffle
// butterfly, so runs give identical bits. A round stages gl, the alpha == 0
// t column and g0 (9 rows), 3 rows per sample and 9 per alpha; pools whose
// rows exceed the shared memory take several rounds, each a pass over the
// slots. V, A, a0_sep and expand are runtime arguments. It runs at ~1.5x
// its bytes: the staging alone and the arithmetic alone each take ~70% of
// its time, so their overlap sets it (PERF.md).
//
// Build without --use_fast_math: log must be the accurate f64 one.

#include <cuda_runtime.h>

#include "logprod.cuh"
#include "stage.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kUnits = 3;  // units per warp and round
constexpr int kRoundUnits = kWarps * kUnits;
constexpr int kHead = 9;  // stage rows 0-2 gl, 3-5 t[0,:,0], 6-8 g0
constexpr int kSmemMax = 227 * 1024;

// The most stage rows a chunk extent CH allows: two stages and a row
// pointer per row.
template <int CH>
constexpr int kMaxRows = kSmemMax / (2 * CH * 8 + 8);

struct Params {
  const double* t;    // (C, B, S)
  const double* g;    // (3V + 3, B, S)
  const double* gl;   // (3, B, S)
  const int* expand;  // (A*9,) rows of t
  double* out;        // (B, n_x)
  long long plane;    // B*S: stride between channels
  int S, V, a0_sep, n_x;
  int n_units;   // V + 1 samples (V: gp0), then the non-separable alphas
  int max_rows;  // a round's row budget
  int stride;    // the stage stride: the largest round's rows
  bool vec;      // 16-byte copies: S even, tensors aligned
};

// The stage rows of unit u: 3 for a sample, 0 for gp0 (the head's g0), 9
// for an alpha.
__host__ __device__ __forceinline__ int unit_rows(int u, int V) {
  return u < V ? 3 : (u == V ? 0 : 9);
}

// The round that starts at unit u0: its end unit and (rows) its stage rows,
// at most max_rows and kRoundUnits units.
__host__ __device__ __forceinline__ int round_end(int u0, int n_units, int V,
                                                  int max_rows, int* rows) {
  int r = kHead, u = u0;
  while (u < n_units && u - u0 < kRoundUnits &&
         r + unit_rows(u, V) <= max_rows) {
    r += unit_rows(u, V);
    ++u;
  }
  *rows = r;
  return u;
}

// One warp's unit: kind 0 none, 1 sample, 2 alpha; ro its g rows and to
// an alpha's 9 t rows in the stage (element offsets); its columns in out.
struct Unit {
  int kind, ro, to, n_cols;
  int col[3];
};

// The inner values of a unit at slot s of the stage.
template <int CH>
__device__ __forceinline__ void unit_values(const double* st, int s,
                                            const Unit& d, double x[3]) {
  const double r0 = st[d.ro + s], r1 = st[d.ro + CH + s],
               r2 = st[d.ro + 2 * CH + s];
  if (d.kind == 1) {
    x[0] = st[s] * r0 + st[CH + s] * r1 + st[2 * CH + s] * r2;
    if (d.n_cols == 3) {
      x[1] = r0 * st[3 * CH + s] + r1 * st[4 * CH + s] + r2 * st[5 * CH + s];
      x[2] = r0 + r1 + r2;
    }
  } else {
    const double* ta = st + d.to;
    double u[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      u[m] = r0 * ta[m * CH + s] + r1 * ta[(3 + m) * CH + s] +
             r2 * ta[(6 + m) * CH + s];
    }
    x[0] = r0 * u[0] + r1 * u[1] + r2 * u[2];
  }
}

template <int CH>
__global__ void __launch_bounds__(kWarps * 32, 1)
extras_exact_kernel(Params p) {
  extern __shared__ double smem[];  // 2 stages, then the row pointers
  const double** rows =
      reinterpret_cast<const double**>(smem + 2 * p.stride * CH);
  const long long b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int V = p.V;
  const long long plane = p.plane;
  const double* t = p.t + b * p.S;
  const double* g = p.g + b * p.S;
  const double* gl = p.gl + b * p.S;
  const int m0_col = V + 1 + (p.a0_sep ? 2 * V + 2 : 0);
  const int a_first = p.a0_sep ? 1 : 0;

  for (int u0 = 0; u0 < p.n_units;) {
    int n_rows;
    const int u1 = round_end(u0, p.n_units, V, p.max_rows, &n_rows);
    // samples with rows of their own: [j0, j1); alphas from unit ua
    const int j0 = min(u0, V), j1 = min(u1, V);
    const int ua = max(u0, V + 1);
    const int arow = kHead + 3 * (j1 - j0);
    const bool samples = u0 <= V, g0 = u1 > V;
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
      const double* src = nullptr;
      if (r < 3) {
        if (samples) src = gl + r * plane;
      } else if (r < 6) {
        if (samples && p.a0_sep) {
          src = t + static_cast<long long>(p.expand[(r - 3) * 3]) * plane;
        }
      } else if (r < kHead) {
        if (g0) src = g + (3LL * V + r - 6) * plane;
      } else if (r < arow) {
        src = g + (3LL * j0 + r - kHead) * plane;
      } else {
        const int q = r - arow;
        const int a = a_first + ua - (V + 1) + q / 9;
        src = t + static_cast<long long>(p.expand[a * 9 + q % 9]) * plane;
      }
      rows[r] = src;
    }
    __syncthreads();

    Unit un[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + warp + k * kWarps;
      Unit& d = un[k];
      d.kind = u >= u1 ? 0 : (u <= V ? 1 : 2);
      d.to = (arow + 9 * (u - ua)) * CH;
      if (d.kind == 1) {
        d.ro = (u < V ? kHead + 3 * (u - j0) : 6) * CH;
        d.n_cols = p.a0_sep ? 3 : 1;
        d.col[0] = u;
        d.col[1] = u < V ? V + 1 + u : 3 * V + 1;  // d[j], u00
        d.col[2] = u < V ? 2 * V + 1 + u : 3 * V + 2;  // gs[j], g0s
      } else {
        d.ro = 6 * CH;  // g0
        d.n_cols = d.kind == 2 ? 1 : 0;
        d.col[0] = m0_col + u - (V + 1);
        d.col[1] = d.col[2] = 0;
      }
    }
    dmx::Acc<3 * kUnits> acc;
    acc.init();
    dmx::stream_chunks<CH, double>(
        smem, rows, n_rows, p.S, p.vec, [&](const double* st, int n) {
#pragma unroll 1
          for (int s0 = 0; s0 < n; s0 += 32) {
            const int s = s0 + lane;
            const bool live = s < n;
            bool bad = false;
            if (live) {
#pragma unroll
              for (int k = 0; k < kUnits; ++k) {
                if (un[k].kind == 0) continue;
                double x[3];
                unit_values<CH>(st, s, un[k], x);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                  if (c < un[k].n_cols) bad |= !acc.step(3 * k + c, x[c]);
                }
              }
            }
            // the rare path, taken by the whole warp: the same values again
            if (__any_sync(0xffffffffu, bad) && live) {
#pragma unroll
              for (int k = 0; k < kUnits; ++k) {
                if (un[k].kind == 0) continue;
                double x[3];
                unit_values<CH>(st, s, un[k], x);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                  if (c < un[k].n_cols) acc.fix(3 * k + c, x[c]);
                }
              }
            }
          }
        });
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c < un[k].n_cols) {
          const double v = dmx::warp_sum(acc.log_sum(3 * k + c));
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
int plan_rounds(int n_units, int V, int max_rows, int* rows) {
  int n = 0, u = 0;
  *rows = 0;
  while (u < n_units) {
    int r;
    u = round_end(u, n_units, V, max_rows, &r);
    *rows = r > *rows ? r : *rows;
    ++n;
  }
  return n;
}

// The chunk extent and the launch's dynamic shared memory (bytes): 128
// slots unless 64 takes fewer rounds (more rows fit a round).
int choose_chunk(int n_units, int V, int* stride, int* max_rows) {
  int r128, r64;
  const int n128 = plan_rounds(n_units, V, kMaxRows<128>, &r128);
  const int n64 = plan_rounds(n_units, V, kMaxRows<64>, &r64);
  const int ch = n128 <= n64 ? 128 : 64;
  *stride = ch == 128 ? r128 : r64;
  *max_rows = ch == 128 ? kMaxRows<128> : kMaxRows<64>;
  return ch;
}

int smem_bytes(int ch, int stride) {
  return stride * (2 * ch * 8 + 8);
}

int n_units_of(int V, int A, int a0_sep) {
  return V + 1 + A - (a0_sep ? 1 : 0);
}

template <int CH>
int launch(const Params& p, int B, cudaStream_t st) {
  const int bytes = smem_bytes(CH, p.stride);
  const cudaError_t err = cudaFuncSetAttribute(
      extras_exact_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  extras_exact_kernel<CH><<<B, kWarps * 32, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The dynamic shared memory K6' takes for a pool (bytes).
int dmx_extras_exact_smem(int V, int A, int a0_sep) {
  int stride, max_rows;
  const int ch = choose_chunk(n_units_of(V, A, a0_sep), V, &stride,
                              &max_rows);
  return smem_bytes(ch, stride);
}

// Launches K6' on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V+3, B, S), gl (3, B, S) and expand (A*9) on the device;
// out (B, n_x) allocated by the caller, n_x = V + 1 + (a0_sep ? 2V + 2 : 0)
// + the number of non-separable alphas.
int dmx_extras_exact(const double* t, const double* g, const double* gl,
                     const int* expand, double* out, int B, int S, int V,
                     int A, int a0_sep, void* stream) {
  if (B < 1 || S < 1 || S > 32LL * dmx::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.t = t;
  p.g = g;
  p.gl = gl;
  p.expand = expand;
  p.out = out;
  p.plane = static_cast<long long>(B) * S;
  p.S = S;
  p.V = V;
  p.a0_sep = a0_sep;
  p.n_units = n_units_of(V, A, a0_sep);
  p.n_x = V + 1 + (a0_sep ? 2 * V + 2 : 0) + A - (a0_sep ? 1 : 0);
  const int ch = choose_chunk(p.n_units, V, &p.stride, &p.max_rows);
  p.vec = S % 2 == 0 && dmx::aligned16(t) && dmx::aligned16(g) &&
          dmx::aligned16(gl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ch == 128 ? launch<128>(p, B, st) : launch<64>(p, B, st);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
