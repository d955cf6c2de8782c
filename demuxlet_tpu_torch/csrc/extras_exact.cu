// K6': the O(V) channels of the exact-mode tiled pair search, for Hopper
// (sm_90a), in f64.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair_exact.py::
// _extras_kernel_df (its pallas_call in _call_pair_kernel_df_tiled), the
// companion of K7' (pair_tiled_exact.cu) on pools with V*V*A > 384. The TPU
// kernel kept df32 product accumulators; this one sums native f64 logs.
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
// so it adds log 1 == 0 exactly.
//
// What limits it on this card: one f64 log per column per slot (~3V + A),
// against ~V*V*A in K7', so it is a small share of the block; per slot it
// reads 3V + 6 doubles of g, gl and up to 3 + 9 (A - 1) of t. The function
// needs no per-slot log (a column's inner values can multiply into a
// product with exponent renormalisation, one log per cell), so its bound
// is those bytes; the per-slot logs are this simple kernel's cost.
//
// What the design does about it: K3''s layout. One block owns one cell and
// loops over all of its slots; each warp takes whole columns; lanes stride
// over slots, so loads are coalesced along s; each column's sum lives in a
// register and ends in a fixed warp-shuffle butterfly: no atomics, so runs
// give identical bits. V, A, a0_sep and expand are runtime arguments.
//
// Build without --use_fast_math: log must be the accurate f64 one.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

struct Params {
  const double* t;    // (C, B, S)
  const double* g;    // (3V + 3, B, S)
  const double* gl;   // (3, B, S)
  const int* expand;  // (A*9,) rows of t
  double* out;        // (B, n_x)
  long long plane;    // B*S: stride between channels
  int S, V, A, a0_sep, n_x;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the kinds of column: singlet, d (alpha == 0 factor), gs (genotype sum),
// m0 (background pair channel of one alpha)
enum Kind { kSinglet, kD, kGs, kM0 };

__global__ void __launch_bounds__(kWarps * 32)
extras_exact_kernel(Params p) {
  const long long b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.S, V = p.V;
  const long long plane = p.plane;
  const double* t = p.t + b * S;
  const double* g = p.g + b * S;
  const double* gl = p.gl + b * S;

  for (int c = warp; c < p.n_x; c += kWarps) {
    // column c -> (kind, row j of g (V: gp0), alpha a)
    Kind kind;
    int j = V, a = 0;
    if (c <= V) {
      kind = kSinglet;
      j = c;
    } else if (p.a0_sep && c <= 3 * V + 2) {
      const int i = c - (V + 1);
      if (i < V) {
        kind = kD;
        j = i;
      } else if (i < 2 * V) {
        kind = kGs;
        j = i - V;
      } else {
        kind = i == 2 * V ? kD : kGs;  // u00, g0s: the background row
      }
    } else {
      kind = kM0;
      a = p.a0_sep ? 1 + c - (3 * V + 3) : c - (V + 1);
    }
    const double* r = g + (3LL * j) * plane;
    double acc = 0.0;
    if (kind == kSinglet) {
      for (int s = lane; s < S; s += 32) {
        acc += log(gl[s] * r[s] + gl[plane + s] * r[plane + s] +
                   gl[2 * plane + s] * r[2 * plane + s]);
      }
    } else if (kind == kD) {
      const double* t0 = t + p.expand[0] * plane;
      const double* t3 = t + p.expand[3] * plane;
      const double* t6 = t + p.expand[6] * plane;
      for (int s = lane; s < S; s += 32) {
        acc += log(r[s] * t0[s] + r[plane + s] * t3[s] +
                   r[2 * plane + s] * t6[s]);
      }
    } else if (kind == kGs) {
      for (int s = lane; s < S; s += 32) {
        acc += log(r[s] + r[plane + s] + r[2 * plane + s]);
      }
    } else {
      int e[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) e[i] = p.expand[a * 9 + i];
      for (int s = lane; s < S; s += 32) {
        const double r0 = r[s], r1 = r[plane + s], r2 = r[2 * plane + s];
        double u[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          u[m] = r0 * t[e[m] * plane + s] + r1 * t[e[3 + m] * plane + s] +
                 r2 * t[e[6 + m] * plane + s];
        }
        acc += log(r0 * u[0] + r1 * u[1] + r2 * u[2]);
      }
    }
    const double v = warp_sum(acc);
    if (lane == 0) p.out[b * p.n_x + c] = v;
  }
}

}  // namespace

extern "C" {

// Launches K6' on `stream` and returns cudaGetLastError() (0 on success).
// t (C, B, S), g (3V+3, B, S), gl (3, B, S) and expand (A*9) on the device;
// out (B, n_x) allocated by the caller, n_x = V + 1 + (a0_sep ? 2V + 2 : 0)
// + the number of non-separable alphas.
int dmx_extras_exact(const double* t, const double* g, const double* gl,
                     const int* expand, double* out, int B, int S, int V,
                     int A, int a0_sep, void* stream) {
  Params p;
  p.t = t;
  p.g = g;
  p.gl = gl;
  p.expand = expand;
  p.out = out;
  p.plane = (long long)B * S;
  p.S = S;
  p.V = V;
  p.A = A;
  p.a0_sep = a0_sep;
  p.n_x = V + 1 + (a0_sep ? 2 * V + 2 : 0) + A - (a0_sep ? 1 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  extras_exact_kernel<<<B, kWarps * 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
