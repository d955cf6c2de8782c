// K4': the O(V) channels of the fast-mode tiled pair search, for Hopper
// (sm_90a), in f32.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair.py::_extras_kernel
// (launched by _call_extras_only), the companion of K5' (pair_tiled_fast.cu)
// on pools with V*V*A > 384; on a single-point alpha == 0 grid it carries
// the whole pair search alone.
//
// What it computes, per cell b, as columns of out (B, n_x) in the order of
// ops/pair_tiled.py::extras_keys(..., singlets=False) (g rows j*3 + l for
// the V samples; g0 the three host background rows gp0, the TPU's
// host-exact gp0 planes, not a mean taken here; t the front's mixture
// table, expand mapping the A*9 logical channels onto its rows). When the
// alpha == 0 plane is separable (a0_sep),
//   d[j]   = sum_s log(g[j] . t[0,:,0])                  j = 0..V-1
//   gs[k]  = sum_s log(g[k,0] + g[k,1] + g[k,2])         k = 0..V-1
//   u00    = d of g0,  g0s = gs of g0,
// then, for every alpha a that is not the separable one,
//   m0[a]  = sum_s log(g0 . (g0 t[a]))
// The singlet sums are not here: fast mode's front computes them. A masked
// slot carries t == 1 and neutral rows (1, 0, 0), so it adds log 1 == 0
// exactly.
//
// What limits it on this card: one f32 log per column per slot (~2V + A),
// against ~V*V*A/2 in K5', so it is a small share of the block; per slot it
// reads 3V + 3 floats of g and g0 and up to 3 + 9 (A - 1) of t. The
// function needs no per-slot log (a column's inner values can multiply into
// a product with exponent renormalisation, one log per cell), so its bound
// is those bytes; the per-slot logs are this simple kernel's cost.
//
// What the design does about it: K6''s layout (extras_exact.cu) in f32.
// One block owns one cell and loops over all of its slots; each warp takes
// whole columns; lanes stride over slots, so loads are coalesced along s;
// each column's sum lives in a register and ends in a fixed warp-shuffle
// butterfly: no atomics, so runs give identical bits. V, A, a0_sep and
// expand are runtime arguments. g0 comes through its own pointer, so the
// caller never concatenates it to g.
//
// Build without --use_fast_math: the fast-mode contract (2e-5 relative)
// needs the accurate logf (1 ulp), not __logf.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

struct Params {
  const float* t;     // (C, B, S)
  const float* g;     // (3V, B, S)
  const float* g0;    // (3, B, S)
  const int* expand;  // (A*9,) rows of t
  float* out;         // (B, n_x)
  long long plane;    // B*S: stride between channels
  int S, V, A, a0_sep, n_x;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the kinds of column: d (alpha == 0 factor), gs (genotype sum), m0
// (background pair channel of one alpha)
enum Kind { kD, kGs, kM0 };

__global__ void __launch_bounds__(kWarps * 32)
extras_fast_kernel(Params p) {
  const long long b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.S, V = p.V;
  const long long plane = p.plane;
  const float* t = p.t + b * S;
  const float* g = p.g + b * S;
  const float* g0 = p.g0 + b * S;
  const int n_sep = p.a0_sep ? 2 * V + 2 : 0;

  for (int c = warp; c < p.n_x; c += kWarps) {
    // column c -> (kind, its g rows r (V: g0), alpha a)
    Kind kind;
    int j = V, a = 0;
    if (c < n_sep) {
      if (c < V) {
        kind = kD;
        j = c;
      } else if (c < 2 * V) {
        kind = kGs;
        j = c - V;
      } else {
        kind = c == 2 * V ? kD : kGs;  // u00, g0s: the background row
      }
    } else {
      kind = kM0;
      a = c - n_sep + p.a0_sep;
    }
    const float* r = j < V ? g + (3LL * j) * plane : g0;
    float acc = 0.f;
    if (kind == kD) {
      const float* t0 = t + p.expand[0] * plane;
      const float* t3 = t + p.expand[3] * plane;
      const float* t6 = t + p.expand[6] * plane;
      for (int s = lane; s < S; s += 32) {
        acc += logf(r[s] * t0[s] + r[plane + s] * t3[s] +
                    r[2 * plane + s] * t6[s]);
      }
    } else if (kind == kGs) {
      for (int s = lane; s < S; s += 32) {
        acc += logf(r[s] + r[plane + s] + r[2 * plane + s]);
      }
    } else {
      int e[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) e[i] = p.expand[a * 9 + i];
      for (int s = lane; s < S; s += 32) {
        const float r0 = r[s], r1 = r[plane + s], r2 = r[2 * plane + s];
        float u[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          u[m] = r0 * t[e[m] * plane + s] + r1 * t[e[3 + m] * plane + s] +
                 r2 * t[e[6 + m] * plane + s];
        }
        acc += logf(r0 * u[0] + r1 * u[1] + r2 * u[2]);
      }
    }
    const float v = warp_sum(acc);
    if (lane == 0) p.out[b * p.n_x + c] = v;
  }
}

}  // namespace

extern "C" {

// Launches K4' on `stream` and returns cudaGetLastError() (0 on success).
// t (C, B, S), g (3V, B, S), g0 (3, B, S) and expand (A*9) on the device;
// out (B, n_x) allocated by the caller, n_x = (a0_sep ? 2V + 2 : 0) + the
// number of non-separable alphas.
int dmx_extras_fast(const float* t, const float* g, const float* g0,
                    const int* expand, float* out, int B, int S, int V, int A,
                    int a0_sep, void* stream) {
  Params p;
  p.t = t;
  p.g = g;
  p.g0 = g0;
  p.expand = expand;
  p.out = out;
  p.plane = (long long)B * S;
  p.S = S;
  p.V = V;
  p.A = A;
  p.a0_sep = a0_sep;
  p.n_x = (a0_sep ? 2 * V + 2 : 0) + A - (a0_sep ? 1 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  extras_fast_kernel<<<B, kWarps * 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
