// K3': exact-mode pair search and singlet term for Hopper (sm_90a), in f64.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair_exact.py::
// _pair_kernel_df (launched by _call_pair_kernel_df) on the unrolled path,
// V*V*A <= 384. The TPU kernel multiplied df32 products with exponent
// tracking and took one log per accumulator, because the TPU has no f64;
// this kernel is K1 (pair_fast.cu) in native f64 and sums logs.
//
// What it computes, per cell b and slot s (t: the front's mixture table,
// C deduplicated channels that expand maps onto the A*9 logical (a, l, m)
// channels; g: per-slot genotype posteriors, rows j*3 + l for the V
// samples, then the three rows of the host f64 background gp0; gl: the
// pass-1 GL table):
//   U[j,a,m]        = sum_l g[j,l] * t[a,l,m]
//   inner[j,k,a]    = sum_m g[k,m] * U[j,a,m]
//   llk_ab[b,j,k,a] = sum_s log inner[j,k,a]
//   llk_00[b,a]     = the same with j = k = gp0
//   llk[b,j]        = sum_s log(gl[0] g[j,0] + gl[1] g[j,1] + gl[2] g[j,2])
//   llk0[b]         = the same with gp0.
// a0_sep: the alpha == 0 plane is separable, llk_ab[j,k,0] = sum_s log d[j]
// + sum_s log gsum[k] with d[j] = g[j] . t[0,:,0] and gsum[k] = the sum of
// g[k]; llk_00[0] likewise from gp0. sym_a (>= 0): the alpha == 0.5 plane
// is (j,k)-symmetric; only k >= j is computed and the j > k channels are
// copies. A masked slot carries t == 1, neutral rows (1, 0, 0) and
// gl == (1, 0, 0), so it adds log 1 == 0 exactly.
//
// What bounds it on this card: per slot it reads 3V + 6 + C doubles and
// spends about V*V*A f64 logs (V=8, A=5: ~260 with a0_sep and sym_a),
// each a software routine of a few dozen f64 instructions, so it is bound
// by the SMs' f64 pipes, not by HBM.
//
// What the design does about it: K1's layout. One block owns one cell and
// loops over all of its slots; each warp takes whole tasks (one (j, a) row
// of accumulators over k, the background row, one of the two separable
// alpha == 0 factor rows, or the singlet row); lanes stride over slots, so
// loads are coalesced along s. Sums live in registers (the k loop unrolled
// to a compile-time bound MAXV, 8 or 20, with a uniform guard) and end in a
// fixed warp-shuffle butterfly: no atomics, so runs give identical bits.
// Shapes, V, A, a0_sep, sym_a and expand are runtime arguments.
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
  double* out_ab;     // (B, V*V*A)
  double* out_00;     // (B, A)
  double* out_s;      // (B, V)
  double* out_s0;     // (B,)
  long long plane;    // B*S: stride between channels
  int S, V, A, a0_sep, sym_a;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int MAXV>
__global__ void __launch_bounds__(kWarps * 32)
pair_exact_kernel(Params p) {
  // separable alpha == 0 sums: [0] log d[j] (index MAXV: log d0),
  // [1] log gsum[k] (index MAXV: log g0sum)
  __shared__ double sep[2][MAXV + 1];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.S, V = p.V, A = p.A;
  const long long plane = p.plane;
  const double* t = p.t + (long long)b * S;
  const double* g = p.g + (long long)b * S;
  const double* g0 = g + 3LL * V * plane;  // the host background rows
  const double* gl = p.gl + (long long)b * S;
  double* out_ab = p.out_ab + (long long)b * V * V * A;
  double* out_00 = p.out_00 + (long long)b * A;
  const int nac = A - p.a0_sep;      // alphas with a pair plane
  const int n_pair = (V + 1) * nac;  // row V is the background gp0
  const int n_sep = 2 * p.a0_sep;
  const int n_tasks = n_pair + n_sep + 1;  // the last task: singlet row

  for (int task = warp; task < n_tasks; task += kWarps) {
    double acc[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) acc[i] = 0.0;
    double acc_bg = 0.0;
    if (task < n_pair) {
      const int j = task / nac;
      const int a = p.a0_sep + task % nac;
      const bool bg = j == V;
      const int k_lo = (a == p.sym_a && !bg) ? j : 0;
      const double* gj = bg ? g0 : g + (j * 3) * plane;
      int e[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) e[i] = p.expand[a * 9 + i];
      for (int s = lane; s < S; s += 32) {
        const double gj0 = gj[s], gj1 = gj[plane + s], gj2 = gj[2 * plane + s];
        double u[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          u[m] = gj0 * t[e[m] * plane + s] + gj1 * t[e[3 + m] * plane + s] +
                 gj2 * t[e[6 + m] * plane + s];
        }
        if (bg) {
          acc_bg += log(gj0 * u[0] + gj1 * u[1] + gj2 * u[2]);
        } else {
#pragma unroll
          for (int k = 0; k < MAXV; ++k) {
            if (k < V && k >= k_lo) {
              const double* gk = g + (k * 3) * plane + s;
              acc[k] += log(gk[0] * u[0] + gk[plane] * u[1] +
                            gk[2 * plane] * u[2]);
            }
          }
        }
      }
      if (bg) {
        const double v = warp_sum(acc_bg);
        if (lane == 0) out_00[a] = v;
      } else {
#pragma unroll
        for (int k = 0; k < MAXV; ++k) {
          if (k < V && k >= k_lo) {
            const double v = warp_sum(acc[k]);
            if (lane == 0) {
              out_ab[(j * V + k) * A + a] = v;
              if (a == p.sym_a && k > j) out_ab[(k * V + j) * A + a] = v;
            }
          }
        }
      }
    } else if (task < n_pair + n_sep) {
      // separable alpha == 0 factors: d[j] = g[j] . t[0, :, 0] (is_d) or
      // gsum[k] = g[k,0] + g[k,1] + g[k,2]; the background row rides along
      const bool is_d = task == n_pair;
      const int e0 = p.expand[0], e3 = p.expand[3], e6 = p.expand[6];
      for (int s = lane; s < S; s += 32) {
        double t0 = 0.0, t3 = 0.0, t6 = 0.0;
        if (is_d) {
          t0 = t[e0 * plane + s];
          t3 = t[e3 * plane + s];
          t6 = t[e6 * plane + s];
        }
#pragma unroll
        for (int j = 0; j < MAXV; ++j) {
          if (j < V) {
            const double* gj = g + (j * 3) * plane + s;
            const double a0 = gj[0], a1 = gj[plane], a2 = gj[2 * plane];
            acc[j] += is_d ? log(a0 * t0 + a1 * t3 + a2 * t6)
                           : log(a0 + a1 + a2);
          }
        }
        const double b0 = g0[s], b1 = g0[plane + s], b2 = g0[2 * plane + s];
        acc_bg += is_d ? log(b0 * t0 + b1 * t3 + b2 * t6) : log(b0 + b1 + b2);
      }
      const int r = is_d ? 0 : 1;
#pragma unroll
      for (int j = 0; j < MAXV; ++j) {
        if (j < V) {
          const double v = warp_sum(acc[j]);
          if (lane == 0) sep[r][j] = v;
        }
      }
      const double v = warp_sum(acc_bg);
      if (lane == 0) sep[r][MAXV] = v;
    } else {
      // the singlet term (pass 1) for every sample and the background
      for (int s = lane; s < S; s += 32) {
        const double q0 = gl[s], q1 = gl[plane + s], q2 = gl[2 * plane + s];
#pragma unroll
        for (int j = 0; j < MAXV; ++j) {
          if (j < V) {
            const double* gj = g + (j * 3) * plane + s;
            acc[j] += log(q0 * gj[0] + q1 * gj[plane] + q2 * gj[2 * plane]);
          }
        }
        acc_bg += log(q0 * g0[s] + q1 * g0[plane + s] + q2 * g0[2 * plane + s]);
      }
#pragma unroll
      for (int j = 0; j < MAXV; ++j) {
        if (j < V) {
          const double v = warp_sum(acc[j]);
          if (lane == 0) p.out_s[(long long)b * V + j] = v;
        }
      }
      const double v = warp_sum(acc_bg);
      if (lane == 0) p.out_s0[b] = v;
    }
  }
  if (p.a0_sep) {
    __syncthreads();
    for (int i = threadIdx.x; i < V * V; i += blockDim.x) {
      const int j = i / V, k = i % V;
      out_ab[(j * V + k) * A] = sep[0][j] + sep[1][k];
    }
    if (threadIdx.x == 0) out_00[0] = sep[0][MAXV] + sep[1][MAXV];
  }
}

template <int MAXV>
void launch(const Params& p, int B, cudaStream_t stream) {
  pair_exact_kernel<MAXV><<<B, kWarps * 32, 0, stream>>>(p);
}

}  // namespace

extern "C" {

// Launches K3' on `stream` and returns cudaGetLastError() (0 on success).
// t (C, B, S), g (3V+3, B, S), gl (3, B, S), expand (A*9) on the device;
// out_ab (B, V*V*A), out_00 (B, A), out_s (B, V), out_s0 (B) allocated by
// the caller. sym_a < 0 means no symmetric plane.
int dmx_pair_exact(const double* t, const double* g, const double* gl,
                   const int* expand, double* out_ab, double* out_00,
                   double* out_s, double* out_s0, int B, int S, int V, int A,
                   int a0_sep, int sym_a, void* stream) {
  Params p;
  p.t = t;
  p.g = g;
  p.gl = gl;
  p.expand = expand;
  p.out_ab = out_ab;
  p.out_00 = out_00;
  p.out_s = out_s;
  p.out_s0 = out_s0;
  p.plane = (long long)B * S;
  p.S = S;
  p.V = V;
  p.A = A;
  p.a0_sep = a0_sep;
  p.sym_a = sym_a;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V <= 8) {
    launch<8>(p, B, st);
  } else if (V <= 20) {
    launch<20>(p, B, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
