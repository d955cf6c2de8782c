// K1: fast-mode pair-search kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair.py::_pair_kernel
// (launched by _call_pair_kernel) on the unrolled path, V*V*A <= 384.
//
// What it computes, per cell b and slot s (t: deduplicated mixture table,
// expand maps the A*9 logical channels (a, l, m) onto its rows; g: per-slot
// genotype posteriors, (j, l) major):
//   U[j,a,m]     = sum_l g[j,l] * t[a,l,m]
//   inner[j,k,a] = sum_m g[k,m] * U[j,a,m]
//   llk_ab[b,j,k,a] = sum_s log inner[j,k,a]
//   llk_00[b,a]     = the same with j = k = g0, the f32 sample mean of g
//                     summed in j order.
// a0_sep: the alpha == 0 plane is separable, llk_ab[j,k,0] = sum_s log d[j]
// + sum_s log gsum[k], and llk_00[0] = sum_s log d0 + sum_s log g0sum.
// sym_a (>= 0): the alpha == 0.5 plane is (j,k)-symmetric; only k >= j is
// computed and the j > k channels are copies, so ties resolve as in the
// JAX package.
//
// What bounds it on this card: per slot it reads 3V + C floats and spends
// about V*V*A logs and 3*V*V*A FMAs (V=8, A=5: 42 floats against ~250 logs
// of ~20 instructions each), so it is compute-bound on the SM's FP32 pipes
// and the log, not on HBM bandwidth.
//
// What the design does about it: the TPU kernel carried per-(j,k,a) sums
// across its sequential slot grid axis in VMEM scratch. Hopper blocks run
// in no order, so here one block owns one cell and loops over all of its
// slots. Each warp takes whole tasks, a task being one (j, a) row of
// accumulators over k (or the background row j = g0, or one of the two
// separable alpha == 0 factor rows); lanes stride over slots, so every load
// is coalesced along s and the cell's data is re-read from L1/L2 only.
// Partial sums live in registers (the k loop is unrolled to a compile-time
// bound MAXV with a uniform guard), and each task ends in a fixed
// warp-shuffle butterfly: no atomics, so two runs give identical bits.
// Shapes (B, S, C, V, A), a0_sep, sym_a and the expand map are runtime
// arguments; MAXV is one of two instantiations, so no shape needs a
// rebuild.
//
// Build without --use_fast_math: the fast-mode contract (2e-5 relative)
// needs the accurate logf (1 ulp), not __logf.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

struct Params {
  const float* t;       // (C, B, S)
  const float* g;       // (3V, B, S)
  const int* expand;    // (A*9,) rows of t
  float* out_ab;        // (B, V*V*A)
  float* out_00;        // (B, A)
  long long plane;      // B*S: stride between channels
  int S, V, A, a0_sep, sym_a;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// g0[l] = (g[0,l] + g[1,l] + ... + g[V-1,l]) * f32(1/V), in j order
template <int MAXV>
__device__ __forceinline__ void background_row(const float* g, long long plane,
                                               int V, float inv_v,
                                               float g0[3]) {
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    float acc = g[l * plane];
#pragma unroll
    for (int j = 1; j < MAXV; ++j) {
      if (j < V) acc = acc + g[(j * 3 + l) * plane];
    }
    g0[l] = acc * inv_v;
  }
}

template <int MAXV>
__global__ void __launch_bounds__(kWarps * 32)
pair_fast_kernel(Params p) {
  // separable alpha == 0 sums: [0] log d[j] (index MAXV: log d0),
  // [1] log gsum[k] (index MAXV: log g0sum)
  __shared__ float sep[2][MAXV + 1];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.S, V = p.V, A = p.A;
  const long long plane = p.plane;
  const float* t = p.t + (long long)b * S;
  const float* g = p.g + (long long)b * S;
  float* out_ab = p.out_ab + (long long)b * V * V * A;
  float* out_00 = p.out_00 + (long long)b * A;
  const float inv_v = (float)(1.0 / (double)V);
  const int nac = A - p.a0_sep;           // alphas with a pair plane
  const int n_pair = (V + 1) * nac;       // row V is the background g0
  const int n_tasks = n_pair + 2 * p.a0_sep;

  for (int task = warp; task < n_tasks; task += kWarps) {
    float acc[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) acc[i] = 0.f;
    float acc_bg = 0.f;
    if (task < n_pair) {
      const int j = task / nac;
      const int a = p.a0_sep + task % nac;
      const bool bg = j == V;
      const int k_lo = (a == p.sym_a && !bg) ? j : 0;
      int e[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) e[i] = p.expand[a * 9 + i];
      for (int s = lane; s < S; s += 32) {
        float gj[3];
        if (bg) {
          background_row<MAXV>(g + s, plane, V, inv_v, gj);
        } else {
#pragma unroll
          for (int l = 0; l < 3; ++l) gj[l] = g[(j * 3 + l) * plane + s];
        }
        float u[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          u[m] = gj[0] * t[e[m] * plane + s] + gj[1] * t[e[3 + m] * plane + s] +
                 gj[2] * t[e[6 + m] * plane + s];
        }
        if (bg) {
          acc_bg += logf(gj[0] * u[0] + gj[1] * u[1] + gj[2] * u[2]);
        } else {
#pragma unroll
          for (int k = 0; k < MAXV; ++k) {
            if (k < V && k >= k_lo) {
              const float* gk = g + (k * 3) * plane + s;
              acc[k] += logf(gk[0] * u[0] + gk[plane] * u[1] +
                             gk[2 * plane] * u[2]);
            }
          }
        }
      }
      if (bg) {
        const float v = warp_sum(acc_bg);
        if (lane == 0) out_00[a] = v;
      } else {
#pragma unroll
        for (int k = 0; k < MAXV; ++k) {
          if (k < V && k >= k_lo) {
            const float v = warp_sum(acc[k]);
            if (lane == 0) {
              out_ab[(j * V + k) * A + a] = v;
              if (a == p.sym_a && k > j) out_ab[(k * V + j) * A + a] = v;
            }
          }
        }
      }
    } else {
      // separable alpha == 0 factors: d[j] = g[j] . t[0, :, 0] (is_d) or
      // gsum[k] = g[k,0] + g[k,1] + g[k,2]; the background row rides along
      const bool is_d = task == n_pair;
      const int e0 = p.expand[0], e3 = p.expand[3], e6 = p.expand[6];
      for (int s = lane; s < S; s += 32) {
        float t0 = 0.f, t3 = 0.f, t6 = 0.f;
        if (is_d) {
          t0 = t[e0 * plane + s];
          t3 = t[e3 * plane + s];
          t6 = t[e6 * plane + s];
        }
        float sum0 = 0.f, sum1 = 0.f, sum2 = 0.f;
#pragma unroll
        for (int j = 0; j < MAXV; ++j) {
          if (j < V) {
            const float* gj = g + (j * 3) * plane + s;
            const float g0v = gj[0], g1v = gj[plane], g2v = gj[2 * plane];
            if (j == 0) {
              sum0 = g0v;
              sum1 = g1v;
              sum2 = g2v;
            } else {
              sum0 = sum0 + g0v;
              sum1 = sum1 + g1v;
              sum2 = sum2 + g2v;
            }
            acc[j] += is_d ? logf(g0v * t0 + g1v * t3 + g2v * t6)
                           : logf(g0v + g1v + g2v);
          }
        }
        const float b0 = sum0 * inv_v, b1 = sum1 * inv_v, b2 = sum2 * inv_v;
        acc_bg += is_d ? logf(b0 * t0 + b1 * t3 + b2 * t6)
                       : logf(b0 + b1 + b2);
      }
      const int r = is_d ? 0 : 1;
#pragma unroll
      for (int j = 0; j < MAXV; ++j) {
        if (j < V) {
          const float v = warp_sum(acc[j]);
          if (lane == 0) sep[r][j] = v;
        }
      }
      const float v = warp_sum(acc_bg);
      if (lane == 0) sep[r][MAXV] = v;
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
  pair_fast_kernel<MAXV><<<B, kWarps * 32, 0, stream>>>(p);
}

}  // namespace

extern "C" {

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// t (C, B, S), g (3V, B, S), expand (A*9) on the device; out_ab (B, V*V*A),
// out_00 (B, A) allocated by the caller. sym_a < 0 means no symmetric plane.
int dmx_pair_fast(const float* t, const float* g, const int* expand,
                  float* out_ab, float* out_00, int B, int S, int V, int A,
                  int a0_sep, int sym_a, void* stream) {
  Params p;
  p.t = t;
  p.g = g;
  p.expand = expand;
  p.out_ab = out_ab;
  p.out_00 = out_00;
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
