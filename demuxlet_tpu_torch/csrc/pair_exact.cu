// K3': exact-mode pair search and singlet term for Hopper (sm_90a), in f64.
//
// Replaces the TPU kernel demuxlet_tpu/ops/pallas_pair_exact.py::
// _pair_kernel_df (launched by _call_pair_kernel_df) on the unrolled path,
// V*V*A <= 384. Like the TPU kernel, it multiplies each channel's inner
// values into a product with exponent tracking and takes one log per
// accumulator (logprod.cuh), in native f64 instead of df32.
//
// What it computes, per cell b and slot s (t: the front's mixture table,
// C deduplicated channels that expand maps onto the A*9 logical (a, l, m)
// channels; g: per-slot genotype posteriors, rows j*3 + l for the V
// samples, then the three rows of the host f64 background gp0, read as
// sample j = V; gl: the pass-1 GL table):
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
// gl == (1, 0, 0), so its inner values are exactly 1 and leave the
// products as they were.
//
// What limits it on this card: per slot the function reads 3V + 6 + C
// doubles and spends a 3-term dot and a multiply per channel (V=8, A=5:
// 259 channels with a0_sep and sym_a): bytes bound it (0.24 ms at B=2048,
// S=1024). PR 4's kernel took an f64 log per channel per slot and each of
// its (j, alpha) rows re-read 3V g_k values per slot through L1/L2. Step by
// step at V=8, A=5, B=2048, S=1024 (chip_steps.py; H100 80GB HBM3, 700 W):
// 6.48 ms; products in place of logs 5.06; slot chunks staged in shared
// memory (1 x 8 patches) 1.71; 4 x 8 patches 1.61; 4 x 4 patches at 16
// warps with the O(V) channels spread over the patch warps 1.23; chunks of
// 128 slots 1.19, 4.9x the bound. What bounds it now is the arithmetic at
// the occupancy its registers allow: staging alone takes 0.37 ms, the units
// alone 1.11 (chip_steps.py with DMX_PROBE).
//
// What the design does about it (stage.cuh): one block owns one cell and
// streams its slots in chunks of CH (128; less on grids with hundreds of
// t channels) through two shared-memory stages (cp.async; chunk c + 1 lands
// while chunk c is computed): the 3V + 3 g rows, the 3 gl rows and the C t
// rows, each read from HBM once. Its warps own units, each with its lanes
// over slots: a 4 x 4 patch of (j, k) channels of one alpha (one g_k load
// serves 4 channels; accumulators in registers), and up to 4 of the extra
// channels (the separable factors d and gsum, the singlets, the background
// pairs; accumulators in shared memory, which keeps a thread within the
// 128 registers of 16 warps). V=8, A=5 is 16 units, one per warp; with
// more units than 16 the block takes them in rounds, each a pass over the
// slots. The products (logprod.cuh) end in one log per lane and a fixed
// warp-shuffle butterfly: no atomics, so runs give identical bits. Shapes,
// V, A, C, a0_sep, sym_a and expand are runtime arguments; only MAXV (8 or
// 20) and CH are compile-time.
//
// Build without --use_fast_math: log must be the accurate f64 one.

#include <cuda_runtime.h>

#include "logprod.cuh"
#include "stage.cuh"

namespace {

using dmx::PJ;
using dmx::PK;

constexpr int kSmemMax = 190 * 1024;  // with ~31 KB of static shared memory
constexpr int kMaxWarps = 16;  // each thread up to 128 registers
constexpr int kX = 4;          // the most extra channels a unit carries

// the extra channels' kinds: separable factor d, genotype sum gs, singlet,
// background pair
enum { kD = 0, kG = 1, kS = 2, kBg = 3 };

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
  int S, V, A, C, a0_sep, sym_a;
  int nk;  // k groups of PK per alpha
  int gr;  // stage rows of g: 3V + 3, padded to whole patches past V
  int n_pair, nx, n_units;  // patches, extra channels, units
  bool vec;  // S even and the tensors 16-byte aligned: 16-byte copies
};

// The units of a launch: one per patch, at least enough for the extra
// channels (d, gs for a0_sep, the singlets, one background pair per
// non-separable alpha), which are dealt round-robin over the units.
void plan_units(Params& p) {
  const int nac = p.A - p.a0_sep;
  p.n_pair = nac * ((p.V + PJ - 1) / PJ) * p.nk;
  p.nx = (p.a0_sep ? 3 : 1) * (p.V + 1) + nac;
  const int for_x = (p.nx + kX - 1) / kX;
  p.n_units = p.n_pair > for_x ? p.n_pair : for_x;
}

__host__ __device__ int stage_rows(const Params& p) {
  return p.gr + 3 + p.C;
}

// Dynamic shared memory: two stages of R x CH doubles (g rows, padding
// rows that patches past V read and ignore, gl rows, t rows), R row
// pointers and the stage offset of each of the A*9 logical t channels.
int smem_bytes(const Params& p, int ch) {
  const int R = stage_rows(p);
  return 2 * R * ch * static_cast<int>(sizeof(double)) +
         R * static_cast<int>(sizeof(const double*)) +
         9 * p.A * static_cast<int>(sizeof(int));
}

// Extra channel x of a cell as (kind << 16) | index (index: j = 0..V, V
// the background row, or the alpha of a background pair).
__device__ __forceinline__ int extra_desc(int x, const Params& p) {
  const int n = p.V + 1;
  if (p.a0_sep) {
    if (x < n) return (kD << 16) | x;
    if (x < 2 * n) return (kG << 16) | (x - n);
    x -= 2 * n;
  }
  if (x < n) return (kS << 16) | x;
  return (kBg << 16) | (p.a0_sep + x - n);
}

template <int MAXV, int CH>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
pair_exact_kernel(Params p) {
  // separable alpha == 0 sums: [0] log d[j] (index MAXV: log d0),
  // [1] log gsum[k] (index MAXV: log g0sum)
  __shared__ double sep[2][MAXV + 1];
  __shared__ int xdesc[kMaxWarps][kX];
  // the extra channels' accumulators in shared memory: in registers they
  // would push the patch past the 128 registers of 16 warps
  constexpr int T = kMaxWarps * 32;
  __shared__ double xm[kX * T];
  __shared__ int xe[kX * T];
  __shared__ unsigned xmasks[3 * T];
  extern __shared__ double smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.S, V = p.V, A = p.A;
  const long long plane = p.plane;
  const int R = stage_rows(p);
  const double** rows = reinterpret_cast<const double**>(smem + 2 * R * CH);
  int* erow = reinterpret_cast<int*>(rows + R);
  const int gl_row = p.gr, t_row = p.gr + 3;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const double* base = r < 3 * V + 3 ? p.g + r * plane
                         : r < gl_row  ? nullptr
                         : r < t_row   ? p.gl + (r - gl_row) * plane
                                       : p.t + (r - t_row) * plane;
    rows[r] = base ? base + static_cast<long long>(b) * S : nullptr;
  }
  for (int i = threadIdx.x; i < 9 * A; i += blockDim.x) {
    erow[i] = (t_row + p.expand[i]) * CH;
  }
  __syncthreads();
  double* out_ab = p.out_ab + (long long)b * V * V * A;
  double* out_00 = p.out_00 + (long long)b * A;
  const int nw = blockDim.x >> 5;

  for (int u0 = 0; u0 < p.n_units; u0 += nw) {
    const int u = u0 + warp;
    // this warp's unit: a patch (if u < n_pair) and extra channels
    // u, u + n_units, ...
    int a = 0, jb = 0, kb = 0, n_x = 0;
    unsigned act = 0;
    if (u < p.n_pair) {
      const int per_a = p.n_pair / (A - p.a0_sep);
      a = p.a0_sep + u / per_a;
      jb = (u % per_a) / p.nk * PJ;
      kb = (u % per_a) % p.nk * PK;
      act = dmx::patch_mask<PK>(jb, kb, V, a == p.sym_a);
    }
    // the extra channels' descriptors live in shared memory, read each
    // slot, which keeps the thread within its registers
    int* xd = xdesc[warp];
    __syncwarp();  // the last round's reads are done
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int x = u + i * p.n_units;
      if (u < p.n_units && x < p.nx) {
        if (lane == 0) xd[i] = extra_desc(x, p);
        n_x = i + 1;
      }
    }
    __syncwarp();
    // the inner value of extra channel d at slot s of a stage
    auto extra_inner = [&](const double* stage, int d, int s) {
      const int kind = d >> 16, idx = d & 0xffff;
      if (kind == kBg) {  // g0 . (g0 t_a)
        const int* e = erow + idx * 9;
        const double* g0 = stage + 3 * V * CH;
        const double b0 = g0[s], b1 = g0[CH + s], b2 = g0[2 * CH + s];
        double uu[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          uu[m] = b0 * stage[e[m] + s] + b1 * stage[e[3 + m] + s] +
                  b2 * stage[e[6 + m] + s];
        }
        return b0 * uu[0] + b1 * uu[1] + b2 * uu[2];
      }
      // w . g[idx]: w = t[0,:,0] (d), 1 (gs) or gl (s)
      double w0 = 1.0, w1 = 1.0, w2 = 1.0;
      if (kind == kD) {
        w0 = stage[erow[0] + s];
        w1 = stage[erow[3] + s];
        w2 = stage[erow[6] + s];
      } else if (kind == kS) {
        const double* q = stage + gl_row * CH;
        w0 = q[s];
        w1 = q[CH + s];
        w2 = q[2 * CH + s];
      }
      const double* gj = stage + 3 * idx * CH;
      return gj[s] * w0 + gj[CH + s] * w1 + gj[2 * CH + s] * w2;
    };
    dmx::Acc<PJ * PK> acc;
    dmx::SharedAcc<kX> xacc{xm + threadIdx.x, xe + threadIdx.x,
                            xmasks + threadIdx.x, T};
    acc.init();
    xacc.init();
    dmx::stream_chunks<CH, double>(
        smem, rows, R, S, p.vec, [&](const double* stage, int n) {
          // the alpha's t offsets are read from shared memory each slot
          dmx::patch_chunk_any<CH, PK>(stage, n, 3 * jb, 3 * kb, erow + a * 9,
                                   act, acc);
          if (n_x == 0) return;
#pragma unroll 1
          for (int s0 = 0; s0 < n; s0 += 32) {
            const int s = s0 + lane;
            const bool live = s < n;
            bool bad = false;
#pragma unroll
            for (int i = 0; i < kX; ++i) {
              if (live && i < n_x) {
                bad |= !xacc.step(i, extra_inner(stage, xd[i], s));
              }
            }
            if (__any_sync(0xffffffffu, bad) && live) {  // the rare path
#pragma unroll
              for (int i = 0; i < kX; ++i) {
                if (i < n_x) xacc.fix(i, extra_inner(stage, xd[i], s));
              }
            }
          }
        });
    // one log per lane and channel, then the butterfly
    if (act != 0) {
#pragma unroll
      for (int dj = 0; dj < PJ; ++dj) {
#pragma unroll
        for (int dk = 0; dk < PK; ++dk) {
          if ((act >> (dj * PK + dk)) & 1u) {
            const double v = dmx::warp_sum(acc.log_sum(dj * PK + dk));
            const int j = jb + dj, k = kb + dk;
            if (lane == 0) {
              out_ab[(j * V + k) * A + a] = v;
              if (a == p.sym_a && k > j) out_ab[(k * V + j) * A + a] = v;
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      if (i < n_x) {
        const double v = dmx::warp_sum(xacc.log_sum(i));
        const int kind = xd[i] >> 16, idx = xd[i] & 0xffff;
        if (lane == 0) {
          if (kind == kBg) {
            out_00[idx] = v;
          } else if (kind == kS) {
            if (idx < V) {
              p.out_s[(long long)b * V + idx] = v;
            } else {
              p.out_s0[b] = v;
            }
          } else {
            sep[kind][idx < V ? idx : MAXV] = v;
          }
        }
      }
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

template <int MAXV, int CH>
int launch(Params p, int B, cudaStream_t stream) {
  plan_units(p);
  const int bytes = smem_bytes(p, CH);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_exact_kernel<MAXV, CH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = p.n_units < kMaxWarps ? p.n_units : kMaxWarps;
  pair_exact_kernel<MAXV, CH><<<B, warps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The chunk a launch stages: 128 slots, or less where that does not fit
// (V <= 8: 16, for grids of hundreds of alphas; V <= 20: 64); 0 if it
// takes no launch.
int chunk_for(const Params& p) {
  if (p.V > 20) return 0;
  if (smem_bytes(p, 128) <= kSmemMax) return 128;
  const int ch = p.V <= 8 ? 16 : 64;
  return smem_bytes(p, ch) <= kSmemMax ? ch : 0;
}

Params shape_params(int B, int S, int V, int A, int C, int a0_sep,
                    int sym_a) {
  Params p = {};
  p.plane = (long long)B * S;
  p.S = S;
  p.V = V;
  p.A = A;
  p.C = C;
  p.a0_sep = a0_sep ? 1 : 0;
  p.sym_a = sym_a;
  p.nk = (V + PK - 1) / PK;
  p.gr = 3 * dmx::cmax(V + 1, dmx::cmax((V + PJ - 1) / PJ * PJ, p.nk * PK));
  return p;
}

}  // namespace

extern "C" {

// The dynamic shared memory K3' takes at this shape (bytes), or 0 if its
// stages do not fit (the launch then returns cudaErrorInvalidValue).
int dmx_pair_exact_smem(int V, int A, int C, int a0_sep) {
  const Params p = shape_params(1, 1, V, A, C, a0_sep, -1);
  const int ch = chunk_for(p);
  return ch ? smem_bytes(p, ch) : 0;
}

// Launches K3' on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V+3, B, S), gl (3, B, S), expand (A*9, values < C) on
// the device; out_ab (B, V*V*A), out_00 (B, A), out_s (B, V), out_s0 (B)
// allocated by the caller. sym_a < 0 means no symmetric plane.
int dmx_pair_exact(const double* t, const double* g, const double* gl,
                   const int* expand, double* out_ab, double* out_00,
                   double* out_s, double* out_s0, int B, int S, int V, int A,
                   int C, int a0_sep, int sym_a, void* stream) {
  Params p = shape_params(B, S, V, A, C, a0_sep, sym_a);
  p.t = t;
  p.g = g;
  p.gl = gl;
  p.expand = expand;
  p.out_ab = out_ab;
  p.out_00 = out_00;
  p.out_s = out_s;
  p.out_s0 = out_s0;
  p.vec = S % 2 == 0 && dmx::aligned16(t) && dmx::aligned16(g) &&
          dmx::aligned16(gl);
  const int ch = chunk_for(p);
  if (B < 1 || V < 1 || A < 1 || C < 1 || ch == 0 ||
      S > 32LL * dmx::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V <= 8) {
    return ch == 128 ? launch<8, 128>(p, B, st) : launch<8, 16>(p, B, st);
  }
  return ch == 128 ? launch<20, 128>(p, B, st) : launch<20, 64>(p, B, st);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
