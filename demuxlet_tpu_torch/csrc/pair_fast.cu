// K1: fast-mode pair-search kernel for Hopper (sm_90a), in f32.
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
//                     summed in j order (ops/pair.py::_background_rows).
// a0_sep: the alpha == 0 plane is separable, llk_ab[j,k,0] = sum_s log d[j]
// + sum_s log gsum[k] with d[j] = g[j] . t[0,:,0] and gsum[k] the sum of
// g[k], and llk_00[0] = sum_s log d0 + sum_s log g0sum. sym_a (>= 0): the
// alpha == 0.5 plane is (j,k)-symmetric; only k >= j is computed and the
// j > k channels are copies, so ties resolve as in the JAX package. A
// masked slot carries t == 1 and neutral rows (1, 0, 0), so its inner
// values are exactly 1 and leave the products as they were.
//
// What limits it on this card: per slot the function reads 3V + C floats
// and spends a 3-term dot and a multiply per channel (V=8, A=5: 259
// channels with a0_sep and sym_a), so bytes bound it (0.10 ms at B=2048,
// S=1024). The first port of it took one accurate logf per channel per
// slot and each of its (j, alpha) rows re-read 3V g_k values per slot
// through L1/L2. Step by step at V=8, A=5, B=2048, S=1024 (chip_steps.py; H100
// 80GB HBM3, 700 W): 2.09 ms; products in place of logf in that layout
// 2.74 (slower: the re-reads stay, and a product's integer work on the
// exponent field runs at half the FP32 rate); K3''s design below with
// 4 x 4 patches 0.98; 4 x 8 patches 0.83, 8x the bound. What bounds it now
// is that arithmetic: a channel's step is a dot, a multiply and ~5 integer
// operations, at 16 warps of 128 registers an SM; staging alone takes a
// quarter of the time (DMX_PROBE, PERF.md).
//
// What the design does about it: K3''s design (pair_exact.cu) in f32,
// without singlets (fast mode's come from the front, ops/front.py). One
// block owns one cell and streams its slots in chunks of 128 through two
// shared-memory stages (stage.cuh; cp.async, 4 slots a copy where the rows
// allow it; chunk c + 1 lands while chunk c is computed): the 3V g rows,
// the 3 t rows t[0,:,0] of the separable factors and the 9 t rows of each
// alpha the current round touches, each read from HBM once per round. The
// block computes the background rows g0 of a chunk into the stage (the sum
// in j order times f32(1/V), the bits of _background_rows). Its warps own
// units, each with its lanes over slots: a 4 x 8 patch of (j, k) channels
// of one alpha (one g_k load serves 4 channels; 32 accumulators of 2
// registers each) and up to 4 of the O(V) channels (the separable factors
// d and gsum, g0's included, dealt round-robin, and the background pair of
// its alpha on the alpha's first patch; accumulators in shared memory). A
// round is up to 16 units, each a pass over the slots; it stages only its
// own alphas' t rows, so shared memory does not grow with A (V=1, A=384
// takes 24 rounds of 16 alphas). The products (logprod.cuh) end in one f64
// log per lane and a fixed f64 warp-shuffle butterfly, rounded to f32 once
// per channel: no atomics, so runs give identical bits. Shapes, V, A, C,
// a0_sep, sym_a and expand are runtime arguments; MAXV (8 or 20, the
// separable sums and the unrolled g0 sum), the patch and the chunk are
// compile-time.
//
// Build without --use_fast_math: the lane's log must be the accurate one.

#include <cuda_runtime.h>

#include "logprod.cuh"
#include "stage.cuh"

namespace {

using dmx::PJ;

// 4 x 8 patches (4 x 4 took 17% longer: PERF.md)
constexpr int kNK = 8;
constexpr int kMaxWarps = 16;  // each thread up to 128 registers
constexpr int kX = 4;          // the most O(V) channels a unit carries
constexpr int kChunk = 128;

// the O(V) channels' kinds: separable factor d, genotype sum gs,
// background pair
enum { kD = 0, kG = 1, kBg = 2 };

struct Params {
  const float* t;       // (C, B, S)
  const float* g;       // (3V, B, S)
  const int* expand;    // (A*9,) rows of t
  float* out_ab;        // (B, V*V*A)
  float* out_00;        // (B, A)
  long long plane;      // B*S: stride between channels
  int S, V, A, a0_sep, sym_a;
  int nk;     // k groups of kNK per alpha
  int per_a;  // patches per alpha
  int gr;     // stage rows of g and g0: 3V + 3, padded to whole patches
  int n_pair, n_sep, n_units;  // patch units, separable channels, units
  int warps, n_ra;  // warps per block, the most alphas a round stages
  bool vec;  // S % 4 == 0 and the tensors 16-byte aligned: 16-byte copies
};

// The units of a launch: one per patch of every alpha that is not the
// separable one, and enough for the separable channels (d[j] and gs[k] for
// j, k = 0..V, V the background row), dealt round-robin, kX - 1 at most a
// unit, beside the background pair each alpha's first patch carries.
void plan_units(Params& p) {
  p.nk = (p.V + kNK - 1) / kNK;
  p.per_a = (p.V + PJ - 1) / PJ * p.nk;
  p.gr = 3 * dmx::cmax(p.V + 1, dmx::cmax((p.V + PJ - 1) / PJ * PJ,
                                          p.nk * kNK));
  p.n_pair = (p.A - p.a0_sep) * p.per_a;
  p.n_sep = p.a0_sep ? 2 * (p.V + 1) : 0;
  const int for_sep = (p.n_sep + kX - 2) / (kX - 1);
  p.n_units = p.n_pair > for_sep ? p.n_pair : for_sep;
  p.warps = p.n_units < kMaxWarps ? p.n_units : kMaxWarps;
  p.n_ra = 0;
  for (int u0 = 0; u0 < p.n_pair; u0 += p.warps) {
    const int last = (u0 + p.warps < p.n_pair ? u0 + p.warps : p.n_pair) - 1;
    const int n = last / p.per_a - u0 / p.per_a + 1;
    p.n_ra = n > p.n_ra ? n : p.n_ra;
  }
}

// Stage rows: g (3V) and g0 (3) padded to gr, t[0,:,0] (3), then 9 t rows
// per alpha of the round.
__host__ __device__ int stage_rows(const Params& p, int n_ra) {
  return p.gr + 3 + 9 * n_ra;
}

// Dynamic shared memory: two stages of R x kChunk floats and R row
// pointers, R for the round that stages the most alphas (at most 16, so at
// most 177 KB, whatever A is).
int smem_bytes(const Params& p) {
  const int R = stage_rows(p, p.n_ra);
  return 2 * R * kChunk * static_cast<int>(sizeof(float)) +
         R * static_cast<int>(sizeof(const float*));
}

template <int MAXV>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
pair_fast_kernel(Params p) {
  // separable alpha == 0 sums: [0] log d[j] (index MAXV: log d0),
  // [1] log gsum[k] (index MAXV: log g0sum)
  __shared__ float sep[2][MAXV + 1];
  __shared__ int xdesc[kMaxWarps][kX];
  // the O(V) channels' accumulators in shared memory (structure of arrays)
  constexpr int T = kMaxWarps * 32;
  __shared__ float xm[kX * T];
  __shared__ int xe[kX * T];
  __shared__ unsigned xmasks[3 * T];
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.S, V = p.V, A = p.A;
  const long long plane = p.plane;
  const float** rows = reinterpret_cast<const float**>(
      smem + 2 * stage_rows(p, p.n_ra) * kChunk);
  const float* t = p.t + static_cast<long long>(b) * S;
  const float* g = p.g + static_cast<long long>(b) * S;
  float* out_ab = p.out_ab + static_cast<long long>(b) * V * V * A;
  float* out_00 = p.out_00 + static_cast<long long>(b) * A;
  const float inv_v = static_cast<float>(1.0 / static_cast<double>(V));
  const int g0_row = 3 * V, t0_row = p.gr, t_row = p.gr + 3;

  for (int u0 = 0; u0 < p.n_units; u0 += p.warps) {
    // the alphas this round's patches touch: a_lo .. a_lo + n_ra - 1 of
    // the non-separable ones
    const bool pairs = u0 < p.n_pair;
    const int a_lo = pairs ? u0 / p.per_a : 0;
    const int n_ra =
        pairs ? (min(u0 + p.warps, p.n_pair) - 1) / p.per_a - a_lo + 1 : 0;
    const int n_rows = stage_rows(p, n_ra);
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
      const float* src = nullptr;
      if (r < g0_row) {
        src = g + r * plane;
      } else if (r >= t_row) {
        const int a = p.a0_sep + a_lo + (r - t_row) / 9;
        src = t + static_cast<long long>(p.expand[a * 9 + (r - t_row) % 9]) *
                      plane;
      } else if (r >= t0_row && p.a0_sep) {
        src = t + static_cast<long long>(p.expand[3 * (r - t0_row)]) * plane;
      }
      rows[r] = src;  // g0 and the padding rows: not copied
    }
    __syncthreads();

    const int u = u0 + warp;
    // this warp's unit: a patch (if u < n_pair) and O(V) channels
    int a = 0, ai = a_lo, jb = 0, kb = 0, n_x = 0;
    unsigned act = 0;
    if (u < p.n_pair) {
      ai = u / p.per_a;
      a = p.a0_sep + ai;
      const int q = u % p.per_a;
      jb = q / p.nk * PJ;
      kb = q % p.nk * kNK;
      act = dmx::patch_mask<kNK>(jb, kb, V, a == p.sym_a);
    }
    int to[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      to[c] = (t_row + 9 * (ai - a_lo) + c) * kChunk;
    }
    // the O(V) channels' descriptors (kind << 16 | index: j = 0..V, V the
    // background row, or the alpha of a background pair) live in shared
    // memory, read each slot, which keeps the thread within its registers
    int* xd = xdesc[warp];
    __syncwarp();  // the last round's reads are done
    if (u < p.n_units) {
#pragma unroll
      for (int i = 0; i < kX - 1; ++i) {
        const int x = u + i * p.n_units;
        if (x < p.n_sep) {
          if (lane == 0) {
            xd[n_x] = x <= V ? (kD << 16) | x : (kG << 16) | (x - V - 1);
          }
          ++n_x;
        }
      }
      if (u < p.n_pair && u % p.per_a == 0) {
        if (lane == 0) xd[n_x] = (kBg << 16) | a;
        ++n_x;
      }
    }
    __syncwarp();
    // the inner value of O(V) channel d at slot s of a stage
    auto extra_inner = [&](const float* stage, int d, int s) {
      const int kind = d >> 16, idx = d & 0xffff;
      if (kind == kBg) {  // g0 . (g0 t_a)
        const float* g0 = stage + g0_row * kChunk;
        const float b0 = g0[s], b1 = g0[kChunk + s], b2 = g0[2 * kChunk + s];
        float uu[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          uu[m] = b0 * stage[to[m] + s] + b1 * stage[to[3 + m] + s] +
                  b2 * stage[to[6 + m] + s];
        }
        return b0 * uu[0] + b1 * uu[1] + b2 * uu[2];
      }
      // w . g[idx]: w = t[0,:,0] (d) or 1 (gs); idx == V: the g0 rows
      float w0 = 1.f, w1 = 1.f, w2 = 1.f;
      if (kind == kD) {
        const float* q = stage + t0_row * kChunk;
        w0 = q[s];
        w1 = q[kChunk + s];
        w2 = q[2 * kChunk + s];
      }
      const float* gj = stage + 3 * idx * kChunk;
      return gj[s] * w0 + gj[kChunk + s] * w1 + gj[2 * kChunk + s] * w2;
    };
    dmx::Acc<PJ * kNK, float> acc;
    dmx::SharedAcc<kX, float> xacc{xm + threadIdx.x, xe + threadIdx.x,
                                   xmasks + threadIdx.x, T};
    acc.init();
    xacc.init();
    dmx::stream_chunks<kChunk, float>(
        smem, rows, n_rows, S, p.vec, [&](float* stage, int n) {
          // the chunk's background rows, in j order (the slots past n are
          // not read)
          for (int i = threadIdx.x; i < 3 * kChunk; i += blockDim.x) {
            const int l = i / kChunk, s = i % kChunk;
            float sum = stage[l * kChunk + s];
#pragma unroll
            for (int j = 1; j < MAXV; ++j) {
              if (j < V) sum = sum + stage[(3 * j + l) * kChunk + s];
            }
            stage[(g0_row + l) * kChunk + s] = sum * inv_v;
          }
          __syncthreads();
          dmx::patch_chunk_any<kChunk, kNK>(stage, n, 3 * jb, 3 * kb, to,
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
    // one log per lane and channel, then the butterfly, then f32
    if (act != 0) {
#pragma unroll
      for (int dj = 0; dj < PJ; ++dj) {
#pragma unroll
        for (int dk = 0; dk < kNK; ++dk) {
          if ((act >> (dj * kNK + dk)) & 1u) {
            const float v =
                static_cast<float>(dmx::warp_sum(acc.log_sum(dj * kNK + dk)));
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
        const float v = static_cast<float>(dmx::warp_sum(xacc.log_sum(i)));
        const int kind = xd[i] >> 16, idx = xd[i] & 0xffff;
        if (lane == 0) {
          if (kind == kBg) {
            out_00[idx] = v;
          } else {
            sep[kind][idx < V ? idx : MAXV] = v;
          }
        }
      }
    }
    // stream_chunks ended on a barrier after every read of the row
    // pointers, so the next round may rewrite them
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
int launch(const Params& p, int B, cudaStream_t stream) {
  const int bytes = smem_bytes(p);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_fast_kernel<MAXV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_fast_kernel<MAXV><<<B, p.warps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The dynamic shared memory K1 takes at this shape (bytes).
int dmx_pair_fast_smem(int V, int A, int a0_sep) {
  Params p = {};
  p.V = V;
  p.A = A;
  p.a0_sep = a0_sep ? 1 : 0;
  plan_units(p);
  return smem_bytes(p);
}

// Launches K1 on `stream` and returns the first CUDA error (0 on success).
// t (C, B, S), g (3V, B, S), expand (A*9, values < C) on the device; out_ab
// (B, V*V*A), out_00 (B, A) allocated by the caller. sym_a < 0 means no
// symmetric plane.
int dmx_pair_fast(const float* t, const float* g, const int* expand,
                  float* out_ab, float* out_00, int B, int S, int V, int A,
                  int a0_sep, int sym_a, void* stream) {
  Params p = {};
  p.t = t;
  p.g = g;
  p.expand = expand;
  p.out_ab = out_ab;
  p.out_00 = out_00;
  p.plane = (long long)B * S;
  p.S = S;
  p.V = V;
  p.A = A;
  p.a0_sep = a0_sep ? 1 : 0;
  p.sym_a = sym_a;
  p.vec = S % 4 == 0 && dmx::aligned16(t) && dmx::aligned16(g);
  if (B < 1 || V < 1 || V > 20 || A < 1 || S > 32LL * dmx::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan_units(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return V <= 8 ? launch<8>(p, B, st) : launch<20>(p, B, st);
}

const char* dmx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
