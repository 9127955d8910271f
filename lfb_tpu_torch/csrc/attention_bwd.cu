// Fused softmax attention, backward: dq, dk, dv (f32) of
// out = softmax(q k^T * scale) v from q, k, v, dO (the input type), the
// forward's f32 row log-sum-exp `lse` and delta = rowsum(dO * O), both
// (B, Nq).  With s = scale q.k, p = exp(s - lse) and
// ds = p (dO.v - delta):
//   dq_i = scale sum_j ds_ij k_j,  dk_j = scale sum_i ds_ij q_i,
//   dv_j = sum_i p_ij dO_i.
// Replaces lfb_tpu/ops/pallas_attention.py:_bwd_call (kernel
// _attn_bwd_kernel).
//
// The TPU kernel kept one batch element's whole K/V in VMEM and summed dk/dv
// across the q-tile grid dimension in a resident output block.  A CTA holds
// neither, and CTAs run in no order, so the sums are split by who owns them
// and nothing is accumulated across CTAs (deterministic, no atomics): a
// K/V-major launch for dk/dv and a Q-major launch for dq, both recomputing p
// from the lse rather than storing the (Nq, Nk) matrices.  That is 7
// matmul-sized passes (S and dP twice, dV, dK, dQ) against the minimum of 5.
// Query rows past Nq are loaded as zeros with lse = +inf, so their p is 0
// and they add nothing; keys past Nk are zero rows that are not stored (and
// get p = 0 in the dq launch).
//
// bf16 with Nq > 1 -- the in-backbone non-local blocks (a train step at
// B = 8, crop 224: res3 32 x 3136 x 784 x C 256, res4 8 x 3136 x 784 x C 512;
// 705 GFLOP over its 8 calls at 5 passes, 0.71 ms at 989 TFLOP/s bf16
// dense): every pass on mma.sync.m16n8k16 (bf16 in, f32 accumulate), 8
// warps a CTA, operands staged by cp.async in row-padded shared tiles.  A
// warp owns 16 rows (keys, or query rows) and a slice of the output
// columns: the f32 accumulators of 64 keys' dk and dv at C = 512 (256 KB)
// fit neither the registers nor shared memory of one CTA, so the columns
// are split over the warps of a CTA, and the CTA covers fewer rows when C
// is wide.  The warps that share rows split the work of S and dP between
// them instead of repeating it, and exchange P and dS as bf16 through
// shared memory (a first version split the columns over CTAs, each
// recomputing S and dP: the res4 call took 3.71 ms on an H100 SXM at 700 W,
// slower than the plain f32 version; this layout 2.78, and 1.55 with C
// compiled in).
//  * attn_bwd_dkdv_mma_kernel -- one CTA per (batch, tile of 16 x 8/ncg
//    keys), ncg = C/128 column groups of 128.  It streams tiles of q and dO
//    (64 query rows at C = 256, 32 elsewhere; two cp.async stages) and
//    computes S^T = K Q^T and dP^T = V dO^T over the full C, each warp on a
//    share of the query n-tiles; P^T and dS^T go to shared memory as bf16
//    and come back as the A fragments of dV += P^T dO and dK += dS^T Q (q
//    and dO through ldmatrix.trans); the sums stay f32.  The grid is 8 x 25
//    CTAs at res4, 32 x 13 at res3.
//  * attn_bwd_dq_mma_kernel -- one CTA per (batch, tile of 16 x 8/ncg query
//    rows), ncg = C/256 column groups of 256.  It streams 32-key tiles of K
//    and V (two stages, one at C = 512), recomputes S = Q K^T and dP = dO V^T
//    on a share of the key n-tiles each, and adds dS K (K through
//    ldmatrix.trans) with dS exchanged as above.
// f32 (the whole-model f32 parity checks) keeps the FMA-unit kernels
// attn_bwd_dkdv_kernel / attn_bwd_dq_kernel: one CTA per (batch, 16-key
// tile) with dk/dv in registers (each warp 2 keys, each lane C/32 columns)
// streaming 32-query tiles, and one CTA per (batch, 32-query tile) streaming
// 32-key tiles.  attn_bwd_decode_kernel -- FBO-NL (Nq == 1): one CTA per box.
#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using lfb::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 512;
constexpr int kMaxCols = kMaxC / 32;           // columns per lane

constexpr int kKvTK = 16;                      // keys per dk/dv CTA
constexpr int kKvTQ = 32;                      // streamed query rows
constexpr int kKeysPerWarp = kKvTK / kWarps;   // 2

constexpr int kQTQ = 32;                       // query rows per dq CTA
constexpr int kQTK = 32;                       // streamed keys: 1 per lane
constexpr int kRowsPerWarp = kQTQ / kWarps;    // 4

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Rows [r0, r0 + rows) of a (N, C) tensor into shared memory with leading
// dimension ld, as f32; rows past `valid` are zero.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, int r0, int rows,
                          int valid, int C) {
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C;
    const int c = i - r * C;
    dst[r * ld + c] = (r0 + r < valid) ? to_f32(src[(size_t)(r0 + r) * C + c])
                                       : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Nq, int Nk, int C,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + 4;                 // float4 rows, conflict-free reads
  float* sK = smem;                     // kKvTK x ld
  float* sV = sK + kKvTK * ld;          // kKvTK x ld
  float* sQ = sV + kKvTK * ld;          // kKvTQ x ld
  float* sO = sQ + kKvTQ * ld;          // kKvTQ x ld  (dO)
  float* sP = sO + kKvTQ * ld;          // kKvTQ x kKvTK  p
  float* sS = sP + kKvTQ * kKvTK;       // kKvTQ x kKvTK  ds
  float* sL = sS + kKvTQ * kKvTK;       // kKvTQ  lse
  float* sD = sL + kKvTQ;               // kKvTQ  delta

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kKvTK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ncols = C >> 5;
  const int nk = min(kKvTK, Nk - k0);
  const size_t qoff = (size_t)b * Nq;

  load_rows(sK, ld, k + (size_t)b * Nk * C, k0, kKvTK, Nk, C);
  load_rows(sV, ld, v + (size_t)b * Nk * C, k0, kKvTK, Nk, C);

  float acc_k[kKeysPerWarp][kMaxCols], acc_v[kKeysPerWarp][kMaxCols];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j)
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) acc_k[j][m] = acc_v[j][m] = 0.f;

  // Score pairs of this thread: key sj, query rows si and si + 16.
  const int sj = tid % kKvTK;
  const int si = tid / kKvTK;
  const int kw = warp * kKeysPerWarp;   // this warp's accumulator keys

  for (int q0 = 0; q0 < Nq; q0 += kKvTQ) {
    __syncthreads();                    // the previous tile's readers are done
    load_rows(sQ, ld, q + qoff * C, q0, kKvTQ, Nq, C);
    load_rows(sO, ld, dout + qoff * C, q0, kKvTQ, Nq, C);
    if (tid < kKvTQ) {
      const bool ok = q0 + tid < Nq;
      sL[tid] = ok ? lse[qoff + q0 + tid] : CUDART_INF_F;
      sD[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
    const float4* kr = reinterpret_cast<const float4*>(sK + sj * ld);
    const float4* vr = reinterpret_cast<const float4*>(sV + sj * ld);
    for (int c4 = 0; c4 < (C >> 2); ++c4) {
      const float4 kv = kr[c4];
      const float4 vv = vr[c4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = si + 16 * h;
        s[h] += dot4(reinterpret_cast<const float4*>(sQ + i * ld)[c4], kv);
        dp[h] += dot4(reinterpret_cast<const float4*>(sO + i * ld)[c4], vv);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = si + 16 * h;
      const float p = (sj < nk) ? expf(s[h] * scale - sL[i]) : 0.f;
      sP[i * kKvTK + sj] = p;
      sS[i * kKvTK + sj] = p * (dp[h] - sD[i]);
    }
    __syncthreads();

    for (int i = 0; i < kKvTQ; ++i) {
      float p[kKeysPerWarp], d[kKeysPerWarp];
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        p[j] = sP[i * kKvTK + kw + j];
        d[j] = sS[i * kKvTK + kw + j];
      }
      const float* qr = sQ + i * ld + lane;
      const float* orow = sO + i * ld + lane;
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        if (m < ncols) {
          const float qv = qr[32 * m];
          const float ov = orow[32 * m];
#pragma unroll
          for (int j = 0; j < kKeysPerWarp; ++j) {
            acc_k[j][m] += d[j] * qv;
            acc_v[j][m] += p[j] * ov;
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int key = k0 + kw + j;
    if (key >= Nk) continue;
    float* dkr = dk + ((size_t)b * Nk + key) * C + lane;
    float* dvr = dv + ((size_t)b * Nk + key) * C + lane;
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) {
      if (m < ncols) {
        dkr[32 * m] = scale * acc_k[j][m];
        dvr[32 * m] = acc_v[j][m];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int Nq, int Nk, int C, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + 4;
  float* sQ = smem;                     // kQTQ x C
  float* sO = sQ + kQTQ * C;            // kQTQ x C  (dO)
  float* sKV = sO + kQTQ * C;           // kQTK x ld  (V tile, then K tile)
  float* sS = sKV + kQTK * ld;          // kQTQ x kQTK  ds

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQTQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * kRowsPerWarp;
  const int ncols = C >> 5;
  const size_t qoff = (size_t)b * Nq;
  const T* kb = k + (size_t)b * Nk * C;
  const T* vb = v + (size_t)b * Nk * C;

  load_rows(sQ, C, q + qoff * C, q0, kQTQ, Nq, C);
  load_rows(sO, C, dout + qoff * C, q0, kQTQ, Nq, C);
  float row_lse[kRowsPerWarp], row_delta[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = q0 + r0 + i;
    row_lse[i] = (r < Nq) ? lse[qoff + r] : CUDART_INF_F;
    row_delta[i] = (r < Nq) ? delta[qoff + r] : 0.f;
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) acc[i][m] = 0.f;
  }

  for (int k0 = 0; k0 < Nk; k0 += kQTK) {
    const int nk = min(kQTK, Nk - k0);

    // dp = dO . v for this warp's rows x key `lane`.
    __syncthreads();                    // also retires the last K tile's reads
    load_rows(sKV, ld, vb, k0, kQTK, Nk, C);
    __syncthreads();
    float dp[kRowsPerWarp], s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dp[i] = s[i] = 0.f;
    const float4* kvrow = reinterpret_cast<const float4*>(sKV + lane * ld);
    for (int c4 = 0; c4 < (C >> 2); ++c4) {
      const float4 vv = kvrow[c4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        dp[i] += dot4(reinterpret_cast<const float4*>(sO + (r0 + i) * C)[c4], vv);
    }

    // s = q . k, then p and ds.
    __syncthreads();
    load_rows(sKV, ld, kb, k0, kQTK, Nk, C);
    __syncthreads();
    for (int c4 = 0; c4 < (C >> 2); ++c4) {
      const float4 kv = kvrow[c4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] += dot4(reinterpret_cast<const float4*>(sQ + (r0 + i) * C)[c4], kv);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float p = (lane < nk) ? expf(s[i] * scale - row_lse[i]) : 0.f;
      sS[(r0 + i) * kQTK + lane] = p * (dp[i] - row_delta[i]);
    }
    __syncwarp();                       // the warp reads back its own rows

    for (int kk = 0; kk < nk; ++kk) {
      float d[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) d[i] = sS[(r0 + i) * kQTK + kk];
      const float* krow = sKV + kk * ld + lane;
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        if (m < ncols) {
          const float kv = krow[32 * m];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][m] += d[i] * kv;
        }
      }
    }
    __syncwarp();                       // before the next tile rewrites sS
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = q0 + r0 + i;
    if (r >= Nq) continue;
    float* out = dq + (qoff + r) * C + lane;
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) {
      if (m < ncols) out[32 * m] = scale * acc[i][m];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv, int Nk,
                       int C, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;        // C
  float* so = sq + C;      // C  (dO)
  float* sp = so + C;      // Nk  p
  float* ss = sp + Nk;     // Nk  ds

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* kb = k + (size_t)b * Nk * C;
  const T* vb = v + (size_t)b * Nk * C;

  for (int c = tid; c < C; c += kThreads) {
    sq[c] = to_f32(q[(size_t)b * C + c]);
    so[c] = to_f32(dout[(size_t)b * C + c]);
  }
  __syncthreads();
  const float row_lse = lse[b];
  const float row_delta = delta[b];

  for (int j = warp; j < Nk; j += kWarps) {
    const T* krow = kb + (size_t)j * C;
    const T* vrow = vb + (size_t)j * C;
    float s = 0.f, dp = 0.f;
    for (int c = lane; c < C; c += 32) {
      s += sq[c] * to_f32(krow[c]);
      dp += so[c] * to_f32(vrow[c]);
    }
    s = lfb::warp_sum(s);
    dp = lfb::warp_sum(dp);
    if (lane == 0) {
      const float p = expf(s * scale - row_lse);
      sp[j] = p;
      ss[j] = p * (dp - row_delta);
    }
  }
  __syncthreads();

  for (int c = tid; c < C; c += kThreads) {
    float a = 0.f;
    for (int j = 0; j < Nk; ++j) a += ss[j] * to_f32(kb[(size_t)j * C + c]);
    dq[(size_t)b * C + c] = scale * a;
  }
  float* dkb = dk + (size_t)b * Nk * C;
  float* dvb = dv + (size_t)b * Nk * C;
  for (int i = tid; i < Nk * C; i += kThreads) {
    const int j = i / C;
    const int c = i - j * C;
    dkb[i] = scale * (ss[j] * sq[c]);
    dvb[i] = sp[j] * so[c];
  }
}


// ---- bf16, Nq > 1: tensor cores -------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kDkvCols = 128;                // dk/dv columns per warp
constexpr int kDqBK = 32;                    // streamed keys
constexpr int kDqCols = 256;                 // dq columns per warp
constexpr int kLdP = kDqBK + 8;              // row stride of the bf16 dS tile

// Query rows per streamed tile of the dk/dv launch: 64 where the model's
// C = 256 leaves room for two stages of them, else 32.
__host__ __device__ constexpr int dkdv_bq(int C) { return C == 256 ? 64 : 32; }
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 227 * 1024;

// A launch's warps form `ncg` column groups of `nrg` row groups each: the
// dk/dv launch covers 16 nrg keys and all C columns (128 a group), the dq
// launch 16 nrg query rows and all C columns (256 a group).
struct Split {
  int ncg, nrg;
};
inline Split dkdv_split(int C) {
  const int ncg = (C + kDkvCols - 1) / kDkvCols;
  return {ncg, kMmaWarps / ncg};
}
inline Split dq_split(int C) {
  const int ncg = (C + kDqCols - 1) / kDqCols;
  return {ncg, kMmaWarps / ncg};
}

// Shared memory: the resident tiles (K and V, or q and dO, of the CTA's 16
// nrg rows), `stages` streamed tiles, and the bf16 P^T and dS^T (or dS)
// tiles the column groups share.
__host__ __device__ inline size_t dkdv_fixed_bytes(int C, int nrg) {
  return 2 * (size_t)16 * nrg * (C + 8) * sizeof(lfb::bf16);
}
__host__ __device__ inline size_t dkdv_stage_bytes(int C, int bq) {
  return 2 * (size_t)bq * (C + 8) * sizeof(lfb::bf16) +      // q, dO
         2 * bq * sizeof(float);                             // lse, delta
}
__host__ __device__ inline size_t dkdv_shared_bytes(int nrg, int bq) {
  return 2 * (size_t)16 * nrg * (bq + 8) * sizeof(lfb::bf16);  // P^T, dS^T
}
__host__ __device__ inline size_t dq_fixed_bytes(int C, int nrg) {
  return 2 * (size_t)16 * nrg * (C + 8) * sizeof(lfb::bf16);
}
__host__ __device__ inline size_t dq_stage_bytes(int C) {      // K, V
  return 2 * (size_t)kDqBK * (C + 8) * sizeof(lfb::bf16);
}
__host__ __device__ inline size_t dq_shared_bytes(int nrg) {    // dS
  return (size_t)16 * nrg * kLdP * sizeof(lfb::bf16);
}

// Warp (rg, cg) of the dk/dv launch owns keys 16 rg.. of the CTA's tile and
// dk/dv columns 128 cg...  Per query tile (dkdv_bq rows) it computes S^T and
// dP^T for its keys over the full C on the query n-tiles n with n % ncg ==
// cg (so the column groups split that work rather than repeat it), writes
// P^T and dS^T as bf16 to shared memory, and after a barrier reads back the
// A fragments of the whole tile for dV += P^T dO and dK += dS^T Q over its
// columns.
// CC > 0 fixes C (and so ncg) at compile time, as in the forward: with the
// loops unrolled the res3 backward of a train step went from 3.72 to
// 2.45 ms (H100 SXM, 700 W); CC = 0 takes them from the arguments.
template <int CC>
__global__ void __launch_bounds__(kMmaWarps * 32)
attn_bwd_dkdv_mma_kernel(const lfb::bf16* __restrict__ q,
                         const lfb::bf16* __restrict__ k,
                         const lfb::bf16* __restrict__ v,
                         const lfb::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Nq, int Nk, int C_arg, float scale, int ncg_arg,
                         int stages) {
  using lfb::bf16;
  const int C = CC > 0 ? CC : C_arg;
  const int ncg = CC > 0 ? (CC + kDkvCols - 1) / kDkvCols : ncg_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nrg = (blockDim.x >> 5) / ncg;
  const int rg = warp % nrg;
  const int cg = warp / nrg;
  const int keys = 16 * nrg;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * keys;
  const int c_lo = cg * kDkvCols;
  const int nc = min(kDkvCols, C - c_lo);    // a multiple of 32
  const int ld = C + 8;
  const float scale_log2 = scale * kLog2e;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // keys x ld
  bf16* sV = sK + keys * ld;                       // keys x ld
  constexpr int BQ = dkdv_bq(CC);
  constexpr int NT = BQ / 8;                       // query n-tiles per tile
  constexpr int ldp = BQ + 8;
  bf16* sP = sV + keys * ld;                       // keys x ldp  P^T
  bf16* sDS = sP + keys * ldp;                     // keys x ldp  dS^T
  unsigned char* stage0 = smem_raw + dkdv_fixed_bytes(C, nrg) +
                          dkdv_shared_bytes(nrg, BQ);
  const size_t stage_bytes = dkdv_stage_bytes(C, BQ);
  const size_t qoff = (size_t)b * Nq;

  // A stage: q tile, dO tile (BQ x ld each), lse * log2(e), delta.
  auto tile_q = [&](int buf) {
    return reinterpret_cast<bf16*>(stage0 + buf * stage_bytes);
  };
  auto tile_o = [&](int buf) { return tile_q(buf) + BQ * ld; };
  auto tile_l = [&](int buf) {
    return reinterpret_cast<float*>(tile_o(buf) + BQ * ld);
  };
  auto load_q = [&](int tile, int buf) {
    const int r0 = tile * BQ;
    lfb::load_tile_async(tile_q(buf), ld, q + qoff * C, C, r0, BQ, Nq, 0, C);
    lfb::load_tile_async(tile_o(buf), ld, dout + qoff * C, C, r0, BQ, Nq, 0, C);
    float* sL = tile_l(buf);
    const int i = threadIdx.x;
    if (i < BQ) {
      const bool ok = r0 + i < Nq;
      sL[i] = ok ? lse[qoff + r0 + i] * kLog2e : CUDART_INF_F;
      sL[BQ + i] = ok ? delta[qoff + r0 + i] : 0.f;
    }
  };
  lfb::load_tile_async(sK, ld, k + (size_t)b * Nk * C, C, k0, keys, Nk, 0, C);
  lfb::load_tile_async(sV, ld, v + (size_t)b * Nk * C, C, k0, keys, Nk, 0, C);
  load_q(0, 0);
  lfb::cp_async_commit();

  float acc_k[kDkvCols / 8][4], acc_v[kDkvCols / 8][4];
#pragma unroll
  for (int n = 0; n < kDkvCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int ntiles = (Nq + BQ - 1) / BQ;
  // This warp's query n-tiles: n = cg + j ncg for j < nj (and n < NT).
  const int nj = (NT + ncg - 1) / ncg;
  for (int t = 0; t < ntiles; ++t) {
    const int buf = stages == 2 ? (t & 1) : 0;
    if (stages == 2 && t + 1 < ntiles) {
      load_q(t + 1, buf ^ 1);
      lfb::cp_async_commit();
      lfb::cp_async_wait<1>();
    } else {
      lfb::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = tile_q(buf);
    const bf16* tO = tile_o(buf);
    const float* tL = tile_l(buf);

    // S^T = K Q^T and dP^T = V dO^T on this warp's query n-tiles.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t ak[4], av[4];
      lfb::ldsm_x4(ak, lfb::a_frag(sK, ld, rg * 16, kk, lane));
      lfb::ldsm_x4(av, lfb::a_frag(sV, ld, rg * 16, kk, lane));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = cg + j * ncg;
        if (j < nj && n < NT) {
          uint32_t bq[2], bo[2];
          lfb::ldsm_x2(bq, lfb::b1_frag(tQ, ld, n * 8, kk, lane));
          lfb::ldsm_x2(bo, lfb::b1_frag(tO, ld, n * 8, kk, lane));
          lfb::mma_16816(st[j], ak, bq[0], bq[1]);
          lfb::mma_16816(dpt[j], av, bo[0], bo[1]);
        }
      }
    }
    // P^T and dS^T (the query of (n, e) is n * 8 + 2t + (e & 1)) to the
    // shared tiles, as bf16.
    {
      const int r = rg * 16 + (lane >> 2);
      const int c = (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = cg + j * ncg;
        if (j < nj && n < NT) {
          float p[4], d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = n * 8 + c + (e & 1);
            p[e] = exp2f(st[j][e] * scale_log2 - tL[i]);
            d[e] = p[e] * (dpt[j][e] - tL[BQ + i]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = (r + 8 * h) * ldp + n * 8 + c;
            *reinterpret_cast<uint32_t*>(sP + off) =
                lfb::pack_bf16(p[2 * h], p[2 * h + 1]);
            *reinterpret_cast<uint32_t*>(sDS + off) =
                lfb::pack_bf16(d[2 * h], d[2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over this warp's columns.
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], da[4];
      lfb::ldsm_x4(pa, lfb::a_frag(sP, ldp, rg * 16, kc * 16, lane));
      lfb::ldsm_x4(da, lfb::a_frag(sDS, ldp, rg * 16, kc * 16, lane));
#pragma unroll
      for (int np = 0; np < kDkvCols / 16; ++np) {
        if (np * 16 < nc) {
          uint32_t bo[4], bq[4];
          lfb::ldsm_x4_trans(bo, lfb::bt_frag(tO, ld, kc * 16, c_lo + np * 16,
                                              lane));
          lfb::ldsm_x4_trans(bq, lfb::bt_frag(tQ, ld, kc * 16, c_lo + np * 16,
                                              lane));
          lfb::mma_16816(acc_v[2 * np], pa, bo[0], bo[1]);
          lfb::mma_16816(acc_v[2 * np + 1], pa, bo[2], bo[3]);
          lfb::mma_16816(acc_k[2 * np], da, bq[0], bq[1]);
          lfb::mma_16816(acc_k[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                   // before this stage and sP are rewritten
    if (stages == 1 && t + 1 < ntiles) {
      load_q(t + 1, 0);
      lfb::cp_async_commit();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rg * 16 + (lane >> 2) + 8 * h;
    if (key >= Nk) continue;
    float* dkr = dk + ((size_t)b * Nk + key) * C + c_lo + (lane & 3) * 2;
    float* dvr = dv + ((size_t)b * Nk + key) * C + c_lo + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < kDkvCols / 8; ++n) {
      if (n * 8 < nc) {
        *reinterpret_cast<float2*>(dkr + n * 8) =
            make_float2(scale * acc_k[n][2 * h], scale * acc_k[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dvr + n * 8) =
            make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
      }
    }
  }
}

// Warp (rg, cg) of the dq launch owns query rows 16 rg.. of the CTA's tile
// and dq columns 256 cg...  Per 32-key tile it computes S = Q K^T and
// dP = dO V^T for its rows on the key n-tiles n with n % ncg == cg, writes
// dS as bf16 to shared memory, and after a barrier reads back the A
// fragments of all 32 keys for dQ += dS K over its columns (K through
// ldmatrix.trans).
template <int CC>
__global__ void __launch_bounds__(kMmaWarps * 32)
attn_bwd_dq_mma_kernel(const lfb::bf16* __restrict__ q,
                       const lfb::bf16* __restrict__ k,
                       const lfb::bf16* __restrict__ v,
                       const lfb::bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       int Nq, int Nk, int C_arg, float scale, int ncg_arg,
                       int stages) {
  using lfb::bf16;
  const int C = CC > 0 ? CC : C_arg;
  const int ncg = CC > 0 ? (CC + kDqCols - 1) / kDqCols : ncg_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nrg = (blockDim.x >> 5) / ncg;
  const int rg = warp % nrg;
  const int cg = warp / nrg;
  const int rows = 16 * nrg;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * rows;
  const int c_lo = cg * kDqCols;
  const int nc = min(kDqCols, C - c_lo);     // a multiple of 32
  const int ld = C + 8;
  const float scale_log2 = scale * kLog2e;
  const size_t qoff = (size_t)b * Nq;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // rows x ld
  bf16* sO = sQ + rows * ld;                       // rows x ld  (dO)
  bf16* sDS = sO + rows * ld;                      // rows x kLdP  dS
  bf16* sKV = sDS + rows * kLdP;                   // stages x (K, V) tiles
  const bf16* kb = k + (size_t)b * Nk * C;
  const bf16* vb = v + (size_t)b * Nk * C;
  auto tile_k = [&](int buf) { return sKV + buf * 2 * kDqBK * ld; };
  auto tile_v = [&](int buf) { return tile_k(buf) + kDqBK * ld; };
  auto load_kv = [&](int tile, int buf) {
    lfb::load_tile_async(tile_k(buf), ld, kb, C, tile * kDqBK, kDqBK, Nk, 0, C);
    lfb::load_tile_async(tile_v(buf), ld, vb, C, tile * kDqBK, kDqBK, Nk, 0, C);
  };
  lfb::load_tile_async(sQ, ld, q + qoff * C, C, q0, rows, Nq, 0, C);
  lfb::load_tile_async(sO, ld, dout + qoff * C, C, q0, rows, Nq, 0, C);
  load_kv(0, 0);
  lfb::cp_async_commit();

  // Rows g and g + 8 of this warp's 16.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + rg * 16 + (lane >> 2) + 8 * h;
    row_lse[h] = r < Nq ? lse[qoff + r] * kLog2e : CUDART_INF_F;
    row_delta[h] = r < Nq ? delta[qoff + r] : 0.f;
  }
  float acc[kDqCols / 8][4];
#pragma unroll
  for (int n = 0; n < kDqCols / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  constexpr int NT = kDqBK / 8;                    // key n-tiles per tile
  const int ntiles = (Nk + kDqBK - 1) / kDqBK;
  // This warp's key n-tiles: n = cg + j ncg for j < nj (and n < NT).
  const int nj = (NT + ncg - 1) / ncg;
  for (int t = 0; t < ntiles; ++t) {
    const int buf = stages == 2 ? (t & 1) : 0;
    if (stages == 2 && t + 1 < ntiles) {
      load_kv(t + 1, buf ^ 1);
      lfb::cp_async_commit();
      lfb::cp_async_wait<1>();
    } else {
      lfb::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = tile_k(buf);
    const bf16* tV = tile_v(buf);

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t aq[4], ao[4];
      lfb::ldsm_x4(aq, lfb::a_frag(sQ, ld, rg * 16, kk, lane));
      lfb::ldsm_x4(ao, lfb::a_frag(sO, ld, rg * 16, kk, lane));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = cg + j * ncg;
        if (j < nj && n < NT) {
          uint32_t bk[2], bv[2];
          lfb::ldsm_x2(bk, lfb::b1_frag(tK, ld, n * 8, kk, lane));
          lfb::ldsm_x2(bv, lfb::b1_frag(tV, ld, n * 8, kk, lane));
          lfb::mma_16816(s[j], aq, bk[0], bk[1]);
          lfb::mma_16816(dp[j], ao, bv[0], bv[1]);
        }
      }
    }
    // dS to the shared tile; keys past Nk get p = 0.
    {
      const int r = rg * 16 + (lane >> 2);
      const int c = (lane & 3) * 2;
      const int key0 = t * kDqBK + c;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = cg + j * ncg;
        if (j < nj && n < NT) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = (key0 + n * 8 + (e & 1) < Nk)
                                ? exp2f(s[j][e] * scale_log2 - row_lse[e >> 1])
                                : 0.f;
            d[e] = p * (dp[j][e] - row_delta[e >> 1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(sDS + (r + 8 * h) * kLdP + n * 8 + c) =
                lfb::pack_bf16(d[2 * h], d[2 * h + 1]);
        }
      }
    }
    __syncthreads();
    // dQ += dS K over this warp's columns.
#pragma unroll
    for (int kc = 0; kc < kDqBK / 16; ++kc) {
      uint32_t da[4];
      lfb::ldsm_x4(da, lfb::a_frag(sDS, kLdP, rg * 16, kc * 16, lane));
#pragma unroll
      for (int np = 0; np < kDqCols / 16; ++np) {
        if (np * 16 < nc) {
          uint32_t bk[4];
          lfb::ldsm_x4_trans(bk, lfb::bt_frag(tK, ld, kc * 16, c_lo + np * 16,
                                              lane));
          lfb::mma_16816(acc[2 * np], da, bk[0], bk[1]);
          lfb::mma_16816(acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                  // before this stage and sDS are rewritten
    if (stages == 1 && t + 1 < ntiles) {
      load_kv(t + 1, 0);
      lfb::cp_async_commit();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + rg * 16 + (lane >> 2) + 8 * h;
    if (r >= Nq) continue;
    float* out = dq + (qoff + r) * C + c_lo + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < kDqCols / 8; ++n) {
      if (n * 8 < nc)
        *reinterpret_cast<float2*>(out + n * 8) =
            make_float2(scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
    }
  }
}

cudaError_t launch_mma(const lfb::bf16* q, const lfb::bf16* k,
                       const lfb::bf16* v, const lfb::bf16* dout,
                       const float* lse, const float* delta, float* dq,
                       float* dk, float* dv, int B, int Nq, int Nk, int C,
                       float scale, cudaStream_t stream) {
  // Two cp.async stages where they fit beside the resident tiles, else one.
  Split sp = dkdv_split(C);
  const int bq = dkdv_bq(C);
  size_t fixed = dkdv_fixed_bytes(C, sp.nrg) + dkdv_shared_bytes(sp.nrg, bq);
  int stages = fixed + 2 * dkdv_stage_bytes(C, bq) <= kMaxSmem ? 2 : 1;
  size_t smem = fixed + stages * dkdv_stage_bytes(C, bq);
  // The model's widths compiled in, any other C at run time.
  auto dkdv = C == 256   ? attn_bwd_dkdv_mma_kernel<256>
              : C == 512 ? attn_bwd_dkdv_mma_kernel<512>
                         : attn_bwd_dkdv_mma_kernel<0>;
  cudaError_t err = lfb::allow_smem(dkdv, smem);
  if (err != cudaSuccess) return err;
  const int keys = 16 * sp.nrg;
  dkdv<<<dim3((Nk + keys - 1) / keys, B),
                             32 * sp.nrg * sp.ncg, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Nq, Nk, C, scale, sp.ncg, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sp = dq_split(C);
  fixed = dq_fixed_bytes(C, sp.nrg) + dq_shared_bytes(sp.nrg);
  stages = fixed + 2 * dq_stage_bytes(C) <= kMaxSmem ? 2 : 1;
  smem = fixed + stages * dq_stage_bytes(C);
  auto dqk = C == 256 ? attn_bwd_dq_mma_kernel<256>
             : C == 512 ? attn_bwd_dq_mma_kernel<512>
                        : attn_bwd_dq_mma_kernel<0>;
  err = lfb::allow_smem(dqk, smem);
  if (err != cudaSuccess) return err;
  const int rows = 16 * sp.nrg;
  dqk<<<dim3((Nq + rows - 1) / rows, B),
                           32 * sp.nrg * sp.ncg, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Nq, Nk, C, scale, sp.ncg, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int B, int Nq, int Nk, int C,
                   float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  if (Nq == 1) {
    const size_t smem = (size_t)(2 * C + 2 * Nk) * sizeof(float);
    cudaError_t err = lfb::allow_smem(attn_bwd_decode_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    attn_bwd_decode_kernel<T><<<B, kThreads, smem, stream>>>(
        qp, kp, vp, op, lp, dp, dqp, dkp, dvp, Nk, C, scale);
    return cudaGetLastError();
  }
  if constexpr (std::is_same<T, lfb::bf16>::value) {
    return launch_mma(qp, kp, vp, op, lp, dp, dqp, dkp, dvp, B, Nq, Nk, C,
                      scale, stream);
  } else {
    const size_t smem_kv =
        ((size_t)(2 * kKvTK + 2 * kKvTQ) * (C + 4) + 2 * kKvTQ * kKvTK +
         2 * kKvTQ) * sizeof(float);
    cudaError_t err = lfb::allow_smem(attn_bwd_dkdv_kernel<T>, smem_kv);
    if (err != cudaSuccess) return err;
    attn_bwd_dkdv_kernel<T><<<dim3((Nk + kKvTK - 1) / kKvTK, B), kThreads,
                              smem_kv, stream>>>(qp, kp, vp, op, lp, dp, dkp,
                                                 dvp, Nq, Nk, C, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem_q =
        ((size_t)2 * kQTQ * C + (size_t)kQTK * (C + 4) + kQTQ * kQTK) *
        sizeof(float);
    err = lfb::allow_smem(attn_bwd_dq_kernel<T>, smem_q);
    if (err != cudaSuccess) return err;
    attn_bwd_dq_kernel<T><<<dim3((Nq + kQTQ - 1) / kQTQ, B), kThreads, smem_q,
                            stream>>>(qp, kp, vp, op, lp, dp, dqp, Nq, Nk, C,
                                      scale);
    return cudaGetLastError();
  }
}

}  // namespace

// q, k, v, dout in one type; lse, delta f32 (B, Nq); dq, dk, dv f32.  C must
// be a multiple of 32 and at most 512 when Nq > 1 (checked by the Python
// wrapper); Nq == 1 takes any C and Nk whose (2 C + 2 Nk) floats fit shared
// memory.
LFB_EXPORT int lfb_attention_bwd_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int B,
                                     int Nq, int Nk, int C, float scale,
                                     void* stream) {
  return launch<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, Nq, Nk, C,
                       scale, static_cast<cudaStream_t>(stream));
}

LFB_EXPORT int lfb_attention_bwd_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int B,
                                      int Nq, int Nk, int C, float scale,
                                      void* stream) {
  return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, B, Nq,
                               Nk, C, scale,
                               static_cast<cudaStream_t>(stream));
}
