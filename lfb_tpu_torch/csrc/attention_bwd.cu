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
// B = 8, crop 224: res3 32 x 3136 x 784 x C 256, res4 8 x 3136 x 784 x C
// 512; 705 GFLOP over its 8 calls at 5 passes, 0.71 ms at 989 TFLOP/s bf16
// dense): every product on wgmma, warp-specialised as the forward (a
// producer warpgroup feeding shared-memory rings by TMA under mbarriers,
// two consumer warpgroups); the score tiles P^T, dS^T and dS become A
// operands straight from the accumulators, and the streamed q, dO and K
// tiles serve as MN-major B operands.  The accumulators of 64 keys' dk and
// dv (or 64 rows' dq) at C 256 fill a warpgroup's registers, so each sum
// has its own group and the groups swap score tiles through shared memory.
//  * attn_bwd_dkdv_wgmma_kernel -- one CTA per (batch, 64-key tile), K and
//    V resident; group 0 forms S^T and P^T and sums dV, group 1 forms dP^T
//    and dS^T (with group 0's P^T) and sums dK, over streamed q / dO tiles.
//    At C 512 two CTAs of a cluster share the key tile, each holding half
//    of the channels: each forms its part of S^T and dP^T and they swap
//    parts through distributed shared memory, so nothing is formed twice.
//  * attn_bwd_dq_wgmma_kernel -- one CTA per (batch, query tile), q and dO
//    resident, K and V streamed: at C 256 each group forms S and dP for its
//    own 64 of 128 rows and sums all of their dq; at C 512 a CTA is 64 rows,
//    group 0 forms S and group 1 dP, they swap them, and each sums half of
//    dq's columns.
// f32 (the whole-model f32 parity checks) keeps the FMA-unit kernels
// attn_bwd_dkdv_kernel / attn_bwd_dq_kernel: one CTA per (batch, 16-key
// tile) with dk/dv in registers (each warp 2 keys, each lane C/32 columns)
// streaming 32-query tiles, and one CTA per (batch, 32-query tile) streaming
// 32-key tiles.  attn_bwd_decode_kernel -- FBO-NL (Nq == 1): one CTA per box.
#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma_bf16.cuh"

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


// ---- bf16, Nq > 1: wgmma on TMA-fed shared memory -------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgThreads = 3 * 128;   // two consumer warpgroups, a producer one
constexpr int kStages = 2;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The tilings of the dk/dv launch: 64 keys a CTA, K and V resident as 4
// panels of 64 channels, q and dO streamed in BQ-row tiles of the same
// panels.  kWide false (C <= 256): the panels cover C (zeros past it), BQ
// 64.  kWide true (C up to 512): a cluster of two CTAs shares a key tile,
// CTA r owning channels 256 r .. 256 r + 255 of K, V, q, dO and of dk, dv;
// each forms its part of S^T and dP^T over its channels and the two swap
// parts through distributed shared memory, so S^T and dP^T are formed once;
// BQ 32.
template <bool kWide>
struct Dkdv {
  static constexpr int BQ = kWide ? 32 : 64;
  static constexpr int kKvBytes = 4 * 64 * 128;      // K or V
  static constexpr int kTileBytes = 4 * BQ * 128;    // q or dO
  static constexpr int kPartBytes = 64 * BQ * 4;     // an f32 64 x BQ tile
  // P^T from group 0 to group 1 (2 slots) and, with kWide, the peer CTA's
  // parts of S^T and dP^T (2 slots each).
  static constexpr int kExOffset = 2 * kKvBytes + 2 * kStages * kTileBytes;
  static constexpr int kStatOffset = kExOffset + (kWide ? 6 : 2) * kPartBytes;
  static constexpr int kBarOffset = kStatOffset + kStages * 2 * BQ * 4;
  static constexpr int kSmem = 1024 + kBarOffset + 128;
};

// The tilings of the dq launch: q and dO resident, K and V streamed in
// BK-key tiles.  kWide false: 128 query rows a CTA, each group its own 64
// rows and all of dq's columns, forming S and dP itself.  kWide true: 64
// rows; group 0 forms S and group 1 dP over the full C, they swap them, and
// each owns half of dq's columns.
template <bool kWide>
struct Dq {
  static constexpr int NP = kWide ? 8 : 4;           // 64-channel panels
  static constexpr int BR = kWide ? 64 : 128;        // query rows a CTA
  static constexpr int BK = kWide ? 16 : 32;
  static constexpr int kQBytes = NP * BR * 128;      // q or dO
  static constexpr int kTileBytes = NP * BK * 128;   // K or V
  static constexpr int kExBytes = kWide ? 2 * 2 * 64 * BK * 4 : 0;  // S, dP
  static constexpr int kBarOffset =
      2 * kQBytes + 2 * kStages * kTileBytes + kExBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 64;
};

// Warpgroup 0 owns dV, warpgroup 1 dK, of the CTA's 64 keys and channels.
// Per q tile (from the producer's ring: q, dO by TMA; lse * log2 e and
// delta, rows past Nq +inf and 0, written by the producer warp's lanes):
// group 0 forms S^T = K q^T, group 1 dP^T = V dO^T (K, V resident and
// K-major A operands, q, dO K-major B operands; with kWide each adds the
// peer CTA's part).  Group 0 turns S^T into P^T = exp2(S^T scale log2 e -
// lse log2 e) and hands it, f32 in its accumulator order, to group 1
// through shared memory, which forms dS^T = P^T (dP^T - delta).  Then dV +=
// P^T dO and dK += dS^T q, P^T and dS^T the A operands straight from the
// registers, dO and q MN-major B operands.  Keys past Nk are zero rows
// whose sums are not stored; query rows past Nq have p = 0.
template <bool kWide>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int Nq, int Nk, int C, float scale) {
  using D = Dkdv<kWide>;
  constexpr int BQ = D::BQ;
  constexpr int kPart4 = D::kPartBytes / 16;          // float4s of a part
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t sk = lfb::smem_addr(base);
  const uint32_t sv = sk + D::kKvBytes;
  const uint32_t sst = sv + D::kKvBytes;   // stage s: q at 2 s tiles, dO next
  float4* ex = reinterpret_cast<float4*>(base + D::kExOffset);
  float* stat = reinterpret_cast<float*>(base + D::kStatOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + D::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;
  uint64_t* recv = kvbar + 1;    // [group][slot]: the peer's part has landed
  uint64_t* freed = recv + 4;    // [group][slot]: the peer has read ours
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int rank = kWide ? static_cast<int>(lfb::cluster_rank()) : 0;
  const int c_lo = 256 * rank;                // the CTA's first channel
  const int b = blockIdx.y;
  const int k0 = (kWide ? blockIdx.x >> 1 : blockIdx.x) * 64;
  const int ntiles = (Nq + BQ - 1) / BQ;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      lfb::mbar_init(&full[s], 32);            // the producer warp's lanes
      lfb::mbar_init(&empty[s], 8);            // the consumer warps
    }
    lfb::mbar_init(kvbar, 1);
    if (kWide)
      for (int i = 0; i < 4; ++i) {
        lfb::mbar_init(&recv[i], 128);         // the peer group's threads
        lfb::mbar_init(&freed[i], 128);
      }
    lfb::mbar_init_fence();
  }
  if constexpr (kWide)
    lfb::cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    lfb::reg_dealloc<40>();
    // ---- producer: warp 8 ----
    if (tid >> 5 != 8) return;
    const int lane = tid & 31;
    if (lane == 0) {
      lfb::mbar_arrive_expect_tx(kvbar, 2 * D::kKvBytes);
      for (int p = 0; p < 4; ++p) {
        lfb::tma_load_3d(sk + p * 64 * 128, &tk, kvbar, c_lo + 64 * p, k0, b);
        lfb::tma_load_3d(sv + p * 64 * 128, &tv, kvbar, c_lo + 64 * p, k0, b);
      }
    }
    const size_t qoff = (size_t)b * Nq;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      lfb::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      float* L = stat + s * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const int r = t * BQ + i;
        L[i] = r < Nq ? lse[qoff + r] * kLog2e : CUDART_INF_F;
        L[BQ + i] = r < Nq ? delta[qoff + r] : 0.f;
      }
      if (lane == 0) {
        lfb::mbar_arrive_expect_tx(&full[s], 2 * D::kTileBytes);
        const uint32_t dst = sst + s * 2 * D::kTileBytes;
        for (int p = 0; p < 4; ++p) {
          lfb::tma_load_3d(dst + p * BQ * 128, &tq, &full[s], c_lo + 64 * p,
                           t * BQ, b);
          lfb::tma_load_3d(dst + D::kTileBytes + p * BQ * 128, &tdo, &full[s],
                           c_lo + 64 * p, t * BQ, b);
        }
      } else {
        lfb::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers ----
    lfb::reg_alloc<232>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int i128 = tid & 127;
    const float scale_log2 = scale * kLog2e;
    const uint32_t sa = wg == 0 ? sk : sv;    // A of S^T (K) or dP^T (V)
    float acc[128];   // dV (group 0) or dK (group 1); unset, as the forward's O
    // kWide: this group's two slots for the peer's parts, and the same
    // slots in the peer CTA, where this group's parts go.
    const float4* part = ex + (2 + 2 * wg) * kPart4;
    uint32_t part_peer = 0;
    if constexpr (kWide)
      part_peer = lfb::map_to_rank(lfb::smem_addr(part), rank ^ 1);
    lfb::mbar_wait(kvbar, 0);

    uint32_t f[BQ / 16][4];        // P^T or dS^T as A fragments
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      lfb::mbar_wait(&full[st], (t / kStages) & 1);
      const uint32_t tq_addr = sst + st * 2 * D::kTileBytes;
      const uint32_t tdo_addr = tq_addr + D::kTileBytes;
      // S^T (group 0) or dP^T (group 1), into an accumulator fresh each
      // tile (see the forward kernel).
      const uint32_t sb = wg == 0 ? tq_addr : tdo_addr;
      float x[BQ / 2];
      lfb::wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lfb::wgmma_ss<BQ>(x, lfb::desc_sw128(sa + p * 64 * 128 + 32 * j, 16),
                            lfb::desc_sw128(sb + p * BQ * 128 + 32 * j, 16),
                            (p | j) != 0);
      lfb::wgmma_commit();
      lfb::wgmma_wait<0>();        // this product, and the last dV / dK
      lfb::fence_operand(x);
      lfb::fence_operand(acc);
      __syncwarp();
      if (t > 0 && lane == 0) lfb::mbar_arrive(&empty[(t - 1) % kStages]);
      if constexpr (kWide) {
        // Swap parts with the same group of the peer CTA (slot t % 2):
        // write ours into its slot once it has read what was there, signal,
        // wait for its part, add (the same sum in both CTAs), free the slot.
        const int slot = t & 1;
        uint64_t* got = &recv[2 * wg + slot];
        uint64_t* gone = &freed[2 * wg + slot];
        if (t >= 2) lfb::mbar_wait_cluster(gone, ((t >> 1) & 1) ^ 1);
        const uint32_t dst = part_peer + slot * D::kPartBytes;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
          lfb::st_cluster(dst + (j * 128 + i128) * 16,
                          make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                                      x[4 * j + 3]));
        lfb::mbar_arrive_cluster(
            lfb::map_to_rank(lfb::smem_addr(got), rank ^ 1));
        lfb::mbar_wait_cluster(got, (t >> 1) & 1);
        const float4* theirs = part + slot * kPart4;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float4 y = theirs[j * 128 + i128];
          x[4 * j] += y.x;
          x[4 * j + 1] += y.y;
          x[4 * j + 2] += y.z;
          x[4 * j + 3] += y.w;
        }
        if (t + 2 < ntiles)
          lfb::mbar_arrive_cluster(
              lfb::map_to_rank(lfb::smem_addr(gone), rank ^ 1));
      }
      // Element e of the accumulator is key row 16 warp + lane / 4 (+ 8)
      // and query column 8 (e / 4) + 2 (lane % 4) + e % 2 of the tile.
      const float* L = stat + st * 2 * BQ;
      const int col0 = (lane & 3) * 2;
      float4* slot = ex + (t & 1) * kPart4;
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e)
          x[e] = lfb::fast_exp2(x[e] * scale_log2 -
                                L[8 * (e >> 2) + col0 + (e & 1)]);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
          slot[j * 128 + i128] =
              make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      }
      lfb::named_bar_sync(1, 256);
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float4 p4 = slot[j * 128 + i128];
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * j + u;
            x[e] = pj[u] * (x[e] - L[BQ + 8 * j + col0 + (u & 1)]);
          }
        }
      }
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) lfb::acc_to_a(f[kc], x, kc);

      // dV += P^T dO (group 0), dK += dS^T q (group 1), over the CTA's
      // channels.
      const uint32_t sb2 = wg == 0 ? tdo_addr : tq_addr;
      lfb::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        lfb::Wgmma<256>::rs_t(acc, f[kc],
                              lfb::desc_sw128(sb2 + kc * 16 * 128, BQ * 128),
                              t > 0 || kc > 0);
      lfb::wgmma_commit();
    }
    lfb::wgmma_wait<0>();
    lfb::fence_operand(acc);

    float* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + 16 * warp + (lane >> 2) + 8 * hh;
      if (key >= Nk) continue;
      float* row = out + ((size_t)b * Nk + key) * C + c_lo + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (c_lo + 8 * i < C)
          *reinterpret_cast<float2*>(row + 8 * i) = make_float2(
              mul * acc[4 * i + 2 * hh], mul * acc[4 * i + 2 * hh + 1]);
    }
  }
}

// Per key tile (from the producer's ring: K, V by TMA) a group forms S = q
// K^T and dP = dO V^T over the full C (q, dO resident K-major A operands;
// K, V K-major B operands): kWide false, both for its own 64 rows; kWide
// true, group 0 S and group 1 dP for the CTA's 64 rows, swapped through
// shared memory (f32, in accumulator order).  Then P = exp2(S scale log2 e
// - lse log2 e) (0 for keys past Nk), dS = P (dP - delta), and dQ += dS K
// over the group's columns, dS the A operand from registers and K the
// MN-major B operand.  Query rows past Nq are zero rows with p = 0 that are
// not stored.
template <bool kWide>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int Nq, int Nk, int C,
                         float scale) {
  using D = Dq<kWide>;
  constexpr int BK = D::BK, BR = D::BR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t sq = lfb::smem_addr(base);
  const uint32_t sdo = sq + D::kQBytes;
  const uint32_t skv = sdo + D::kQBytes;     // stage s: K at 2 s tiles, V after
  float4* ex = reinterpret_cast<float4*>(base + 2 * D::kQBytes +
                                         2 * kStages * D::kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + D::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BR;
  const int ntiles = (Nk + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      lfb::mbar_init(&full[s], 1);
      lfb::mbar_init(&empty[s], 8);
    }
    lfb::mbar_init(qbar, 1);
    lfb::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    lfb::reg_dealloc<40>();
    // ---- producer ----
    if (tid == 256) {
      lfb::mbar_arrive_expect_tx(qbar, 2 * D::kQBytes);
      for (int p = 0; p < D::NP; ++p) {
        lfb::tma_load_3d(sq + p * BR * 128, &tq, qbar, 64 * p, q0, b);
        lfb::tma_load_3d(sdo + p * BR * 128, &tdo, qbar, 64 * p, q0, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        lfb::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        lfb::mbar_arrive_expect_tx(&full[s], 2 * D::kTileBytes);
        const uint32_t dst = skv + s * 2 * D::kTileBytes;
        for (int p = 0; p < D::NP; ++p) {
          lfb::tma_load_3d(dst + p * BK * 128, &tk, &full[s], 64 * p, t * BK,
                           b);
          lfb::tma_load_3d(dst + D::kTileBytes + p * BK * 128, &tv, &full[s],
                           64 * p, t * BK, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    lfb::reg_alloc<232>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int i128 = tid & 127;
    const float scale_log2 = scale * kLog2e;
    const size_t qoff = (size_t)b * Nq;
    const int row0 = kWide ? 0 : 64 * wg;     // the group's first row
    const int po = kWide ? 4 * wg : 0;        // its first panel of dq
    // Rows g and g + 8 of this warp's 16.
    float row_l[2], row_d[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + row0 + 16 * warp + (lane >> 2) + 8 * hh;
      row_l[hh] = r < Nq ? lse[qoff + r] * kLog2e : CUDART_INF_F;
      row_d[hh] = r < Nq ? delta[qoff + r] : 0.f;
    }
    float acc[128];   // unset, as the forward's O
    uint32_t xa[BK / 16][4];
    lfb::mbar_wait(qbar, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      lfb::mbar_wait(&full[st], (t / kStages) & 1);
      const uint32_t tk_addr = skv + st * 2 * D::kTileBytes;
      const uint32_t tv_addr = tk_addr + D::kTileBytes;
      // Fresh accumulators each tile: see the forward kernel.
      float s[BK / 2], dp[BK / 2];
      lfb::wgmma_fence();
      if constexpr (!kWide) {
#pragma unroll
        for (int p = 0; p < D::NP; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lfb::wgmma_ss<BK>(
                s, lfb::desc_sw128(sq + p * BR * 128 + row0 * 128 + 32 * j, 16),
                lfb::desc_sw128(tk_addr + p * BK * 128 + 32 * j, 16),
                (p | j) != 0);
            lfb::wgmma_ss<BK>(
                dp,
                lfb::desc_sw128(sdo + p * BR * 128 + row0 * 128 + 32 * j, 16),
                lfb::desc_sw128(tv_addr + p * BK * 128 + 32 * j, 16),
                (p | j) != 0);
          }
      } else {
        const uint32_t sa = wg == 0 ? sq : sdo;
        const uint32_t sb = wg == 0 ? tk_addr : tv_addr;
#pragma unroll
        for (int p = 0; p < D::NP; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            lfb::wgmma_ss<BK>(s,
                              lfb::desc_sw128(sa + p * BR * 128 + 32 * j, 16),
                              lfb::desc_sw128(sb + p * BK * 128 + 32 * j, 16),
                              (p | j) != 0);
      }
      lfb::wgmma_commit();
      lfb::wgmma_wait<0>();                // these products, and the last dQ
      lfb::fence_operand(s);
      if constexpr (!kWide) lfb::fence_operand(dp);
      lfb::fence_operand(acc);
      __syncwarp();
      if (t > 0 && lane == 0) lfb::mbar_arrive(&empty[(t - 1) % kStages]);
      if constexpr (kWide) {
        // Group 0 holds S, group 1 dP: swap them (slot t % 2).
        float4* mine = ex + ((t & 1) * 2 + wg) * (BK / 8) * 128;
        const float4* theirs = ex + ((t & 1) * 2 + (wg ^ 1)) * (BK / 8) * 128;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mine[j * 128 + i128] =
              make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
        lfb::named_bar_sync(1, 256);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float4 y4 = theirs[j * 128 + i128];
          const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * j + u;
            const float mine_v = s[e];
            s[e] = wg == 0 ? mine_v : y[u];
            dp[e] = wg == 0 ? y[u] : mine_v;
          }
        }
      }
      // Element e: query row 16 warp + lane / 4 (+ 8 for (e / 2) odd), key
      // column 8 (e / 4) + 2 (lane % 4) + e % 2 of the tile.
      const int key0 = t * BK + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int hh = (e >> 1) & 1;
        const float p = key0 + 8 * (e >> 2) + (e & 1) < Nk
                            ? lfb::fast_exp2(s[e] * scale_log2 - row_l[hh])
                            : 0.f;
        s[e] = p * (dp[e] - row_d[hh]);
      }
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) lfb::acc_to_a(xa[kc], s, kc);

      // dQ += dS K over the group's columns.
      const uint32_t sb2 = tk_addr + po * BK * 128;
      lfb::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        lfb::Wgmma<256>::rs_t(acc, xa[kc],
                              lfb::desc_sw128(sb2 + kc * 16 * 128, BK * 128),
                              t > 0 || kc > 0);
      lfb::wgmma_commit();
    }
    lfb::wgmma_wait<0>();
    lfb::fence_operand(acc);

    const int c0 = 64 * po;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + row0 + 16 * warp + (lane >> 2) + 8 * hh;
      if (r >= Nq) continue;
      float* row = dq + (qoff + r) * C + c0 + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (c0 + 8 * i < C)
          *reinterpret_cast<float2*>(row + 8 * i) = make_float2(
              scale * acc[4 * i + 2 * hh], scale * acc[4 * i + 2 * hh + 1]);
    }
  }
}

template <bool kWide>
cudaError_t launch_wgmma(const lfb::bf16* q, const lfb::bf16* k,
                         const lfb::bf16* v, const lfb::bf16* dout,
                         const float* lse, const float* delta, float* dq,
                         float* dk, float* dv, int B, int Nq, int Nk, int C,
                         float scale, cudaStream_t stream) {
  using K1 = Dkdv<kWide>;
  using K2 = Dq<kWide>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = lfb::tma_map_bf16(&tq, q, B, Nq, C, K1::BQ);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tdo, dout, B, Nq, C, K1::BQ);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tk, k, B, Nk, C, 64);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tv, v, B, Nk, C, 64);
  if (err == cudaSuccess)
    err = lfb::allow_smem(attn_bwd_dkdv_wgmma_kernel<kWide>, K1::kSmem);
  if (err != cudaSuccess) return err;
  const int key_tiles = (Nk + 63) / 64;
  if constexpr (kWide) {
    // Clusters of two CTAs, one per half of the channels.
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * key_tiles, B);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = K1::kSmem;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, attn_bwd_dkdv_wgmma_kernel<true>, tq, tk,
                             tv, tdo, lse, delta, dk, dv, Nq, Nk, C, scale);
  } else {
    attn_bwd_dkdv_wgmma_kernel<false>
        <<<dim3(key_tiles, B), kWgThreads, K1::kSmem, stream>>>(
            tq, tk, tv, tdo, lse, delta, dk, dv, Nq, Nk, C, scale);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tq, q, B, Nq, C, K2::BR);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tdo, dout, B, Nq, C, K2::BR);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tk, k, B, Nk, C, K2::BK);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tv, v, B, Nk, C, K2::BK);
  if (err == cudaSuccess)
    err = lfb::allow_smem(attn_bwd_dq_wgmma_kernel<kWide>, K2::kSmem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_wgmma_kernel<kWide>
      <<<dim3((Nq + K2::BR - 1) / K2::BR, B), kWgThreads, K2::kSmem, stream>>>(
          tq, tk, tv, tdo, lse, delta, dq, Nq, Nk, C, scale);
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
    if (C <= 256)
      return launch_wgmma<false>(qp, kp, vp, op, lp, dp, dqp, dkp, dvp, B, Nq,
                                 Nk, C, scale, stream);
    return launch_wgmma<true>(qp, kp, vp, op, lp, dp, dqp, dkp, dvp, B, Nq, Nk,
                              C, scale, stream);
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
