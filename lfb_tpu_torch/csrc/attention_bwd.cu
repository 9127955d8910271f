// Fused softmax attention, backward: dq, dk, dv (f32) of
// out = softmax(q k^T * scale) v from q, k, v, dO (the input type), the
// forward's f32 row log-sum-exp `lse` and delta = rowsum(dO * O), both
// (B, Nq).  With s = scale q.k, p = exp(s - lse) and
// ds = p (dO.v - delta):
//   dq_i = scale sum_j ds_ij k_j,  dk_j = scale sum_i ds_ij q_i,
//   dv_j = sum_i p_ij dO_i.
// Replaces lfb_tpu/ops/pallas_attention.py:_attn_bwd_kernel.
//
// The TPU kernel kept one batch element's whole K/V in VMEM and summed dk/dv
// across the q-tile grid dimension in a resident output block.  A CTA holds
// neither, and CTAs run in no order, so the sums are split by who owns them
// and nothing is accumulated across CTAs (the result is deterministic):
//  * attn_bwd_dkdv_kernel -- one CTA per (batch, 16-key tile) keeps that
//    tile's K and V in shared memory and its dk/dv accumulators in registers
//    (each warp owns 2 keys, each lane C/32 columns), and streams the
//    32-query tiles of q and dO with their lse and delta.
//  * attn_bwd_dq_kernel -- one CTA per (batch, 32-query tile) keeps its q, dO
//    and dq accumulators (each warp owns 4 rows, as in the forward) and
//    streams the 32-key tiles of V, then K, through one buffer; it recomputes
//    p and ds rather than storing the (Nq, Nk) matrices.
//  * attn_bwd_decode_kernel -- FBO-NL (Nq == 1): one CTA per box.
// All math is f32 on the FMA units: the NL calls (res4 at B = 8: 8 x 3136 x
// 784 x 512) are arithmetic-bound, seven matmul-sized passes in all
// (tensor cores are later work).  Query rows past Nq are loaded as zeros with
// lse = +inf, so their p is 0 and they add nothing.
#include <math_constants.h>

#include "common.cuh"

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
