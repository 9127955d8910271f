// Fused softmax attention, forward: out = softmax(q k^T * scale) v over
// (B, Nq, C) queries and (B, Nk, C) keys/values, no mask (padded bank rows
// take part in the softmax, as in the reference).  Math in f32, output in the
// input type.  Replaces lfb_tpu/ops/pallas_attention.py:_attn_kernel.  Given
// a non-null `lse`, it also writes the f32 row log-sum-exp (B, Nq) of the
// scaled logits, which the backward kernels (attention_bwd.cu) read.
//
// Two launch shapes:
//  * attn_tiled_kernel -- the in-backbone non-local blocks (Nq, Nk in the
//    thousands, C <= 512).  One CTA per (batch, 32-query tile); K and V are
//    streamed through shared memory in 64-row tiles with an online softmax,
//    so the (Nq, Nk) affinity never reaches device memory.  Each warp owns 4
//    query rows end to end (scores, row statistics and its slice of the O
//    accumulator, 4 x C/32 floats per lane in registers), so the only
//    block-wide barriers are around the K/V tile loads.
//  * attn_decode_kernel -- FBO-NL (Nq == 1, Nk = 300): one CTA per box; warps
//    split the keys for the scores, a block reduction forms the softmax, and
//    threads split the channels for p.V.  Memory-bound: it reads K and V once.
#include <math_constants.h>

#include "common.cuh"

namespace {

using lfb::from_f32;
using lfb::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 32;                      // query rows per CTA
constexpr int kRowsPerWarp = kTQ / kWarps;   // 4
constexpr int kTK = 64;                      // keys per tile: 2 per lane
constexpr int kMaxC = 512;
constexpr int kMaxCols = kMaxC / 32;         // O columns per lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, int Nq, int Nk, int C, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldkv = C + 4;           // float4-aligned rows, conflict-free reads
  float* sQ = smem;                 // kTQ x C
  float* sKV = sQ + kTQ * C;        // kTK x ldkv (K tile, then V tile)
  float* sP = sKV + kTK * ldkv;     // kTQ x kTK probabilities

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * kRowsPerWarp;
  const int ncols = C >> 5;

  const T* qb = q + (size_t)b * Nq * C;
  const T* kb = k + (size_t)b * Nk * C;
  const T* vb = v + (size_t)b * Nk * C;

  for (int i = tid; i < kTQ * C; i += kThreads) {
    const int r = i / C;
    const int c = i - r * C;
    sQ[i] = (q0 + r < Nq) ? to_f32(qb[(size_t)(q0 + r) * C + c]) : 0.f;
  }

  float acc[kRowsPerWarp][kMaxCols];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Nk; k0 += kTK) {
    const int nk = min(kTK, Nk - k0);

    // K tile.  The barrier also retires the previous tile's V reads.
    __syncthreads();
    for (int i = tid; i < kTK * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      sKV[r * ldkv + c] = (r < nk) ? to_f32(kb[(size_t)(k0 + r) * C + c]) : 0.f;
    }
    __syncthreads();

    // Scores for this warp's 4 rows x keys (lane, lane + 32).
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(sKV + lane * ldkv);
    const float4* kc = reinterpret_cast<const float4*>(sKV + (lane + 32) * ldkv);
    for (int c4 = 0; c4 < (C >> 2); ++c4) {
      const float4 a = ka[c4];
      const float4 d = kc[c4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = reinterpret_cast<const float4*>(sQ + (r0 + i) * C)[c4];
        s[i][0] += qv.x * a.x + qv.y * a.y + qv.z * a.z + qv.w * a.w;
        s[i][1] += qv.x * d.x + qv.y * d.y + qv.z * d.z + qv.w * d.w;
      }
    }

    // Online softmax, warp-local (the warp owns these rows).
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float s0 = (lane < nk) ? s[i][0] * scale : -CUDART_INF_F;
      const float s1 = (lane + 32 < nk) ? s[i][1] * scale : -CUDART_INF_F;
      const float m_new = fmaxf(m[i], lfb::warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[i] - m_new);   // 0 on the first tile
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      l[i] = l[i] * alpha + lfb::warp_sum(p0 + p1);
      m[i] = m_new;
      sP[(r0 + i) * kTK + lane] = p0;
      sP[(r0 + i) * kTK + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) acc[i][j] *= alpha;
    }

    // V tile into the same buffer.
    __syncthreads();
    for (int i = tid; i < kTK * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      sKV[r * ldkv + c] = (r < nk) ? to_f32(vb[(size_t)(k0 + r) * C + c]) : 0.f;
    }
    __syncthreads();

    for (int kk = 0; kk < nk; ++kk) {
      float p[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) p[i] = sP[(r0 + i) * kTK + kk];
      const float* vrow = sKV + kk * ldkv + lane;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < ncols) {
          const float vv = vrow[32 * j];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][j] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = q0 + r0 + i;
    if (r >= Nq) continue;
    const float inv = 1.f / l[i];
    if (lse != nullptr && lane == 0)
      lse[(size_t)b * Nq + r] = m[i] + logf(l[i]);
    T* orow = out + ((size_t)b * Nq + r) * C + lane;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j < ncols) orow[32 * j] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

// Block-wide reduction; every thread gets the result.  `red` holds kWarps
// floats; the leading barrier protects it from the previous call's readers.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? lfb::warp_max(v) : lfb::warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, int Nk, int C, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  float* sq = smem;        // C
  float* sp = sq + C;      // Nk scores, then probabilities

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* kb = k + (size_t)b * Nk * C;
  const T* vb = v + (size_t)b * Nk * C;

  for (int c = tid; c < C; c += kThreads) sq[c] = to_f32(q[(size_t)b * C + c]);
  __syncthreads();

  for (int j = warp; j < Nk; j += kWarps) {
    const T* krow = kb + (size_t)j * C;
    float d = 0.f;
    for (int c = lane; c < C; c += 32) d += sq[c] * to_f32(krow[c]);
    d = lfb::warp_sum(d);
    if (lane == 0) sp[j] = d * scale;
  }
  __syncthreads();

  float mx = -CUDART_INF_F;
  for (int j = tid; j < Nk; j += kThreads) mx = fmaxf(mx, sp[j]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int j = tid; j < Nk; j += kThreads) {
    const float e = expf(sp[j] - mx);
    sp[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);   // its barriers also publish sp
  const float inv = 1.f / sum;
  if (lse != nullptr && tid == 0) lse[b] = mx + logf(sum);

  for (int c = tid; c < C; c += kThreads) {
    float a = 0.f;
    for (int j = 0; j < Nk; ++j) a += sp[j] * to_f32(vb[(size_t)j * C + c]);
    out[(size_t)b * C + c] = from_f32<T>(a * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Nq, int Nk, int C, float scale,
                   cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  float* lp = static_cast<float*>(lse);
  if (Nq == 1) {
    const size_t smem = (size_t)(C + Nk) * sizeof(float);
    cudaError_t err = lfb::allow_smem(attn_decode_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    attn_decode_kernel<T><<<B, kThreads, smem, stream>>>(qp, kp, vp, op, lp, Nk,
                                                         C, scale);
  } else {
    const size_t smem =
        (size_t)(kTQ * C + kTK * (C + 4) + kTQ * kTK) * sizeof(float);
    cudaError_t err = lfb::allow_smem(attn_tiled_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Nq + kTQ - 1) / kTQ, B);
    attn_tiled_kernel<T><<<grid, kThreads, smem, stream>>>(qp, kp, vp, op, lp,
                                                           Nq, Nk, C, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// C must be a multiple of 32 and at most 512 when Nq > 1 (checked by the
// Python wrapper); Nq == 1 takes any C and Nk that fit shared memory.  `lse`
// is null (inference) or an f32 (B, Nq) buffer.
LFB_EXPORT int lfb_attention_f32(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int Nq, int Nk,
                                 int C, float scale, void* stream) {
  return launch<float>(q, k, v, out, lse, B, Nq, Nk, C, scale,
                       static_cast<cudaStream_t>(stream));
}

LFB_EXPORT int lfb_attention_bf16(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int Nq, int Nk,
                                  int C, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, Nq, Nk, C, scale,
                               static_cast<cudaStream_t>(stream));
}
