// Fused softmax attention, forward: out = softmax(q k^T * scale) v over
// (B, Nq, C) queries and (B, Nk, C) keys/values, no mask (padded bank rows
// take part in the softmax, as in the reference).  Output in the input type.
// Replaces lfb_tpu/ops/pallas_attention.py:_fwd_call (kernel _attn_kernel).
// Given a non-null `lse`, it also writes the f32 row log-sum-exp (B, Nq) of
// the scaled logits, which the backward kernels (attention_bwd.cu) read.
//
// Three launch shapes:
//  * attn_mma_kernel -- bf16 with Nq > 1: the in-backbone non-local blocks
//    (phase B at B = 16, crop 256: res3 64 x 4096 x 1024 x C 256, res4
//    16 x 4096 x 1024 x C 512).  These are matmul-sized: the 8 calls of a
//    phase-B forward do 962 GFLOP, 0.97 ms at the H100's 989 TFLOP/s bf16
//    dense, so the tensor cores bound it.  FlashAttention-style on
//    mma.sync.m16n8k16 (bf16 in, f32 accumulate): one CTA of 8 warps per
//    (batch, query tile); a warp owns 16 query rows and up to 256 O columns.
//    The Q tile stays in shared memory; tiles of K and V stream through a
//    two-stage cp.async ring.  S = Q K^T on the tensor cores (K is already
//    the B operand, no transpose), the online softmax in f32 registers with
//    exp2 and scale * log2(e) folded in, then P rounded to bf16 straight
//    from the S accumulators as the A operand of P V (V through
//    ldmatrix.trans), as lfb_tpu's XLA reference rounds p before p.V.  The
//    row sum l is taken over the f32 p.
//    At C = 512 the O accumulator (64 x 512 f32, 256 floats a thread) does
//    not fit one warp group's registers, so a CTA of 64 query rows has two
//    groups of 4 warps, each owning half of O's columns (option (a): the
//    first version split the columns across CTAs, which recomputes S, and
//    took 3.01 ms against this layout's 1.96 for the res4 call on an H100
//    SXM at 700 W).  The two warps of a row group each compute half of the
//    tile's S columns and exchange them through shared memory (f32, 10 KB),
//    so S is computed once; K and V stream in 32-key tiles (200 KB with
//    Q).  At C <= 256 a CTA is 128 query rows (8 warps) and 64-key tiles
//    in 198 KB.  Keys past Nk get s = -inf; query rows past Nq load as
//    zeros and are not stored.
//  * attn_tiled_kernel -- f32 with Nq > 1 (the parity checks run the whole
//    model in f32 and hold it to the CPU at 2e-3, which TF32 would break):
//    one CTA per (batch, 32-query tile), K and V streamed in 64-row tiles
//    through shared memory on the FMA units, each warp owning 4 rows.
//  * attn_decode_kernel -- FBO-NL (Nq == 1, Nk = 300): one CTA per box; warps
//    split the keys for the scores, a block reduction forms the softmax, and
//    threads split the channels for p.V.  Memory-bound: it reads K and V once.
#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"

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


// ---- bf16, Nq > 1: tensor cores -------------------------------------------

constexpr int kMmaThreads = 256;             // 8 warps
constexpr int kMmaDV = 256;                  // O columns per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A CTA of NCG column groups: 16 x 8/NCG query rows, and keys streamed in
// tiles of 64 (NCG = 1) or 32 (NCG = 2, where K and V are twice as wide).
__host__ __device__ constexpr int mma_rows(int ncg) { return 16 * (8 / ncg); }
__host__ __device__ constexpr int mma_keys(int ncg) { return ncg == 1 ? 64 : 32; }

// Shared memory of attn_mma_kernel<NCG, *>: the Q tile, two stages of K and
// V (rows padded by 8 bf16) and, with two column groups, the f32 S tile.
inline size_t mma_smem_bytes(int C, int ncg) {
  return (size_t)(mma_rows(ncg) + 4 * mma_keys(ncg)) * (C + 8) *
             sizeof(lfb::bf16) +
         (ncg > 1 ? (size_t)mma_rows(ncg) * (mma_keys(ncg) + 8) * sizeof(float)
                  : 0);
}

// NCG column groups of 8 / NCG warps: warp w owns query rows 16 (w % NRG)
// of the tile and O columns kMmaDV (w / NRG).  With NCG = 2 (C > 256) the
// two warps of a row group each compute half of the tile's S columns,
// exchange them through shared memory, and both run the softmax on the
// whole row.  CC > 0 fixes C at compile time (the model's 256 and 512), so
// the C-deep loops unroll and the column guards fold away; with the
// 128-row CTAs this took the res3 call of a phase-B forward from 2.79 to
// 1.46 ms on an H100 SXM at 700 W.  CC = 0 takes C from the argument.
template <int NCG, int CC>
__global__ void __launch_bounds__(kMmaThreads)
attn_mma_kernel(const lfb::bf16* __restrict__ q, const lfb::bf16* __restrict__ k,
                const lfb::bf16* __restrict__ v, lfb::bf16* __restrict__ out,
                float* __restrict__ lse, int Nq, int Nk, int C_arg,
                float scale_log2) {
  using lfb::bf16;
  constexpr int NRG = 8 / NCG;
  constexpr int BQ = mma_rows(NCG);
  constexpr int BK = mma_keys(NCG);
  constexpr int lds = BK + 8;                // f32 S row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = CC > 0 ? CC : C_arg;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp % NRG;
  const int cg = warp / NRG;
  const int c_lo = cg * kMmaDV;
  const int nc = min(kMmaDV, C - c_lo);      // a multiple of 32
  const int ld = C + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // BQ x ld
  bf16* sK = sQ + BQ * ld;                     // 2 x BK x ld
  bf16* sV = sK + 2 * BK * ld;                     // 2 x BK x ld
  float* sS = reinterpret_cast<float*>(sV + 2 * BK * ld);   // BQ x lds
  const bf16* qb = q + (size_t)b * Nq * C;
  const bf16* kb = k + (size_t)b * Nk * C;
  const bf16* vb = v + (size_t)b * Nk * C;

  auto load_kv = [&](int tile, int buf) {
    lfb::load_tile_async(sK + buf * BK * ld, ld, kb, C, tile * BK, BK, Nk, 0, C);
    lfb::load_tile_async(sV + buf * BK * ld, ld, vb, C, tile * BK, BK, Nk, 0, C);
  };
  lfb::load_tile_async(sQ, ld, qb, C, q0, BQ, Nq, 0, C);
  load_kv(0, 0);
  lfb::cp_async_commit();

  float o[kMmaDV / 8][4];
#pragma unroll
  for (int n = 0; n < kMmaDV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Rows g and g + 8 of this warp's 16: running max (log2 units) and the
  // thread's partial row sum (its quad's four partials add up at the end).
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_r[2] = {0.f, 0.f};
  const int ntiles = (Nk + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_kv(t + 1, buf ^ 1);
      lfb::cp_async_commit();
      lfb::cp_async_wait<1>();
    } else {
      lfb::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + buf * BK * ld;
    const bf16* tV = sV + buf * BK * ld;

    // S = Q K^T: this warp's 16-key pairs of n-tiles (all of them if NCG = 1).
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4];
      lfb::ldsm_x4(a, lfb::a_frag(sQ, ld, rg * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        if (np % NCG == cg) {
          uint32_t bb[4];
          lfb::ldsm_x4(bb, lfb::b_frag(tK, ld, np * 16, kk, lane));
          lfb::mma_16816(s[2 * np], a, bb[0], bb[1]);
          lfb::mma_16816(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    if constexpr (NCG > 1) {
      float* srow = sS + (rg * 16 + (lane >> 2)) * lds + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        if ((n / 2) % NCG == cg) {
          *reinterpret_cast<float2*>(srow + n * 8) = make_float2(s[n][0], s[n][1]);
          *reinterpret_cast<float2*>(srow + 8 * lds + n * 8) =
              make_float2(s[n][2], s[n][3]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float2 lo = *reinterpret_cast<const float2*>(srow + n * 8);
        const float2 hi = *reinterpret_cast<const float2*>(srow + 8 * lds + n * 8);
        s[n][0] = lo.x;
        s[n][1] = lo.y;
        s[n][2] = hi.x;
        s[n][3] = hi.y;
      }
    }

    // Online softmax over this tile's keys.
    float mx[2] = {m_r[0], m_r[1]};
    const int key0 = t * BK + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (key0 + n * 8 + (e & 1) < Nk) ? s[n][e] * scale_log2
                                                      : -CUDART_INF_F;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_r[h] - mx[h]);      // 0 on the first tile
      m_r[h] = mx[h];
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < kMmaDV / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over this warp's columns, P rounded to bf16 from the S
    // accumulators.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      lfb::pack_a(pa, s, kc);
#pragma unroll
      for (int np = 0; np < kMmaDV / 16; ++np) {
        if (np * 16 < nc) {
          uint32_t bb[4];
          lfb::ldsm_x4_trans(bb, lfb::bt_frag(tV, ld, kc * 16, c_lo + np * 16,
                                              lane));
          lfb::mma_16816(o[2 * np], pa, bb[0], bb[1]);
          lfb::mma_16816(o[2 * np + 1], pa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                          // before this stage is reloaded
  }

  float inv[2];
  int row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    inv[h] = 1.f / l_r[h];
    row[h] = q0 + rg * 16 + (lane >> 2) + 8 * h;
    if (lse != nullptr && cg == 0 && (lane & 3) == 0 && row[h] < Nq)
      lse[(size_t)b * Nq + row[h]] = m_r[h] * kLn2 + logf(l_r[h]);
  }
#pragma unroll
  for (int n = 0; n < kMmaDV / 8; ++n) {
    if (n * 8 < nc) {
      const int col = c_lo + n * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] < Nq)
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((size_t)b * Nq + row[h]) * C + col) =
              __floats2bfloat162_rn(o[n][2 * h] * inv[h],
                                    o[n][2 * h + 1] * inv[h]);
      }
    }
  }
}

template <int NCG, int CC>
cudaError_t launch_mma(const lfb::bf16* q, const lfb::bf16* k,
                       const lfb::bf16* v, lfb::bf16* out, float* lse, int B,
                       int Nq, int Nk, int C, float scale,
                       cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(C, NCG);
  cudaError_t err = lfb::allow_smem(attn_mma_kernel<NCG, CC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Nq + mma_rows(NCG) - 1) / mma_rows(NCG), B);
  attn_mma_kernel<NCG, CC><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, out, lse, Nq, Nk, C, scale * kLog2e);
  return cudaGetLastError();
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
  } else if constexpr (std::is_same<T, lfb::bf16>::value) {
    if (C == 256)
      return launch_mma<1, 256>(qp, kp, vp, op, lp, B, Nq, Nk, C, scale,
                                stream);
    if (C == 512)
      return launch_mma<2, 512>(qp, kp, vp, op, lp, B, Nq, Nk, C, scale,
                                stream);
    if (C <= kMmaDV)
      return launch_mma<1, 0>(qp, kp, vp, op, lp, B, Nq, Nk, C, scale, stream);
    return launch_mma<2, 0>(qp, kp, vp, op, lp, B, Nq, Nk, C, scale, stream);
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
