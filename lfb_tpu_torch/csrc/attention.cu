// Fused softmax attention, forward: out = softmax(q k^T * scale) v over
// (B, Nq, C) queries and (B, Nk, C) keys/values, no mask (padded bank rows
// take part in the softmax, as in the reference).  Output in the input type.
// Replaces lfb_tpu/ops/pallas_attention.py:_fwd_call (kernel _attn_kernel).
// Given a non-null `lse`, it also writes the f32 row log-sum-exp (B, Nq) of
// the scaled logits, which the backward kernels (attention_bwd.cu) read.
//
// Three launch shapes:
//  * attn_fwd_wgmma_kernel -- bf16 with Nq > 1: the in-backbone non-local
//    blocks (phase B at B = 16, crop 256: res3 64 x 4096 x 1024 x C 256,
//    res4 16 x 4096 x 1024 x C 512).  These are matmul-sized: the 8 calls
//    of a phase-B forward do 962 GFLOP, 0.97 ms at the H100's 989 TFLOP/s
//    bf16 dense, so the tensor cores bound it, and only wgmma reaches their
//    full rate.  FlashAttention-style and warp-specialised: a producer
//    warpgroup (its registers given back by setmaxnreg) has one thread load
//    the Q tile and rings of K and V tiles into shared memory by TMA (128-
//    byte swizzle, mbarriers), and two consumer warpgroups run S = Q K^T
//    with both operands in shared memory, the online softmax in registers
//    (exp2, scale * log2 e folded in), and O += P V with P rounded to bf16
//    straight from the S accumulators as the register A operand (as
//    lfb_tpu's XLA reference rounds p before p.V; the row sum l is taken
//    over the f32 p) and V the MN-major B operand.  C <= 256: a CTA is 128
//    query rows, 64 per group, with 64-key tiles, and the groups take turns
//    to issue so one's softmax runs under the other's products.  C up to
//    512: O (64 x 512 f32) would be 256 floats a thread, over the register
//    cap, so a CTA is 64 rows whose O columns the two groups split; each
//    sums S over its half of the channels and they swap the halves through
//    shared memory, so S is formed once (32-key tiles).  Keys past Nk get
//    s = -inf; query rows past Nq load as zeros and the TMA store of O
//    drops them.
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
#include "wgmma_bf16.cuh"

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


// ---- bf16, Nq > 1: wgmma on TMA-fed shared memory -------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWgThreads = 3 * 128;   // two consumer warpgroups, a producer one
constexpr int kStages = 2;

// The two tilings.  kSplitC = false (C <= 256): the warpgroups own 64 query
// rows each of a 128-row CTA, over 4 panels of 64 channels (zeros past C),
// and stream 64-key tiles.  kSplitC = true (C up to 512): the warpgroups
// share 64 query rows, each summing S over its half of the 8 panels and
// owning that half of O's columns; keys stream in 32-key tiles.
template <bool kSplitC>
struct Fwd {
  static constexpr int NP = kSplitC ? 8 : 4;         // 64-channel panels
  static constexpr int BQ = kSplitC ? 64 : 128;      // query rows a CTA
  static constexpr int BK = kSplitC ? 32 : 64;       // keys a tile
  static constexpr int PS = kSplitC ? NP / 2 : NP;   // panels of S a group
  static constexpr int kQBytes = NP * BQ * 128;
  static constexpr int kTileBytes = NP * BK * 128;   // K or V
  // Partial S tiles exchanged by the two groups: 2 slots x 2 groups.
  static constexpr int kExBytes = kSplitC ? 2 * 2 * 64 * BK * 4 : 0;
  static constexpr int kBarOffset =
      kQBytes + 2 * kStages * kTileBytes + kExBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 128;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// FlashAttention-style forward on wgmma.  Warpgroup 2 is the producer: one
// thread loads the Q tile once, and K and V tiles into two-stage rings by
// TMA (a full and an empty mbarrier per stage, K's and V's apart, so a K
// stage goes back as soon as its S is done).  Each consumer warpgroup, per
// tile: S = Q K^T with both operands in shared memory (K rows are keys with
// C contiguous: the K-major B operand); the online softmax in registers
// (exp2, scale * log2 e folded in; keys past Nk get -inf); P rounded to bf16
// straight from the S accumulators as the A operand of O += P V, V the
// MN-major B operand.  P V of a tile is left running while the next S is
// issued; the wait for S also retires it.  With one group per 64 rows the
// groups take turns to issue (named barriers 4 and 5), so one's softmax
// runs under the other's products.  At the end O / l goes, as bf16, into
// the group's own part of the Q tile (swizzled) and out by TMA stores,
// which drop the rows past Nq.
template <bool kSplitC>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      float* __restrict__ lse, int Nq, int Nk, int C,
                      float scale_log2) {
  using F = Fwd<kSplitC>;
  constexpr int BQ = F::BQ, BK = F::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t sq = lfb::smem_addr(base);
  const uint32_t sk = sq + F::kQBytes;                   // K stages
  const uint32_t sv = sk + kStages * F::kTileBytes;      // V stages
  float4* ex = reinterpret_cast<float4*>(base + F::kQBytes +
                                         2 * kStages * F::kTileBytes);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(base + F::kBarOffset);
  uint64_t* kempty = kfull + kStages;
  uint64_t* vfull = kempty + kStages;
  uint64_t* vempty = vfull + kStages;
  uint64_t* qbar = vempty + kStages;
  const int tid = threadIdx.x;
  // The warpgroup, warp-uniform as the compiler sees it (wgmma on a path
  // it cannot prove uniform is serialised).
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Nk + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      lfb::mbar_init(&kfull[s], 1);
      lfb::mbar_init(&kempty[s], 8);           // the consumer warps
      lfb::mbar_init(&vfull[s], 1);
      lfb::mbar_init(&vempty[s], 8);
    }
    lfb::mbar_init(qbar, 1);
    lfb::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    lfb::reg_dealloc<40>();
    // ---- producer ----
    if (tid == 256) {
      lfb::mbar_arrive_expect_tx(qbar, F::kQBytes);
      for (int p = 0; p < F::NP; ++p)
        lfb::tma_load_3d(sq + p * BQ * 128, &tq, qbar, 64 * p, q0, b);
      // K of tile t + 1 goes ahead of V of tile t.
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint64_t* full,
                      uint64_t* empty, int t) {
        const int s = t % kStages;
        lfb::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        lfb::mbar_arrive_expect_tx(&full[s], F::kTileBytes);
        for (int p = 0; p < F::NP; ++p)
          lfb::tma_load_3d(ring + s * F::kTileBytes + p * BK * 128, map,
                           &full[s], 64 * p, t * BK, b);
      };
      load(&tk, sk, kfull, kempty, 0);
      for (int t = 0; t < ntiles; ++t) {
        if (t + 1 < ntiles) load(&tk, sk, kfull, kempty, t + 1);
        load(&tv, sv, vfull, vempty, t);
      }
    }
  } else {
    // ---- consumers ----
    lfb::reg_alloc<232>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int row0 = kSplitC ? 0 : 64 * wg;      // the group's first Q row
    const int ps0 = kSplitC ? wg * F::PS : 0;    // its first panel of S's sum
    const int po0 = kSplitC ? 4 * wg : 0;        // its first panel of O
    float o[128];                // unset: the first tile's P V overwrites it
    uint32_t pa[BK / 16][4];
    // Rows g and g + 8 of this warp's 16: running max (log2 units) and the
    // thread's partial row sum (its quad's four partials add up at the end).
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_r[2] = {0.f, 0.f};
    // Turns: group 0 issues first; each group issues S (and the P V before
    // it) in its turn and passes the turn on.
    if (!kSplitC && wg == 1) lfb::named_bar_arrive(4, 256);
    lfb::mbar_wait(qbar, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      lfb::mbar_wait(&kfull[st], (t / kStages) & 1);
      if (!kSplitC && t == 0) lfb::named_bar_sync(4 + wg, 256);
      // S = Q K^T (with kSplitC, over this group's half of the channels),
      // issued in this group's turn, into an accumulator fresh each tile
      // (the first product overwrites it): one carried over from the last
      // tile would be defined by the softmax inside P V's pipeline stage,
      // and ptxas would serialise the wgmma (C7515).
      const uint32_t tk_addr = sk + st * F::kTileBytes;
      float s[BK / 2];
      lfb::wgmma_fence();
#pragma unroll
      for (int p = 0; p < F::PS; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lfb::wgmma_ss<BK>(
              s,
              lfb::desc_sw128(sq + (ps0 + p) * BQ * 128 + row0 * 128 + 32 * j,
                              16),
              lfb::desc_sw128(tk_addr + (ps0 + p) * BK * 128 + 32 * j, 16),
              (p | j) != 0);
      lfb::wgmma_commit();
      if (!kSplitC) lfb::named_bar_arrive(4 + (wg ^ 1), 256);
      lfb::wgmma_wait<0>();        // this S, and the last tile's P V
      lfb::fence_operand(s);
      lfb::fence_operand(o);
      __syncwarp();
      if (lane == 0) {
        lfb::mbar_arrive(&kempty[st]);
        if (t > 0) lfb::mbar_arrive(&vempty[(t - 1) % kStages]);
      }
      if constexpr (kSplitC) {
        // Each group summed S over half of C: swap the halves (in the
        // accumulator's own order, slot t % 2) and add, the same sum in both.
        float4* mine = ex + ((t & 1) * 2 + wg) * (BK / 8) * 128;
        float4* theirs = ex + ((t & 1) * 2 + (wg ^ 1)) * (BK / 8) * 128;
        const int i = tid & 127;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mine[j * 128 + i] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                          s[4 * j + 3]);
        lfb::named_bar_sync(1, 256);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float4 x = theirs[j * 128 + i];
          s[4 * j] += x.x;
          s[4 * j + 1] += x.y;
          s[4 * j + 2] += x.z;
          s[4 * j + 3] += x.w;
        }
      }

      // Online softmax over this tile's keys.
      float mx[2] = {m_r[0], m_r[1]};
      const int key0 = t * BK + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const float x = (key0 + 8 * (e >> 2) + (e & 1) < Nk) ? s[e] * scale_log2
                                                             : -CUDART_INF_F;
        s[e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = lfb::fast_exp2(m_r[h] - mx[h]);      // 0 on the first tile
        m_r[h] = mx[h];
        l_r[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const float p = lfb::fast_exp2(s[e] - m_r[(e >> 1) & 1]);
        l_r[(e >> 1) & 1] += p;
        s[e] = p;
      }
#pragma unroll
      for (int e = 0; e < 128; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) lfb::acc_to_a(pa[kc], s, kc);

      // O += P V over the group's 256 columns.
      lfb::mbar_wait(&vfull[st], (t / kStages) & 1);
      if (!kSplitC) lfb::named_bar_sync(4 + wg, 256);
      const uint32_t tv_addr = sv + st * F::kTileBytes;
      lfb::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        lfb::Wgmma<256>::rs_t(
            o, pa[kc],
            lfb::desc_sw128(tv_addr + po0 * BK * 128 + kc * 16 * 128, BK * 128),
            t > 0 || kc > 0);
      lfb::wgmma_commit();
    }
    if (!kSplitC && wg == 0) lfb::named_bar_arrive(5, 256);
    lfb::wgmma_wait<0>();
    lfb::fence_operand(o);

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
      inv[h] = 1.f / l_r[h];
      const int row = q0 + row0 + 16 * warp + (lane >> 2) + 8 * h;
      if (lse != nullptr && (!kSplitC || wg == 0) && (lane & 3) == 0 &&
          row < Nq)
        lse[(size_t)b * Nq + row] = m_r[h] * kLn2 + logf(l_r[h]);
    }
    // O / l as bf16 into the group's own panels of the Q tile (no other group
    // reads them), swizzled as TMA stores them.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * warp + (lane >> 2) + 8 * h;
        const uint32_t off = (po0 + (i >> 3)) * BQ * 128 + r * 128 +
                             (((i & 7) ^ (r & 7)) << 4) + (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(base + off) =
            lfb::pack_bf16(o[4 * i + 2 * h] * inv[h],
                           o[4 * i + 2 * h + 1] * inv[h]);
      }
    }
    lfb::fence_proxy_async();
    lfb::named_bar_sync(2 + wg, 128);
    if ((tid & 127) == 0) {
      for (int p = 0; p < 4; ++p)
        if (64 * (po0 + p) < C)
          lfb::tma_store_3d(&to, sq + (po0 + p) * BQ * 128 + row0 * 128,
                            64 * (po0 + p), q0 + row0, b);
      lfb::tma_store_wait();
    }
  }
}

template <bool kSplitC>
cudaError_t launch_wgmma(const lfb::bf16* q, const lfb::bf16* k,
                         const lfb::bf16* v, lfb::bf16* out, float* lse, int B,
                         int Nq, int Nk, int C, float scale,
                         cudaStream_t stream) {
  using F = Fwd<kSplitC>;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = lfb::tma_map_bf16(&tq, q, B, Nq, C, F::BQ);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tk, k, B, Nk, C, F::BK);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&tv, v, B, Nk, C, F::BK);
  if (err == cudaSuccess) err = lfb::tma_map_bf16(&to, out, B, Nq, C, 64);
  if (err == cudaSuccess)
    err = lfb::allow_smem(attn_fwd_wgmma_kernel<kSplitC>, F::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Nq + F::BQ - 1) / F::BQ, B);
  attn_fwd_wgmma_kernel<kSplitC><<<grid, kWgThreads, F::kSmem, stream>>>(
      tq, tk, tv, to, lse, Nq, Nk, C, scale * kLog2e);
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
    if (C <= 256)
      return launch_wgmma<false>(qp, kp, vp, op, lp, B, Nq, Nk, C, scale,
                                 stream);
    return launch_wgmma<true>(qp, kp, vp, op, lp, B, Nq, Nk, C, scale, stream);
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
