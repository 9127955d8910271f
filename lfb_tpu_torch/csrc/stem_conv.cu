// Stem convolution, forward: conv1 of the I3D/C2D backbones,
// kT x 7 x 7, stride (1, 2, 2), padding (kT / 2, 3, 3), Cin 3 -> Cout 64,
// channels-last: x (B, T, H, W, 3) -> out (B, T, Ho, Wo, 64), f32
// accumulation, output in the input type.  Replaces
// lfb_tpu/ops/pallas_stem.py:_stem_kernel (stem_conv_s2d).
//
// bf16 (stem_conv_wgmma_kernel): an implicit GEMM on wgmma over the TPU
// kernel's space-to-depth packing (pallas_stem.py:_pack_x / _pack_w).
// Packed pixel (r, c) of a frame holds the 2 x 2 input pixels (2r + hp - 4,
// 2c + wp - 4) x 3 channels, (hp, wp, ci), zero-padded to 16 channels: the
// stride-2 7 x 7 conv becomes a stride-1 4 x 4 conv over 16 channels (the
// taps padded to 8 x 8 with a leading zero), output (ho, wo) reading packed
// pixel (ho + dh, wo + dw), and each (dh, dw) tap is exactly one k16
// operand with no im2col.  Per output pixel that is K = kT x 16 x 16 =
// 1,280 multiply-adds per channel at kT 5 against the direct conv's 735
// (1.74x), and the product is M = pixels, N = 64 channels.
//  * What bounds it on an H100: 789 GFLOP of the direct conv at the phase-B
//    shape (16 x 32 x 256 x 256, kT 5), 1.37 TFLOP as packed, against 1.07
//    GB of output and 0.2 GB of input: operations, 1.39 ms at 989 TFLOP/s.
//    In the kernel, shared memory: each m64n64k16 reads 2 KB of A (ldmatrix)
//    and 2 KB of B for 32 cycles of tensor work, 128 bytes a cycle at the
//    tensor peak, which is all the SM's shared-memory bandwidth.
//  * Weights resident (design (a)): every temporal tap's packed
//    weights (kT x 32 KB, 160 KB at kT 5) are copied to shared memory once
//    per persistent CTA, cut into the 8 x 8 core matrices of a no-swizzle
//    K-major wgmma B operand by the wrapper (cuda_stem.pack_w_s2d): one tap
//    is a 2 KB 16 x 64 slice, its descriptor a constant offset from the
//    first.  A rolling temporal window of kT + 1 bands with the weights
//    streamed per temporal tap (design (b)) would read 160 KB of weights
//    from L2 per 256 output pixels; (a) reads each input frame's band kT
//    times instead, about 2.5 GB at the phase-B shape, from L2.
//  * Blocks of 256 output pixels of one frame (flattened row-major: 4 M
//    tiles of 64; one output row per block where 256-pixel blocks leave no
//    room for two stages), walked by persistent CTAs in (frame, block)
//    order, so the CTAs running together read the same few input frames
//    from L2.  The output block (b, t, j) takes the input band of frames
//    t + kt - kT/2 in turn; frames outside [0, T) are skipped, uniformly.
//  * Warp specialisation: a producer warpgroup reads x as it is and writes
//    the packed band of the block's output rows + 3 into a ring of 2-4
//    shared-memory stages, which move between it and the consumers through
//    full / empty mbarriers; the packing never touches device memory.  Each
//    packed pixel is 6 aligned 4-byte words of x (two rows of 2 pixels x 3
//    channels), copied by cp.async, so the producer waits on no load.
//  * Two consumer warpgroups own 2 M tiles each (2 x 32 f32 accumulators a
//    thread).  Per tap each warp loads its 16 pixel rows x 16 channels of A
//    with one ldmatrix.x4 from per-lane pixel addresses shifted by (dh, dw),
//    one tap ahead in a 2-slot register ring, and issues wgmma
//    m64n64k16 with A from registers and B from the resident weights; a
//    wait for all but the newest group frees the slot the next load
//    writes.  A packed pixel is 32 bytes; its two 16-byte halves swap
//    every fourth pixel so that the 8 rows of an ldmatrix matrix fall in 8
//    distinct bank groups.
//  * Epilogue: each warp's 16 rows go through 2 KB of staging (stmatrix)
//    and out as 16-byte stores of whole 128-byte pixel rows, where the
//    staging fits beside two stages (else 4-byte stores from the
//    accumulators).
//  * Edges: rows of a ragged last block, or an M tile past the block's
//    pixels, read the block's first pixel and are not stored (a wgmma under
//    a branch is serialised).  Where W is odd or x not 4-byte aligned, the
//    producer loads 2-byte values instead of copying words.
//
// f32 (stem_conv_kernel): the f32 forwards are held to the CPU at 2e-3 and
// the f32 train step at 1e-4, which TF32 would break, so f32 stays a direct
// convolution on the FMA units.  One CTA per (b, t, tile of TH output
// rows), with TH the largest row count whose pixels fit the CTA's 256
// pixel slots.  For each temporal tap the CTA stages that frame's input
// halo (2 TH + 5 rows, padded width, 3 channels) and the tap's 7 x 7 x 3 x
// 64 weights in shared memory; each thread accumulates 4 pixels x 16 output
// channels in registers (64 FMAs per 4 input loads and 4 broadcast float4
// weight loads).
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCin = 3;
constexpr int kCout = 64;
constexpr int kK = 7;
constexpr int kPad = 3;
constexpr int kTapW = kK * kK * kCin * kCout;   // weights of one temporal tap
constexpr int kPixPerThread = 4;
constexpr int kPixSlots = 64 * kPixPerThread;   // 64 pixel groups per CTA
constexpr int kChPerThread = 16;

__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int Tn, int H, int W, int kT, int Ho,
                 int Wo, int TH) {
  extern __shared__ __align__(16) float smem[];
  const int Wp = W + 2 * kPad;
  const int rows_in = 2 * TH + kK - 2;
  float* sw = smem;              // (7, 7, 3, 64) weights of one tap
  float* sx = smem + kTapW;      // (rows_in, Wp, 3) input halo of one frame

  const int ho0 = blockIdx.x * TH;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int hin0 = 2 * ho0 - kPad;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = warp & 3;                      // channels cg*16 .. cg*16+15
  const int pg = (warp >> 2) * 32 + lane;       // pixel group 0..63

  int prow[kPixPerThread], pcol[kPixPerThread];
  bool pok[kPixPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    const int p = pg + 64 * i;
    const int r = p / Wo;
    pok[i] = r < TH && ho0 + r < Ho;
    prow[i] = pok[i] ? r : 0;
    pcol[i] = pok[i] ? p - r * Wo : 0;
  }

  float acc[kPixPerThread][kChPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) acc[i][j] = 0.f;

  const int pt = kT / 2;
  const size_t frame = (size_t)H * W * kCin;
  for (int kt = 0; kt < kT; ++kt) {
    const int tin = t + kt - pt;
    const bool t_ok = tin >= 0 && tin < Tn;
    __syncthreads();
    for (int i = tid; i < kTapW; i += kThreads) sw[i] = w[(size_t)kt * kTapW + i];
    const float* xf = x + ((size_t)b * Tn + (t_ok ? tin : 0)) * frame;
    for (int i = tid; i < rows_in * Wp * kCin; i += kThreads) {
      const int ci = i % kCin;
      const int rest = i / kCin;
      const int col = rest % Wp;
      const int row = rest / Wp;
      const int hin = hin0 + row;
      const int win = col - kPad;
      float val = 0.f;
      if (t_ok && hin >= 0 && hin < H && win >= 0 && win < W)
        val = xf[((size_t)hin * W + win) * kCin + ci];
      sx[i] = val;
    }
    __syncthreads();
    if (!t_ok) continue;

    for (int kh = 0; kh < kK; ++kh) {
      for (int kw = 0; kw < kK; ++kw) {
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci) {
          const float4* wv = reinterpret_cast<const float4*>(
              sw + ((kh * kK + kw) * kCin + ci) * kCout + cg * kChPerThread);
          const float4 w0 = wv[0], w1 = wv[1], w2 = wv[2], w3 = wv[3];
#pragma unroll
          for (int i = 0; i < kPixPerThread; ++i) {
            const float xv =
                sx[((2 * prow[i] + kh) * Wp + 2 * pcol[i] + kw) * kCin + ci];
            acc[i][0] += xv * w0.x;  acc[i][1] += xv * w0.y;
            acc[i][2] += xv * w0.z;  acc[i][3] += xv * w0.w;
            acc[i][4] += xv * w1.x;  acc[i][5] += xv * w1.y;
            acc[i][6] += xv * w1.z;  acc[i][7] += xv * w1.w;
            acc[i][8] += xv * w2.x;  acc[i][9] += xv * w2.y;
            acc[i][10] += xv * w2.z; acc[i][11] += xv * w2.w;
            acc[i][12] += xv * w3.x; acc[i][13] += xv * w3.y;
            acc[i][14] += xv * w3.z; acc[i][15] += xv * w3.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    if (!pok[i]) continue;
    float* o = out + ((((size_t)b * Tn + t) * Ho + ho0 + prow[i]) * Wo +
                      pcol[i]) * kCout + cg * kChPerThread;
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) o[j] = acc[i][j];
  }
}

cudaError_t launch_f32(const void* x, const void* w, void* out, int B, int Tn,
                       int H, int W, int kT, cudaStream_t stream) {
  const int Ho = (H + 2 * kPad - kK) / 2 + 1;
  const int Wo = (W + 2 * kPad - kK) / 2 + 1;
  const int TH = kPixSlots / Wo;   // >= 1: the wrapper checks Wo <= 256
  const int rows_in = 2 * TH + kK - 2;
  const size_t smem =
      (size_t)(kTapW + rows_in * (W + 2 * kPad) * kCin) * sizeof(float);
  cudaError_t err = lfb::allow_smem(stem_conv_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ho + TH - 1) / TH, Tn, B);
  stem_conv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), Tn, H, W, kT, Ho, Wo, TH);
  return cudaGetLastError();
}

// ---- bf16: wgmma over the space-to-depth packing ---------------------------

using lfb::bf16;

constexpr int kWg = 128;                        // threads of a warpgroup
constexpr int kConsumerWgs = 2;
constexpr int kWgmmaThreads = (kConsumerWgs + 1) * kWg;   // + the producer
constexpr int kBlockPix = 256;                  // output pixels of a block
constexpr int kPixBytes = 32;                   // a packed pixel: 16 bf16
constexpr int kTapBytes = 16 * kCout * 2;       // one (dh, dw) tap's weights
constexpr int kKtBytes = 16 * kTapBytes;        // one temporal tap's
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 2 * kMaxStages * 8;   // full and empty mbarriers
// The epilogue's staging: 16 rows x 64 channels of bf16 per consumer warp.
constexpr int kOutStageBytes = kConsumerWgs * 4 * 16 * kCout * 2;
// Byte offsets between the core matrices of a tap's weights (pack_w_s2d):
// the two k halves of a channel group, and the 8 groups of 8 channels.
constexpr uint32_t kLeadBytes = 128;
constexpr uint32_t kStrideBytes = 256;

// Byte `b` of a packed band (pixel p at 32 p, half h at + 16 h) as stored:
// the halves swap every fourth pixel (bit 7 of b flips bit 4).
__device__ __forceinline__ uint32_t swizzle(uint32_t b) {
  return b ^ ((b >> 3) & 16);
}

// 4 bytes global -> shared, zero-filled when !valid (src must still be a
// valid address).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// The mbarrier's next arrival of this thread happens once all its earlier
// cp.async copies have landed (counted against the barrier's count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   lfb::smem_addr(bar))
               : "memory");
}

// Packed pixel (lr, pc) of a band whose first packed row is r0, from frame
// xf (H x W x 3): x rows 2 (r0 + lr) - 4 + hp, columns 2 pc - 4 + wp, 3
// channels each, in (hp, wp, ci) order: 12 values, the first 8 in the
// pixel's first half, the rest at the start of its second; outside the
// frame reads zero.  Channels 12-15 are never written: the stages start
// zeroed.
//
// `words` (W even, x 4-byte aligned: every (row, even column) pixel starts
// on a 4-byte boundary): the 6 values of a row are 3 aligned words, copied
// by cp.async, which the band's full barrier waits for.  Else by 2-byte
// loads and two stores.
__device__ __forceinline__ void pack_pixel(uint32_t sx, int lr, int pc, int Wp,
                                           const bf16* xf, int r0, int H,
                                           int W, bool words) {
  const uint32_t dst = sx + swizzle((uint32_t)(lr * Wp + pc) * kPixBytes);
  const int ih = 2 * (r0 + lr) - 4, iw = 2 * pc - 4;
  uint32_t v[6];
#pragma unroll
  for (int hp = 0; hp < 2; ++hp) {
    const int h = ih + hp;
    const bool row_ok = h >= 0 && h < H;
    if (words) {
      const bool ok = row_ok && iw >= 0 && iw + 1 < W;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          ok ? xf + ((size_t)h * W + iw) * kCin : xf);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int word = 3 * hp + k;      // of the pixel's 6
        cp_async_4((word < 4 ? dst : dst ^ 16) + (word & 3) * 4,
                   src + (ok ? k : 0), ok);
      }
    } else {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(xf);
      uint32_t e[6];
#pragma unroll
      for (int wp = 0; wp < 2; ++wp) {
        const int c = iw + wp;
        const bool ok = row_ok && c >= 0 && c < W;
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci)
          e[3 * wp + ci] = ok ? src[((size_t)h * W + c) * kCin + ci] : 0u;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[3 * hp + k] = e[2 * k] | (e[2 * k + 1] << 16);
    }
  }
  if (!words) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(dst ^ 16),
                 "r"(v[4]), "r"(v[5]));
  }
}

__global__ void __launch_bounds__(kWgmmaThreads, 1)
stem_conv_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w4,
                       bf16* __restrict__ out, int Tn, int H, int W, int kT,
                       int Ho, int Wo, int P, int nblk, int ntiles, int nstage,
                       int stage_bytes, int out_stage) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int wbytes = kT * kKtBytes;
  unsigned char* stages = smem_raw + wbytes;
  unsigned char* staging = stages + nstage * stage_bytes;   // if out_stage
  uint64_t* full = reinterpret_cast<uint64_t*>(
      staging + (out_stage ? kOutStageBytes : 0));
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  // The warpgroup, warp-uniform as the compiler sees it (wgmma in a branch
  // it cannot prove uniform is serialised).
  const int wg = __shfl_sync(0xffffffffu, tid / kWg, 0);

  // Every temporal tap's packed weights, once per CTA; the stages zeroed.
  for (int i = tid; i < wbytes / 16; i += kWgmmaThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] =
        reinterpret_cast<const uint4*>(w4)[i];
  for (int i = tid; i < nstage * stage_bytes / 16; i += kWgmmaThreads)
    reinterpret_cast<uint4*>(stages)[i] = make_uint4(0u, 0u, 0u, 0u);
  lfb::fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < nstage; ++s) {
      lfb::mbar_init(&full[s], kWg);                   // producer threads
      lfb::mbar_init(&empty[s], kConsumerWgs * 4);     // consumer warps
    }
    lfb::mbar_init_fence();
  }
  __syncthreads();

  const int Wp = Wo + 3;
  const int HoWo = Ho * Wo;
  const int pt = kT / 2;
  const size_t frame_elems = (size_t)H * W * kCin;
  int stage = 0;
  uint32_t phase = 0;

  if (wg == kConsumerWgs) {
    // ---- producer: packed bands into the ring ----
    const int ptid = tid - kConsumerWgs * kWg;
    const bool words =
        (W & 1) == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
    // Pixel ptid of a band, and the (row, column) step of 128 pixels.
    const int lr0 = ptid / Wp, pc0 = ptid - lr0 * Wp;
    const int step_r = kWg / Wp, step_c = kWg - step_r * Wp;
    const uint32_t sbase = lfb::smem_addr(stages);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int frame = tile / nblk;               // b * T + t
      const int q0 = (tile - frame * nblk) * P;    // first output pixel
      const int t = frame % Tn;
      const int r0 = q0 / Wo;
      const int n = ((min(q0 + P, HoWo) - 1) / Wo - r0 + 4) * Wp;
      for (int kt = 0; kt < kT; ++kt) {
        const int tin = t + kt - pt;
        if (tin < 0 || tin >= Tn) continue;
        lfb::mbar_wait(&empty[stage], phase ^ 1);
        const uint32_t sx = sbase + stage * stage_bytes;
        const bf16* xf = x + (size_t)(frame + kt - pt) * frame_elems;
        int lr = lr0, pc = pc0;
        for (int i = ptid; i < n; i += kWg) {
          pack_pixel(sx, lr, pc, Wp, xf, r0, H, W, words);
          pc += step_c;
          lr += step_r;
          if (pc >= Wp) {
            pc -= Wp;
            ++lr;
          }
        }
        if (words)
          cp_async_arrive(&full[stage]);
        else
          lfb::mbar_arrive(&full[stage]);
        if (++stage == nstage) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // before exiting
    return;
  }

  // ---- consumers: wgmma over the band ----
  const int warp = (tid / 32) & 3;
  const int lane = tid & 31;
  const uint32_t sbase = lfb::smem_addr(stages);
  const uint64_t desc0 = lfb::wgmma_desc(smem_raw, kLeadBytes, kStrideBytes);
  const uint32_t row_bytes = (uint32_t)Wp * kPixBytes;
  float acc[2][32];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int frame = tile / nblk;
    const int q0 = (tile - frame * nblk) * P;
    const int t = frame % Tn;
    const int r0 = q0 / Wo;
    const int npix = min(P, HoWo - q0);
    // This lane's A row of each of the warpgroup's two M tiles: its byte
    // offset in the band at tap (0, 0), with the lane's k half.  Rows past
    // the block (a ragged last block, or a whole M tile past it) read the
    // block's first pixel and are not stored.
    uint32_t pix[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int m = (wg * 2 + i) * 64 + warp * 16 + (lane & 15);
      if (m >= npix) m = 0;
      const int r = (q0 + m) / Wo;
      pix[i] = (uint32_t)((r - r0) * Wp + q0 + m - r * Wo) * kPixBytes +
               (lane >> 4) * 16;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[i][k] = 0.f;

    for (int kt = 0; kt < kT; ++kt) {
      const int tin = t + kt - pt;
      if (tin < 0 || tin >= Tn) continue;
      lfb::mbar_wait(&full[stage], phase);
      const uint32_t sx = sbase + stage * stage_bytes;
      const uint64_t desc = desc0 + (uint64_t)((kt * kKtBytes) >> 4);
      uint32_t a[2][2][4];
      auto load_a = [&](uint32_t (&slot)[2][4], int tap) {
        const uint32_t off = (tap >> 2) * row_bytes + (tap & 3) * kPixBytes;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
              "[%4];\n"
              : "=r"(slot[i][0]), "=r"(slot[i][1]), "=r"(slot[i][2]),
                "=r"(slot[i][3])
              : "r"(sx + swizzle(pix[i] + off)));
      };
      lfb::wgmma_wait<1>();          // the group that last read slot 0
      load_a(a[0], 0);
#pragma unroll
      for (int tap = 0; tap < 16; ++tap) {
        lfb::wgmma_fence();
#pragma unroll
        for (int i = 0; i < 2; ++i)
          lfb::wgmma_m64n64k16_rs(acc[i], a[tap & 1][i],
                                  desc + (uint64_t)(tap * (kTapBytes >> 4)));
        lfb::wgmma_commit();
        if (tap < 15) {
          lfb::wgmma_wait<1>();      // the group that read the other slot
          load_a(a[(tap + 1) & 1], tap + 1);
        }
      }
      __syncwarp();
      if (lane == 0) lfb::mbar_arrive(&empty[stage]);
      if (++stage == nstage) {
        stage = 0;
        phase ^= 1;
      }
    }
    lfb::wgmma_wait<0>();
    lfb::fence_operand(acc[0]);
    lfb::fence_operand(acc[1]);

    if (out_stage) {
      // Per M tile, this warp's 16 rows x 64 channels through its 2 KB of
      // staging (stmatrix; row r's 16-byte chunk n at (n ^ (r % 8)) * 16),
      // then 4 rows x 128 bytes per coalesced 16-byte store.
      unsigned char* stg = staging + (wg * 4 + warp) * 2048;
      const uint32_t stg_a = lfb::smem_addr(stg);
      const int j = lane & 7, mat = lane >> 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // Matrices (rows 0-7 | 8-15) x (channels 16 k .. + 7 | + 8 .. 15).
          const int r = 8 * (mat & 1) + j, n = 2 * k + (mat >> 1);
          asm volatile(
              "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, "
              "%4};\n" ::"r"(stg_a + r * 128 + ((n ^ j) << 4)),
              "r"(lfb::pack_bf16(acc[i][8 * k], acc[i][8 * k + 1])),
              "r"(lfb::pack_bf16(acc[i][8 * k + 2], acc[i][8 * k + 3])),
              "r"(lfb::pack_bf16(acc[i][8 * k + 4], acc[i][8 * k + 5])),
              "r"(lfb::pack_bf16(acc[i][8 * k + 6], acc[i][8 * k + 7]))
              : "memory");
        }
        __syncwarp();
        const int m0 = (wg * 2 + i) * 64 + warp * 16;
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int r = 4 * s4 + mat;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + r * 128 + ((j ^ (r & 7)) << 4));
          if (m0 + r < npix)
            *reinterpret_cast<uint4*>(out + ((size_t)frame * HoWo + q0 + m0 +
                                             r) * kCout + 8 * j) = v;
        }
        __syncwarp();
      }
      continue;
    }
    // Without staging: rows g and g + 8 of this warp's 16, channels 8 n +
    // 2 (lane % 4), 4 bytes at a time.
    bf16* of = out + ((size_t)frame * HoWo + q0) * kCout + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wg * 2 + i) * 64 + warp * 16 + (lane >> 2) + 8 * h;
        if (m >= npix) continue;
        uint32_t* o = reinterpret_cast<uint32_t*>(of + (size_t)m * kCout);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          o[4 * n] = lfb::pack_bf16(acc[i][4 * n + 2 * h],
                                    acc[i][4 * n + 2 * h + 1]);
      }
    }
  }
}

cudaError_t launch_bf16(const void* x, const void* w4, void* out, int B,
                        int Tn, int H, int W, int kT, cudaStream_t stream) {
  const int Ho = (H + 2 * kPad - kK) / 2 + 1;
  const int Wo = (W + 2 * kPad - kK) / 2 + 1;
  const int Wp = Wo + 3;
  const long long HoWo = (long long)Ho * Wo;
  int dev, max_smem, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // A stage holds a block's output rows + 3 packed rows; blocks of 256
  // pixels where two stages fit beside the weights, else of one row.
  const int wbytes = kT * kKtBytes;
  auto stage_bytes = [&](long long rows) {
    return (int)((rows * Wp * kPixBytes + 127) & ~127LL);
  };
  int P = kBlockPix;
  long long rows = 0;
  for (long long q0 = 0; q0 < HoWo; q0 += P)
    rows = std::max(rows, (std::min(q0 + P, HoWo) - 1) / Wo - q0 / Wo + 4);
  int stage = stage_bytes(rows);
  if (wbytes + 2 * stage + kBarBytes > max_smem) {
    P = Wo;
    stage = stage_bytes(4);
  }
  // The epilogue's staging where it fits beside two stages.
  const int out_stage =
      wbytes + 2 * stage + kOutStageBytes + kBarBytes <= max_smem;
  const int fixed = wbytes + (out_stage ? kOutStageBytes : 0) + kBarBytes;
  const int nstage = std::min(kMaxStages, (max_smem - fixed) / stage);
  if (nstage < 2) return cudaErrorInvalidValue;   // the wrapper keeps kT <= 5
  const size_t smem = (size_t)fixed + (size_t)nstage * stage;
  const long long nblk = (HoWo + P - 1) / P;
  const long long ntiles = (long long)B * Tn * nblk;
  if (ntiles > INT_MAX) return cudaErrorInvalidValue;
  err = lfb::allow_smem(stem_conv_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stem_conv_wgmma_kernel, kWgmmaThreads, smem);
  if (err != cudaSuccess) return err;
  const int grid =
      (int)std::min(ntiles, (long long)sms * std::max(per_sm, 1));
  stem_conv_wgmma_kernel<<<grid, kWgmmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w4),
      static_cast<bf16*>(out), Tn, H, W, kT, Ho, Wo, P, (int)nblk,
      (int)ntiles, nstage, stage, out_stage);
  return cudaGetLastError();
}

}  // namespace

// f32: w (kT, 7, 7, 3, 64) f32.  bf16: w the packed weights of
// cuda_stem.pack_w_s2d, (kT, 4, 4, 8, 2, 8, 8) bf16, kT <= 5.  Requires
// Wo <= 256 (both checked by the Python wrapper).
LFB_EXPORT int lfb_stem_conv_f32(const void* x, const void* w, void* out,
                                 int B, int T, int H, int W, int kT,
                                 void* stream) {
  return launch_f32(x, w, out, B, T, H, W, kT,
                    static_cast<cudaStream_t>(stream));
}

LFB_EXPORT int lfb_stem_conv_bf16(const void* x, const void* w, void* out,
                                  int B, int T, int H, int W, int kT,
                                  void* stream) {
  return launch_bf16(x, w, out, B, T, H, W, kT,
                     static_cast<cudaStream_t>(stream));
}
