// Stem convolution, weight gradient: dW of conv1 (kT x 7 x 7, stride
// (1, 2, 2), padding (kT / 2, 3, 3), Cin 3 -> Cout 64, channels-last) from
// the input x (B, T, H, W, 3) and the output gradient g (B, T, Ho, Wo, 64),
// both in the input type:
//   dW[kt, kh, kw, ci, co] = sum over (b, t, ho, wo) of
//       x[b, t + kt - kT/2, 2 ho + kh - 3, 2 wo + kw - 3, ci] * g[b, t, ho, wo, co]
// in f32, out of range taps reading zero.  Replaces
// lfb_tpu/ops/pallas_stem.py:_stem_dw_kernel (stem_conv_s2d_dw).
//
// 47,040 outputs (kT = 5), each a sum over B * T * Ho * Wo positions (6.4 M
// at B = 16, T = 32, crop 224): per frame and temporal tap, one product
// (taps x pixels) . (pixels x 64 channels) reduced over the frame's 12,544
// output pixels, 604 GFLOP of the direct conv at that shape, so on the H100
// it is bound by arithmetic (0.61 ms at 989 TFLOP/s; g is 822 MB, 0.25 ms
// at 3.35 TB/s).  The TPU kernel kept the whole dW resident in VMEM across
// a sequential grid; CTAs run in parallel and in no order, so the work is
// split in two launches with no atomics (deterministic): partial sums of
// dW in a fixed order per CTA, then stem_dw_reduce_kernel, one thread per
// dW element, sums the partials in a fixed order.
//
// bf16 (stem_dw_wgmma_kernel): the stem forward's design (stem_conv.cu) in
// reverse, on wgmma over the TPU kernel's space-to-depth packing
// (pallas_stem.py:_pack_x / _unpack_dw4; stem_s2d.cuh): the stride-2 7 x 7
// conv is a stride-1 4 x 4 conv over 16 packed channels (1.74x the
// multiply-adds, 1.05 TFLOP at the shape above), and dW of one temporal tap
// is W4[(dh, dw, c16), co] = sum over pixels of xs[pixel + (dh, dw), c16] *
// g[pixel, co]: M = 16 taps x 16 channels = 256, N = 64, K = pixels.
//  * Persistent CTAs, one an SM: each takes one temporal tap kt and a
//    contiguous share of that tap's (clip, frame, band of 256 output
//    pixels) items, leaving out the frames whose input frame t + kt - kT /
//    2 lies outside [0, T), and keeps its sums in registers across all of
//    them.  The taps get CTAs in proportion to their frames (dw_first), so
//    the CTAs of the kT taps walk about the same frames together and g,
//    read kT times, comes mostly from L2.  Each CTA writes one 64 KB
//    partial (8.6 MB in all on 132 SMs, against 168 MB for one per frame
//    and tap at B = 16), which the reduce sums in CTA order.
//  * A producer warpgroup loads each band of g (256 pixels x 128 bytes, the
//    128-byte swizzle) by TMA and packs the band's x rows (its output rows
//    + 3, Wo + 3 packed pixels each) into the same ring stage by cp.async,
//    so the packing never touches device memory; a full mbarrier per stage
//    counts its 128 threads and the TMA's bytes.
//  * Two consumer warpgroups own 2 m64 tiles each (8 of the 16 (dh, dw)
//    taps; 64 f32 accumulators a thread).  Per 16 pixels each warp takes
//    its tap's A (16 packed channels x 16 pixels) with one ldmatrix.trans
//    per tile from per-lane pixel addresses shifted by (dh, dw) (pixels
//    along rows, as the old mma.sync kernel took it), and issues wgmma
//    m64n64k16 with A from registers and B the g band from shared memory,
//    MN-major (channels contiguous: the descriptor's transpose bit).  A
//    lives in a two-slot register ring; a ring stage goes back to the
//    producer once the last group that read it has finished.
//  * Edges: pixels past a ragged band read the band's first packed pixel
//    against rows of g that lie outside the tensor, which TMA fills with
//    zeros.  Where W is odd or x not 4-byte aligned, the producer loads
//    2-byte values instead of copying words.
//
// f32 (stem_dw_partial_kernel): the f32 train step is held to the CPU at
// 1e-4, which TF32 would break, so f32 stays on the FMA units: each of its
// 196 threads owns one (kh, kw) tap x 3 input channels x 16 output
// channels, 48 f32 accumulators and 48 FMAs for 3 + 16 shared-memory reads
// per position, over the frame's output gradient and input halo staged as
// f32 band by band.
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "stem_s2d.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kCin = 3;
constexpr int kCout = 64;
constexpr int kK = 7;
constexpr int kPad = 3;
constexpr int kTaps = kK * kK;                     // (kh, kw) pairs
constexpr int kChPerThread = 16;
constexpr int kThreads = kTaps * (kCout / kChPerThread);   // 196
constexpr int kTapW = kTaps * kCin * kCout;        // dW of one temporal tap
constexpr int kPixSlots = 256;                     // output pixels per band

__global__ void __launch_bounds__(kThreads)
stem_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ partial, int Tn, int H, int W,
                       int kT, int Ho, int Wo, int TH) {
  extern __shared__ __align__(16) float smem[];
  const int Wp = W + 2 * kPad;
  float* sg = smem;                      // (<= 256 pixels, 64) output gradient
  float* sx = smem + kPixSlots * kCout;  // (2 TH + 5, Wp, 3) input halo

  const int frame = blockIdx.x;          // b * Tn + t
  const int kt = blockIdx.y;
  const int b = frame / Tn;
  const int t = frame - b * Tn;
  const int tin = t + kt - kT / 2;
  const int tid = threadIdx.x;
  const int tap = tid % kTaps;
  const int kh = tap / kK;
  const int kw = tap - kh * kK;
  const int cg = tid / kTaps;            // output channels cg*16 .. cg*16+15

  float acc[kCin][kChPerThread];
#pragma unroll
  for (int ci = 0; ci < kCin; ++ci)
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) acc[ci][j] = 0.f;

  if (tin >= 0 && tin < Tn) {            // uniform over the CTA
    const float* xf = x + ((size_t)b * Tn + tin) * H * W * kCin;
    const float* gf = g + (size_t)frame * Ho * Wo * kCout;
    for (int ho0 = 0; ho0 < Ho; ho0 += TH) {
      const int rows = min(TH, Ho - ho0);
      const int rows_in = 2 * rows + kK - 2;
      const int hin0 = 2 * ho0 - kPad;
      __syncthreads();                   // the previous band's readers are done
      for (int i = tid; i < rows * Wo * kCout; i += kThreads)
        sg[i] = gf[(size_t)ho0 * Wo * kCout + i];
      for (int i = tid; i < rows_in * Wp * kCin; i += kThreads) {
        const int ci = i % kCin;
        const int rest = i / kCin;
        const int col = rest % Wp;
        const int row = rest / Wp;
        const int hin = hin0 + row;
        const int win = col - kPad;
        float val = 0.f;
        if (hin >= 0 && hin < H && win >= 0 && win < W)
          val = xf[((size_t)hin * W + win) * kCin + ci];
        sx[i] = val;
      }
      __syncthreads();

      for (int r = 0; r < rows; ++r) {
        for (int c = 0; c < Wo; ++c) {
          const float* xp = sx + ((2 * r + kh) * Wp + 2 * c + kw) * kCin;
          const float4* gv = reinterpret_cast<const float4*>(
              sg + (r * Wo + c) * kCout + cg * kChPerThread);
          const float4 g0 = gv[0], g1 = gv[1], g2 = gv[2], g3 = gv[3];
#pragma unroll
          for (int ci = 0; ci < kCin; ++ci) {
            const float xv = xp[ci];
            acc[ci][0] += xv * g0.x;  acc[ci][1] += xv * g0.y;
            acc[ci][2] += xv * g0.z;  acc[ci][3] += xv * g0.w;
            acc[ci][4] += xv * g1.x;  acc[ci][5] += xv * g1.y;
            acc[ci][6] += xv * g1.z;  acc[ci][7] += xv * g1.w;
            acc[ci][8] += xv * g2.x;  acc[ci][9] += xv * g2.y;
            acc[ci][10] += xv * g2.z; acc[ci][11] += xv * g2.w;
            acc[ci][12] += xv * g3.x; acc[ci][13] += xv * g3.y;
            acc[ci][14] += xv * g3.z; acc[ci][15] += xv * g3.w;
          }
        }
      }
    }
  }

  float* out = partial + ((size_t)kt * gridDim.x + frame) * kTapW +
               tap * kCin * kCout + cg * kChPerThread;
#pragma unroll
  for (int ci = 0; ci < kCin; ++ci)
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) out[ci * kCout + j] = acc[ci][j];
}

// Frames of temporal tap kt whose input frame lies in [0, T): t in [lo,
// lo + nv).
__host__ __device__ inline int dw_frames(int kt, int kT, int Tn, int* lo) {
  const int pt = kT / 2;
  *lo = pt - kt > 0 ? pt - kt : 0;
  const int hi = Tn + pt - kt < Tn ? Tn + pt - kt : Tn;
  return hi - *lo > 0 ? hi - *lo : 0;
}

// The first of the G persistent CTAs (G >= kT) that take temporal tap kt:
// one each, and the rest shared in proportion to the taps' frames.
__host__ __device__ inline int dw_first(int kt, int G, int kT, int Tn) {
  long long before = 0, all = 0;
  for (int k = 0; k < kT; ++k) {
    int lo;
    const int nv = dw_frames(k, kT, Tn, &lo);
    if (k < kt) before += nv;
    all += nv;
  }
  return kt + (int)((long long)(G - kT) * before / all);
}

// dw[kt, e] = sum over parts f (in order) of partial[f, e], for tap_w
// elements e per temporal tap: parts kt * per .. kt * per + per - 1 where
// per > 0 (f32: one per frame), else the CTAs dw_first gives tap kt of G.
__global__ void stem_dw_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dw, int per,
                                      int G, int Tn, int kT, int tap_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kT * tap_w) return;
  const int kt = i / tap_w;
  const int e = i - kt * tap_w;
  const int f0 = per > 0 ? kt * per : dw_first(kt, G, kT, Tn);
  const int f1 = per > 0 ? f0 + per
                         : (kt + 1 < kT ? dw_first(kt + 1, G, kT, Tn) : G);
  float s = 0.f;
  for (int f = f0; f < f1; ++f) s += partial[(size_t)f * tap_w + e];
  dw[i] = s;
}

cudaError_t reduce(const void* partial, void* dw, int per, int G, int Tn,
                   int kT, int tap_w, cudaStream_t stream) {
  const int n = kT * tap_w;
  stem_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), per, G, Tn,
      kT, tap_w);
  return cudaGetLastError();
}

// ---- bf16: wgmma over the space-to-depth packing ---------------------------

using lfb::bf16;
using lfb::cp_async_arrive;
using lfb::s2d::kPixBytes;
using lfb::s2d::pack_pixel;
using lfb::s2d::swizzle;

constexpr int kS2dTapW = 16 * 16 * kCout;       // dW of one temporal tap
constexpr int kWg = 128;                        // threads of a warpgroup
constexpr int kDwConsumerWgs = 2;
constexpr int kDwThreads = (kDwConsumerWgs + 1) * kWg;   // + the producer
constexpr int kBand = 256;                      // pixels of g a band: TMA box
constexpr int kGBytes = kBand * kCout * 2;      // a band of g, 128-byte rows
constexpr int kDwMaxStages = 4;
constexpr int kDwBarBytes = 2 * kDwMaxStages * 8;

// One role of a CTA: temporal tap kt over items [i0, i1) of the (clip,
// frame, band) list of the frames whose input frame t + kt - kT / 2 lies in
// [0, T): band `blk` of frame (b, lo + f) for item (b, f, blk).
struct DwItem {
  int frame, xframe, q0;
};

__device__ __forceinline__ DwItem dw_item(long long i, int nv, int nblk,
                                          int lo, int Tn, int shift) {
  const long long per_clip = (long long)nv * nblk;
  const int b = (int)(i / per_clip);
  const int rest = (int)(i - b * per_clip);
  const int f = rest / nblk;
  DwItem it;
  it.frame = b * Tn + lo + f;
  it.xframe = it.frame + shift;
  it.q0 = (rest - f * nblk) * kBand;
  return it;
}

__global__ void __launch_bounds__(kDwThreads, 1)
stem_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tg,
                     const bf16* __restrict__ x, float* __restrict__ partial,
                     int Tn, int H, int W, int kT, int Ho, int Wo, int nblk,
                     long long clips, int nstage, int stage_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + (size_t)nstage * stage_bytes);
  uint64_t* empty = full + kDwMaxStages;
  const int tid = threadIdx.x;
  // The warpgroup, warp-uniform as the compiler sees it (wgmma in a branch
  // it cannot prove uniform is serialised).
  const int wg = __shfl_sync(0xffffffffu, tid / kWg, 0);
  // This CTA's temporal tap and its share of the tap's items.
  int kt = 0;
  while (kt + 1 < kT && dw_first(kt + 1, gridDim.x, kT, Tn) <= (int)blockIdx.x)
    ++kt;
  const int first = dw_first(kt, gridDim.x, kT, Tn);
  const int nchunk =
      (kt + 1 < kT ? dw_first(kt + 1, gridDim.x, kT, Tn) : gridDim.x) - first;
  const int chunk = blockIdx.x - first;
  const int pt = kT / 2;
  int lo;
  const int nv = dw_frames(kt, kT, Tn, &lo);
  const long long items = clips * nv * nblk;
  const long long i0 = items * chunk / nchunk;
  const long long i1 = items * (chunk + 1) / nchunk;

  // The packed bands' channels 12-15 are never written: zero the stages.
  for (int i = tid; i < nstage * stage_bytes / 16; i += kDwThreads)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0u, 0u, 0u, 0u);
  lfb::fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < nstage; ++s) {
      lfb::mbar_init(&full[s], kWg + 1);     // producer threads + the TMA's
      lfb::mbar_init(&empty[s], kDwConsumerWgs * 4);   // consumer warps
    }
    lfb::mbar_init_fence();
  }
  __syncthreads();

  const int Wp = Wo + 3;
  const int HoWo = Ho * Wo;
  const uint32_t sbase = lfb::smem_addr(base);
  int stage = 0;
  uint32_t phase = 0;

  if (wg == kDwConsumerWgs) {
    // ---- producer: g bands by TMA, x packed into the band beside it ----
    const int ptid = tid - kDwConsumerWgs * kWg;
    const bool words =
        (W & 1) == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
    const size_t frame_elems = (size_t)H * W * lfb::s2d::kInC;
    // Pixel ptid of a band, and the (row, column) step of 128 pixels.
    const int lr0 = ptid / (Wo + 3), pc0 = ptid - lr0 * (Wo + 3);
    const int step_r = kWg / (Wo + 3), step_c = kWg - step_r * (Wo + 3);
    for (long long i = i0; i < i1; ++i) {
      const DwItem it = dw_item(i, nv, nblk, lo, Tn, kt - pt);
      lfb::mbar_wait(&empty[stage], phase ^ 1);
      const uint32_t sg = sbase + stage * stage_bytes;
      const uint32_t sx = sg + kGBytes;
      if (ptid == 0) {
        lfb::mbar_arrive_expect_tx(&full[stage], kGBytes);
        lfb::tma_load_3d(sg, &tg, &full[stage], 0, it.q0, it.frame);
      }
      // Packed rows r0 .. (the band's last output row) + 3.
      const int r0 = it.q0 / Wo;
      const int n = ((min(it.q0 + kBand, HoWo) - 1) / Wo - r0 + 4) * Wp;
      const bf16* xf = x + (size_t)it.xframe * frame_elems;
      int lr = lr0, pc = pc0;
      for (int j = ptid; j < n; j += kWg) {
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
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // before exiting
    return;
  }

  // ---- consumers: per 16 pixels, wgmma over 2 tiles of 4 (dh, dw) taps ----
  const int warp = (tid / 32) & 3;
  const int lane = tid & 31;
  // This lane's row of an ldmatrix.trans: pixel kl of a 16-pixel step, and
  // its half of the 16 packed channels.
  const int kl = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t half = ((lane >> 3) & 1) * 16;
  // The (dh, dw) tap of this warp's 16 rows in each tile.
  uint32_t tap_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tap = 8 * wg + 4 * i + warp;
    tap_off[i] = (uint32_t)((tap >> 2) * Wp + (tap & 3)) * kPixBytes;
  }
  const float inv_wo = 1.f / (float)Wo;
  // Zeroed before any product is issued; every product adds.
  float acc[2][32];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;
  // A of the last two steps (a step: 2 k16 steps x 2 tiles, one group of 4
  // products), so two groups stay in flight.
  uint32_t a[2][2][2][4];
  int step = 0;                  // steps issued so far
  int held = -1, held_step = 0;  // a stage whose products may still run
  // Before A slot (step & 1) is written: the group that last read it (step
  // - 2) has finished, and so has any stage whose last group was no later.
  auto retire = [&]() {
    lfb::wgmma_wait<1>();
    if (held >= 0 && held_step <= step - 2) {
      __syncwarp();
      if (lane == 0) lfb::mbar_arrive(&empty[held]);
      held = -1;
    }
  };
  for (long long i = i0; i < i1; ++i) {
    const DwItem it = dw_item(i, nv, nblk, lo, Tn, kt - pt);
    const int npix = min(kBand, HoWo - it.q0);
    const int r0 = it.q0 / Wo;
    lfb::mbar_wait(&full[stage], phase);
    const uint32_t sg = sbase + stage * stage_bytes;
    const uint32_t sx = sg + kGBytes;
    const uint64_t dbase = lfb::desc_sw128(sg, kGBytes);
    // All 16 k16 steps of the TMA box, unrolled: rows of g past a ragged
    // band lie outside the tensor, which TMA filled with zeros.  (A trip
    // count known only at run time, with products left running across
    // bands, made ptxas serialise the kernel's wgmma, C7513.)
#pragma unroll
    for (int ks = 0; ks < kBand / 16; ks += 4) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t pix[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // This lane's pixel; rows past the band read its first pixel.
          int k = 16 * (ks + 2 * u + j) + kl;
          if (k >= npix) k = 0;
          const int q = it.q0 + k;
          const int r = (int)(((float)q + 0.5f) * inv_wo);   // q / Wo, exact
          pix[j] = (uint32_t)((r - r0) * Wp + q - r * Wo) * kPixBytes + half;
        }
        retire();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int t = 0; t < 2; ++t)
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
                "%3}, [%4];\n"
                : "=r"(a[u][j][t][0]), "=r"(a[u][j][t][1]),
                  "=r"(a[u][j][t][2]), "=r"(a[u][j][t][3])
                : "r"(sx + swizzle(pix[j] + tap_off[t])));
        // B: 16 pixel rows x 64 channels of g, MN-major (one panel).
        uint64_t db[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          db[j] = lfb::desc_add(dbase, (ks + 2 * u + j) * (2048 >> 4));
        lfb::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int t = 0; t < 2; ++t)
            lfb::Wgmma<64>::rs_t<1>(acc[t], a[u][j][t], db[j]);
        lfb::wgmma_commit();
        ++step;
      }
    }
    // This stage goes back once its last group has finished (retire()); the
    // one before has gone back by now (a wait here, at the loop's edge, also
    // keeps ptxas from serialising the wgmma: C7513).
    lfb::wgmma_wait<1>();
    if (held >= 0) {
      __syncwarp();
      if (lane == 0) lfb::mbar_arrive(&empty[held]);
    }
    held = stage;
    held_step = step - 1;
    if (++stage == nstage) {
      stage = 0;
      phase ^= 1;
    }
  }
  lfb::wgmma_wait<0>();
  lfb::fence_operand(acc[0]);
  lfb::fence_operand(acc[1]);

  // partial[cta, (dh, dw), c16, co]: zeros where this role had no frame.
  float* out = partial + (size_t)blockIdx.x * kS2dTapW;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < kCout / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (8 * wg + 4 * t + warp) * 16 + (lane >> 2) + 8 * h;
        const int co = n * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + row * kCout + co) =
            make_float2(acc[t][4 * n + 2 * h], acc[t][4 * n + 2 * h + 1]);
      }
}

cudaError_t launch_bf16(const void* x, const void* g, void* partial,
                        void* dw, int B, int Tn, int H, int W, int kT,
                        cudaStream_t stream) {
  const int Ho = (H + 2 * kPad - kK) / 2 + 1;
  const int Wo = (W + 2 * kPad - kK) / 2 + 1;
  const int Wp = Wo + 3;
  const long long HoWo = (long long)Ho * Wo;
  const long long frames = (long long)B * Tn;
  if (frames > 65535 || HoWo > INT_MAX) return cudaErrorInvalidValue;
  int dev, max_smem, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // A stage: a band of g, then the packed rows of its output rows + 3.
  long long rows = 0;
  for (long long q0 = 0; q0 < HoWo; q0 += kBand)
    rows = std::max(rows, (std::min(q0 + kBand, HoWo) - 1) / Wo - q0 / Wo + 4);
  const int stage_bytes =
      (int)((kGBytes + rows * Wp * kPixBytes + 1023) & ~1023LL);
  const int nstage = std::min(
      kDwMaxStages, (max_smem - 1024 - kDwBarBytes) / stage_bytes);
  if (nstage < 2) return cudaErrorInvalidValue;   // the wrapper keeps Wo <= 256
  const size_t smem = 1024 + (size_t)nstage * stage_bytes + kDwBarBytes;
  // One CTA an SM (at least one a temporal tap): the wrapper's scratch
  // holds max(kT, SMs) partials.
  const int G = std::max(kT, sms);
  CUtensorMap tg;
  err = lfb::tma_map_bf16(&tg, g, (int)frames, (int)HoWo, kCout, kBand);
  if (err == cudaSuccess) err = lfb::allow_smem(stem_dw_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  stem_dw_wgmma_kernel<<<G, kDwThreads, smem, stream>>>(
      tg, static_cast<const bf16*>(x), static_cast<float*>(partial), Tn, H, W,
      kT, Ho, Wo, (int)((HoWo + kBand - 1) / kBand), B, nstage, stage_bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, dw, 0, G, Tn, kT, kS2dTapW, stream);
}

cudaError_t launch_f32(const void* x, const void* g, void* partial, void* dw,
                   int B, int Tn, int H, int W, int kT, cudaStream_t stream) {
  const int Ho = (H + 2 * kPad - kK) / 2 + 1;
  const int Wo = (W + 2 * kPad - kK) / 2 + 1;
  const int TH = kPixSlots / Wo;   // >= 1: the wrapper checks Wo <= 256
  const size_t smem = (size_t)(kPixSlots * kCout +
                               (2 * TH + kK - 2) * (W + 2 * kPad) * kCin) *
                      sizeof(float);
  cudaError_t err = lfb::allow_smem(stem_dw_partial_kernel, smem);
  if (err != cudaSuccess) return err;
  const int frames = B * Tn;
  stem_dw_partial_kernel<<<dim3(frames, kT), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(partial), Tn, H, W, kT, Ho, Wo, TH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, dw, frames, 0, Tn, kT, kTapW, stream);
}

}  // namespace

// f32: x (B, T, H, W, 3); partial: scratch of kT * B * T * 9408 floats; dw:
// (kT, 7, 7, 3, 64).  bf16: x (B, T, H, W, 3) as it is; g 16-byte aligned
// (its TMA map); partial: max(kT, SMs) * 16384 floats; dw: (kT, 4,
// 4, 16, 64), the packed taps (dh, dw) x channels (hp, wp, ci).  Requires
// Wo <= 256 (checked by the Python wrapper).
LFB_EXPORT int lfb_stem_conv_dw_f32(const void* x, const void* g,
                                    void* partial, void* dw, int B, int T,
                                    int H, int W, int kT, void* stream) {
  return launch_f32(x, g, partial, dw, B, T, H, W, kT,
                    static_cast<cudaStream_t>(stream));
}

LFB_EXPORT int lfb_stem_conv_dw_bf16(const void* x, const void* g,
                                     void* partial, void* dw, int B, int T,
                                     int H, int W, int kT, void* stream) {
  return launch_bf16(x, g, partial, dw, B, T, H, W, kT,
                     static_cast<cudaStream_t>(stream));
}
