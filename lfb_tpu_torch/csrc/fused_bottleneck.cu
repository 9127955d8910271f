// Fused identity bottleneck (inference): a whole ResNet identity block with
// the frozen affine folded into the weights,
//
//   h1  = relu(conv_{kT x 1 x 1}(x) + b2a)            branch2a, C -> Ci
//   h2  = relu(conv_{1 x 3 x 3, dilation d}(h1) + b2b) branch2b, Ci -> Ci
//   out = relu(conv_{1 x 1 x 1}(h2) + b2c + x)         branch2c + identity
//
// channels-last: x, out (B, T, H, W, C); f32 accumulation; h1 and h2 rounded
// to the input type, as the TPU kernel rounds them.  Replaces
// lfb_tpu/ops/pallas_bottleneck.py:fused_identity_bottleneck (_kernel).
//
// What bounds it on an H100: at the R101 shapes a block does 0.3-6.5 M
// multiply-adds per pixel against 2 C input and output values, far above the
// card's bytes-per-FLOP line, so it is bound by arithmetic.  The kernel keeps
// the Ci-wide intermediates out of device memory, as the TPU kernel does,
// reads x once (plus the residual) and writes the output once.  The TPU
// design (a ring of whole input frames in a 32 MB VMEM, DMA prefetch) does
// not fit a 227 KB block and is not carried over.  Both paths run one CTA
// per (clip, frame, band of output rows; in bf16 a band of one residue's
// sub-image, below):
//   1. branch2a for the band and its halo rows that lie in the image -> h1
//      in shared memory (input type).  Temporal taps outside [0, T) are
//      skipped (their product is the conv's temporal zero padding).
//   2. branch2b as 9 shifted taps over h1; rows and columns outside the
//      image read 0 (branch2b's spatial zero padding, not relu(b2a)).
//   3. branch2c, + b2c, + x, relu, one write.
//
// bf16 (fused_bottleneck_wgmma_kernel): the three stages are GEMMs on wgmma
// (bf16 in, f32 accumulate), fed by a producer warpgroup through a ring of
// 16 KB shared-memory slots under full / empty mbarriers (one producer
// thread issues the TMA loads; the two consumer warpgroups hand each slot
// back once their products that read it have finished).
//  * Sub-images.  A 3 x 3 tap of dilation d links only pixels of one
//    residue (h mod d, w mod d), so the block runs per residue on that
//    sub-image, where the taps are undilated: at res5 d 2 each 16 x 16
//    frame is four 8 x 8 sub-images with no halo between them.  A CTA takes
//    a band of R rows of one sub-image of one frame; h1 holds the band and
//    one row on each side that lies in the image (res4: the whole frame,
//    128 KB; the band height is chosen at launch, as below).
//  * Tilings.  Ci <= 256: each consumer warpgroup owns 64 of a pass's 128
//    pixel rows and all Cp channels (Ci rounded up to 64, 128 or 256: up to
//    128 f32 accumulators a thread).  Ci > 256 (res5): the warpgroups share
//    64 rows and split each 256 channels.
//  * Stage 1 (h1 = x w2a): x rows are the K-major A operand in shared
//    memory (TMA, 128-byte swizzle; where d > 1 the producer copies the
//    residue's pixels by cp.async in the same layout), w2a's rows the
//    MN-major B operand (the wrapper's (K, N) matrices as they are: rows of
//    a chunk past C or Ci meet zero x or h1 channels, columns past the
//    matrix read zero).  Temporal taps outside [0, T) are skipped.
//  * Stage 2 (the 3 x 3 taps over h1): A from registers by ldmatrix at
//    pixel rows shifted by the tap (h1's 16-byte chunks XOR-swizzled by
//    row), with the fragment rows whose tap leaves the image set to zero
//    (branch2b's zero padding, not relu(b2a)); a shift of a few pixels does
//    not fit a descriptor's 8-row core matrices.
//  * Stage 3 (h2 w2c): where Ci <= 256 h2 goes from the stage-2
//    accumulators straight to bf16 A fragments (acc_to_a); at Ci > 256
//    through shared memory (64 rows x Cp, the 128-byte swizzle).  The
//    output's C is walked in chunks of 64 or 128 columns (256 at Ci > 256);
//    each chunk's residual x and b2c are loaded into registers before its
//    products, so their latency runs under them, and the output pairs are
//    stored after.
//  * Every product's scale-d is an immediate and every descriptor is
//    formed after the waits before it (lfb::desc_add), so ptxas serialises
//    no wgmma (C7510-C7520); the accumulators are zeroed when no product
//    is in flight.  Each slot's products are waited for (wgmma_wait<0>)
//    before the slot goes back; the other warpgroup's products keep the
//    tensor cores busy meanwhile.
//  * What bounds it: at res4 a pass's weight chunk feeds 128 rows (128
//    FLOP a byte from L2 for the weights alone), and stage 1 streams x
//    beside it; a CTA's loads and handshakes, not the tensor cores, set
//    its pace (PERF.md).  Sharing each weight slot between the two CTAs of
//    a cluster by TMA multicast, and two m64 tiles a warpgroup at Ci <= 128,
//    were both slower on the H100 (the pair's slots go back at the slower
//    CTA's pace; the extra tiles spill) and are not kept.
//  * The band height R is chosen at launch: of those whose h1, h2 and at
//    least 4 ring slots fit the block's shared memory, the least (rows
//    padded to passes) x (products a row) x (waves of CTAs) x max(1, 6 /
//    slots).  No atomics: every output is written once by one thread.
//
// f32 (fused_bottleneck_kernel): the parity checks run the model in f32 and
// hold it to the CPU at 2e-3, which TF32 would break, so f32 stays on the
// FMA units.  Each stage is a tiled product (pixels x reduction x channels):
// the reduction is staged 16 deep in shared memory as f32 (A transposed, so
// a thread reads its 4 pixels as one float4), and each of the 256 threads
// keeps 4 pixels x 8 channels of accumulators.  The tile shape (TY: 128 x
// 64, 64 x 128 or 32 x 256 pixels x channels) follows the band's pixel
// count.  R is chosen so that a band has about 16384 / Ci pixels and at
// least 4 rows, then cut until the buffers fit the block's shared memory;
// halo rows outside the image are written to h1 as 0.
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "wgmma_bf16.cuh"

namespace {

using lfb::from_f32;
using lfb::to_f32;

constexpr int kThreads = 256;
constexpr int kKC = 16;            // reduction depth of one staged chunk
constexpr int kBandPixels = 16384;  // band pixels x Ci aimed at
constexpr int kMinBandRows = 4;

// A 16-byte vector of T, read as floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <int TY>
struct Tile {
  static constexpr int TX = kThreads / TY;
  static constexpr int TM = 4 * TY;   // pixels
  static constexpr int TN = 8 * TX;   // channels
  static constexpr int AP = TM + 4;   // row pitch of the staged A chunk
};

// As[kk][p] = A(m0 + p, k0 + kk) for one chunk; src(p, c, v) fills the VN
// values of reduction columns c .. c + VN - 1 of tile pixel p (or zeros).
template <typename T, int TY, typename Src>
__device__ __forceinline__ void stage_a(const Src& src, float* As, int tid) {
  using Tl = Tile<TY>;
  constexpr int VN = Vec<T>::N;
  constexpr int G = kKC / VN;
  for (int i = tid; i < Tl::TM * G; i += kThreads) {
    const int p = i % Tl::TM;
    const int c = (i / Tl::TM) * VN;
    float v[VN];
    src(p, c, v);
#pragma unroll
    for (int e = 0; e < VN; ++e) As[(c + e) * Tl::AP + p] = v[e];
  }
}

// Bs[kk][n] = w[(k0 + kk) * N + n0 + n], zero past N.
template <typename T, int TY>
__device__ __forceinline__ void stage_b(const T* __restrict__ w, int N, int k0,
                                        int n0, float* Bs, int tid) {
  using Tl = Tile<TY>;
  constexpr int VN = Vec<T>::N;
  constexpr int per_row = Tl::TN / VN;
  for (int i = tid; i < kKC * per_row; i += kThreads) {
    const int kk = i / per_row;
    const int n = (i % per_row) * VN;
    float v[VN];
    if (n0 + n < N) {
      Vec<T>::load(w + (size_t)(k0 + kk) * N + n0 + n, v);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) v[e] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(Bs + kk * Tl::TN + n);
#pragma unroll
    for (int q = 0; q < VN / 4; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// acc[i][j] += sum_kk As[kk][ty*4 + i] * Bs[kk][col(j)], with col(j) =
// tx*4 + j for j < 4 and TN/2 + tx*4 + j - 4 after.
template <int TY>
__device__ __forceinline__ void compute_chunk(const float* As, const float* Bs,
                                              int tx, int ty,
                                              float (&acc)[4][8]) {
  using Tl = Tile<TY>;
#pragma unroll
  for (int kk = 0; kk < kKC; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(As + kk * Tl::AP + ty * 4);
    const float4 b0 =
        *reinterpret_cast<const float4*>(Bs + kk * Tl::TN + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * Tl::TN + Tl::TN / 2 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TY>
__device__ __forceinline__ int tile_col(int n0, int tx, int j) {
  return n0 + (j < 4 ? tx * 4 + j : Tile<TY>::TN / 2 + tx * 4 + j - 4);
}

template <typename T, int TY>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w2a,
                        const T* __restrict__ b2a, const T* __restrict__ w2b,
                        const T* __restrict__ b2b, const T* __restrict__ w2c,
                        const T* __restrict__ b2c, T* __restrict__ out, int Tn,
                        int H, int W, int C, int Ci, int kT, int d, int R) {
  using Tl = Tile<TY>;
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = Ci + VN;          // 16 bytes of padding per pixel
  const int M1 = (R + 2 * d) * W;     // band + halo pixels (h1)
  const int M2 = R * W;               // band pixels (h2, output)
  T* h1 = reinterpret_cast<T*>(smem_raw);
  T* h2 = h1 + (size_t)M1 * pitch;
  float* As = reinterpret_cast<float*>(h2 + (size_t)M2 * pitch);
  float* Bs = As + kKC * Tl::AP;

  const int r0 = blockIdx.x * R;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % Tl::TX;
  const int ty = tid / Tl::TX;
  const size_t frame = (size_t)H * W * C;
  const T* xb = x + (size_t)b * Tn * frame;
  const int pt = kT / 2;

  // 1. branch2a over the band's rows r0 - d .. r0 + R + d - 1 -> h1.
  for (int m0 = 0; m0 < M1; m0 += Tl::TM) {
    for (int n0 = 0; n0 < Ci; n0 += Tl::TN) {
      float acc[4][8] = {};
      for (int k0 = 0; k0 < kT * C; k0 += kKC) {
        const int tap = k0 / C;
        const int tin = t + tap - pt;
        if (tin < 0 || tin >= Tn) continue;   // temporal zero padding
        const T* xf = xb + (size_t)tin * frame + (k0 - tap * C);
        __syncthreads();
        stage_a<T, TY>([&](int p, int c, float* v) {
          const int pm = m0 + p;
          const int r = r0 - d + pm / W;
          if (pm < M1 && r >= 0 && r < H) {
            Vec<T>::load(xf + ((size_t)r * W + pm % W) * C + c, v);
          } else {
#pragma unroll
            for (int e = 0; e < VN; ++e) v[e] = 0.f;
          }
        }, As, tid);
        stage_b<T, TY>(w2a, Ci, k0, n0, Bs, tid);
        __syncthreads();
        compute_chunk<TY>(As, Bs, tx, ty, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pm = m0 + ty * 4 + i;
        if (pm >= M1) continue;
        const int r = r0 - d + pm / W;
        const bool in_image = r >= 0 && r < H;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tile_col<TY>(n0, tx, j);
          if (n >= Ci) continue;
          // Rows outside the image are branch2b's zero padding.
          const float v =
              in_image ? fmaxf(acc[i][j] + to_f32(b2a[n]), 0.f) : 0.f;
          h1[(size_t)pm * pitch + n] = from_f32<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // 2. branch2b: 9 taps (dh, dw) over h1 -> h2.
  for (int m0 = 0; m0 < M2; m0 += Tl::TM) {
    for (int n0 = 0; n0 < Ci; n0 += Tl::TN) {
      float acc[4][8] = {};
      for (int k0 = 0; k0 < 9 * Ci; k0 += kKC) {
        const int j = k0 / Ci;
        const int dh = j / 3;
        const int dw = j % 3 - 1;
        const T* hsrc = h1 + (k0 - j * Ci);
        __syncthreads();
        stage_a<T, TY>([&](int p, int c, float* v) {
          const int pm = m0 + p;
          const int col = pm % W + dw * d;
          if (pm < M2 && col >= 0 && col < W) {
            Vec<T>::load(hsrc + (size_t)((pm / W + dh * d) * W + col) * pitch + c,
                         v);
          } else {
#pragma unroll
            for (int e = 0; e < VN; ++e) v[e] = 0.f;
          }
        }, As, tid);
        stage_b<T, TY>(w2b, Ci, k0, n0, Bs, tid);
        __syncthreads();
        compute_chunk<TY>(As, Bs, tx, ty, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pm = m0 + ty * 4 + i;
        if (pm >= M2) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = tile_col<TY>(n0, tx, jj);
          if (n >= Ci) continue;
          h2[(size_t)pm * pitch + n] =
              from_f32<T>(fmaxf(acc[i][jj] + to_f32(b2b[n]), 0.f));
        }
      }
    }
  }
  __syncthreads();

  // 3. branch2c + b2c + x, relu -> out.
  for (int m0 = 0; m0 < M2; m0 += Tl::TM) {
    for (int n0 = 0; n0 < C; n0 += Tl::TN) {
      float acc[4][8] = {};
      for (int k0 = 0; k0 < Ci; k0 += kKC) {
        __syncthreads();
        stage_a<T, TY>([&](int p, int c, float* v) {
          const int pm = m0 + p;
          if (pm < M2) {
            Vec<T>::load(h2 + (size_t)pm * pitch + k0 + c, v);
          } else {
#pragma unroll
            for (int e = 0; e < VN; ++e) v[e] = 0.f;
          }
        }, As, tid);
        stage_b<T, TY>(w2c, C, k0, n0, Bs, tid);
        __syncthreads();
        compute_chunk<TY>(As, Bs, tx, ty, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pm = m0 + ty * 4 + i;
        const int r = r0 + pm / W;
        if (pm >= M2 || r >= H) continue;
        const size_t o = ((((size_t)b * Tn + t) * H + r) * W + pm % W) * C;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tile_col<TY>(n0, tx, j);
          if (n >= C) continue;
          float v = acc[i][j] + to_f32(b2c[n]);
          v += to_f32(x[o + n]);
          out[o + n] = from_f32<T>(fmaxf(v, 0.f));
        }
      }
    }
  }
}

// The shapes both instantiations take; the block's shared-memory limit and
// the number of SMs.
cudaError_t check_shape(int B, int Tn, int H, int W, int C, int Ci, int kT,
                        int d, int* max_smem, int* sms) {
  if (B < 1 || Tn < 1 || H < 1 || W < 1 || C % kKC || Ci % kKC || C < kKC ||
      Ci < kKC || kT < 1 || kT % 2 == 0 || d < 1 || Tn > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || sms == nullptr) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T>
size_t smem_bytes(int R, int d, int W, int Ci, int ty) {
  const int tx = kThreads / ty;
  return (size_t)(2 * R + 2 * d) * W * (Ci + Vec<T>::N) * sizeof(T) +
         (size_t)kKC * (4 * ty + 4 + 8 * tx) * sizeof(float);
}

int pick_ty(int band_pixels) {
  return band_pixels >= 128 ? 32 : (band_pixels >= 64 ? 16 : 8);
}

template <typename T, int TY>
cudaError_t launch_ty(const void* x, const void* w2a, const void* b2a,
                      const void* w2b, const void* b2b, const void* w2c,
                      const void* b2c, void* out, int B, int Tn, int H, int W,
                      int C, int Ci, int kT, int d, int R, size_t smem,
                      cudaStream_t stream) {
  cudaError_t err = lfb::allow_smem(fused_bottleneck_kernel<T, TY>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + R - 1) / R, Tn, B);
  fused_bottleneck_kernel<T, TY><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w2a),
      static_cast<const T*>(b2a), static_cast<const T*>(w2b),
      static_cast<const T*>(b2b), static_cast<const T*>(w2c),
      static_cast<const T*>(b2c), static_cast<T*>(out), Tn, H, W, C, Ci, kT,
      d, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w2a, const void* b2a,
                   const void* w2b, const void* b2b, const void* w2c,
                   const void* b2c, void* out, int B, int Tn, int H, int W,
                   int C, int Ci, int kT, int d, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = check_shape(B, Tn, H, W, C, Ci, kT, d, &max_smem, nullptr);
  if (err != cudaSuccess) return err;
  // About kBandPixels / Ci pixels and at least kMinBandRows rows per band,
  // bands of even height, then cut until the buffers fit.
  int R = kBandPixels / (Ci * W);
  R = R < kMinBandRows ? kMinBandRows : R;
  R = R > H ? H : R;
  const int bands = (H + R - 1) / R;
  R = (H + bands - 1) / bands;
  while (R > 1 &&
         smem_bytes<T>(R, d, W, Ci, pick_ty(R * W)) > (size_t)max_smem)
    --R;
  const int ty = pick_ty(R * W);
  const size_t smem = smem_bytes<T>(R, d, W, Ci, ty);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  switch (ty) {
    case 32:
      return launch_ty<T, 32>(x, w2a, b2a, w2b, b2b, w2c, b2c, out, B, Tn, H,
                              W, C, Ci, kT, d, R, smem, stream);
    case 16:
      return launch_ty<T, 16>(x, w2a, b2a, w2b, b2b, w2c, b2c, out, B, Tn, H,
                              W, C, Ci, kT, d, R, smem, stream);
    default:
      return launch_ty<T, 8>(x, w2a, b2a, w2b, b2b, w2c, b2c, out, B, Tn, H,
                             W, C, Ci, kT, d, R, smem, stream);
  }
}

// ---- bf16: wgmma, x and weights streamed by TMA ----------------------------

using lfb::bf16;

constexpr int kFbThreads = 384;       // two consumer warpgroups, a producer
constexpr int kSlot = 16384;          // a ring slot
constexpr int kMaxSlots = 12;
constexpr int kBarBytes = 2 * kMaxSlots * 8;

// The two tilings.  kSplitN false (Ci <= 256): consumer warpgroup wg owns
// rows 64 wg .. 64 wg + 63 of a pass's 128 pixel rows and all Cp = kNW
// channels of h1 and h2 (up to 128 f32 accumulators a thread), and
// branch2c takes h2 straight from its accumulators as the register A
// operand.  kSplitN true (Ci > 256): the warpgroups share a pass's 64 rows
// and split each 256 channels of h1 and h2, 128 each; h2 goes through
// shared memory (64 rows x Cp) to branch2c, whose 256-column chunks they
// split the same way.  A chunk is 64 deep (64 channels of x, h1 or h2); x
// comes in slots of PR rows, the weights in 16 KB slots of WR (WR3) rows
// of the chunk's NP (N3) columns, in 64-column panels.
template <int kNW, bool kSplitN>
struct Fb {
  static constexpr int PR = kSplitN ? 64 : 128;      // pixel rows of a pass
  static constexpr int NP = kSplitN ? 2 * kNW : kNW; // h1 / h2 columns a pass
  static constexpr int N3 = kSplitN ? 2 * kNW : (kNW == 256 ? 64 : 128);
  static constexpr int NW3 = kSplitN ? kNW : N3;     // of them, a group's
  static constexpr int WR = NP * 128 > kSlot ? kSlot / (2 * NP) : 64;
  static constexpr int WR3 = N3 * 128 > kSlot ? kSlot / (2 * N3) : 64;
};

struct FbArgs {
  const bf16* x;
  const bf16* b2a;
  const bf16* b2b;
  const bf16* b2c;
  bf16* out;
  int Tn, H, W, C, Ci, Cp, Cq, kT, d, R, bands, nslot, h1_off, h2_off;
};

// The CTA's band: rows j0 .. j0 + rows - 1 of the sub-image of residue
// (ph, pw) mod d (frame pixel (ph + d i, pw + d j) is its pixel (i, j); a
// 3 x 3 tap of dilation d moves (i, j) by one), with h1 over rows s_lo ..
// s_lo + M1 / Wq - 1: the band and one row on each side, inside the image.
struct FbBand {
  int ph, pw, Hq, Wq, j0, rows, s_lo, M1, M2;
};

__device__ __forceinline__ FbBand fb_band(const FbArgs& p) {
  FbBand u;
  const int res = blockIdx.x / p.bands;
  u.ph = res / p.d;
  u.pw = res - u.ph * p.d;
  u.Hq = (p.H - u.ph + p.d - 1) / p.d;
  u.Wq = (p.W - u.pw + p.d - 1) / p.d;
  u.j0 = (blockIdx.x - res * p.bands) * p.R;
  u.rows = min(p.R, u.Hq - u.j0);
  u.s_lo = max(0, u.j0 - 1);
  u.M1 = (min(u.Hq, u.j0 + u.rows + 1) - u.s_lo) * u.Wq;
  u.M2 = u.rows * u.Wq;
  return u;
}

// Frame pixel index of sub-image pixel (i, j).
__device__ __forceinline__ int fb_pixel(const FbArgs& p, const FbBand& u,
                                        int i, int j) {
  return (u.ph + p.d * i) * p.W + u.pw + p.d * j;
}

// Byte offset in h1 (rows of Cp bf16, 16-byte chunks XOR-swizzled by the
// row's low 3 bits, so the 8 rows an ldmatrix reads fall in distinct banks)
// of row m, column c.
__device__ __forceinline__ uint32_t h1_byte(int m, int c, int Cp) {
  const int ch = c >> 3;
  return (uint32_t)m * Cp * 2 + (((ch & ~7) | ((ch ^ m) & 7)) << 4) +
         (c & 7) * 2;
}

// Byte offset in h2 (64 rows x Cp, 64-column panels of 128-byte rows with
// the 128-byte swizzle: a K-major wgmma operand) of row r, column c.
__device__ __forceinline__ uint32_t h2_byte(int r, int c) {
  return (uint32_t)(c >> 6) * 8192 + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ float2 bias_pair(const bf16* b, int c, int n) {
  return c < n ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                     b + c))
               : make_float2(0.f, 0.f);
}

// Two bf16 (low, high) as floats.
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// acc (64 x 2 N, the accumulator layout) = relu(acc + b): thread (g, tq)
// holds columns c + 8 i (c = its first) and c + 8 i + 1; b reads as zero
// from column n on.  Registers only, so the bias loads all overlap (a
// store between them would keep each load behind it).
template <int N>
__device__ __forceinline__ void bias_relu(float (&acc)[N], const bf16* b,
                                          int c, int n) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float2 bias = bias_pair(b, c + 8 * i, n);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * i + 2 * h] = fmaxf(acc[4 * i + 2 * h] + bias.x, 0.f);
      acc[4 * i + 2 * h + 1] = fmaxf(acc[4 * i + 2 * h + 1] + bias.y, 0.f);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Branch2c's epilogue for a warpgroup's 64 rows, in two halves so that its
// loads run under the chunk's products: out_load, before them, reads the
// residual x and b2c of this thread's accumulator elements (thread (g, tq)
// holds columns c0 + 8 i + 2 tq, + 1 of rows g and g + 8) into registers,
// all loads together; out_store, after them, writes relu(acc + b2c + x) as
// bf16 at output rows o_row (~0: not stored), columns past C not stored.
template <int N>
struct OutTile {
  uint32_t res[N / 8][2], bias[N / 8];
};

template <int N>
__device__ __forceinline__ void out_load(const FbArgs& p, OutTile<N>& o,
                                         const size_t (&o_row)[2], int c0,
                                         int tq) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = c0 + 8 * i + 2 * tq;
    const bool c_ok = c < p.C;
    o.bias[i] = c_ok ? *reinterpret_cast<const uint32_t*>(p.b2c + c) : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      o.res[i][h] = c_ok && o_row[h] != ~(size_t)0
                        ? __ldg(reinterpret_cast<const unsigned int*>(
                              p.x + o_row[h] + c))
                        : 0u;
  }
}

template <int N>
__device__ __forceinline__ void out_store(const FbArgs& p,
                                          const OutTile<N>& o,
                                          const float (&acc)[N / 2],
                                          const size_t (&o_row)[2], int c0,
                                          int tq) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = c0 + 8 * i + 2 * tq;
    const float2 b2 = unpack2(o.bias[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (c >= p.C || o_row[h] == ~(size_t)0) continue;
      const float2 r2 = unpack2(o.res[i][h]);
      *reinterpret_cast<uint32_t*>(p.out + o_row[h] + c) = lfb::pack_bf16(
          fmaxf(acc[4 * i + 2 * h] + b2.x + r2.x, 0.f),
          fmaxf(acc[4 * i + 2 * h + 1] + b2.y + r2.y, 0.f));
    }
  }
}

// The ring of slots: the producer fills them in order, the consumers take
// them in the same order.
struct Ring {
  int slot, n;
  uint32_t phase;
  __device__ void next() {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

template <int kNW, bool kSplitN>
__global__ void __launch_bounds__(kFbThreads, 1)
fused_bottleneck_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                              const __grid_constant__ CUtensorMap tw2a,
                              const __grid_constant__ CUtensorMap tw2b,
                              const __grid_constant__ CUtensorMap tw2c,
                              const FbArgs p) {
  using F = Fb<kNW, kSplitN>;
  constexpr int PR = F::PR, NP = F::NP, N3 = F::N3, NW3 = F::NW3;
  constexpr int WR = F::WR, WR3 = F::WR3;
  const FbBand u = fb_band(p);
  if (u.j0 >= u.Hq) return;                 // a residue with fewer rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = lfb::smem_addr(base);
  const uint32_t sh1 = sbase + p.h1_off;
  const uint32_t sh2 = sbase + p.h2_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + p.h2_off +
                                               (kSplitN ? 64 * p.Cp * 2 : 0));
  uint64_t* empty = full + kMaxSlots;
  const int tid = threadIdx.x;
  // The warpgroup, warp-uniform as the compiler sees it (wgmma in a branch
  // it cannot prove uniform is serialised).
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < p.nslot; ++s) {
      lfb::mbar_init(&full[s], 1);          // the producer's thread 0
      lfb::mbar_init(&empty[s], 8);         // the consumer warps
    }
    lfb::mbar_init_fence();
  }
  __syncthreads();

  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int pt = p.kT / 2;
  const int tap_lo = max(0, pt - t);        // temporal taps inside [0, T)
  const int tap_hi = min(p.kT, p.Tn + pt - t);
  const int m1_passes = (u.M1 + PR - 1) / PR;
  const int m2_passes = (u.M2 + PR - 1) / PR;
  const int n_passes = p.Cp / NP;
  const size_t HW = (size_t)p.H * p.W;
  Ring ring{0, p.nslot, 0};

  if (wg == 2) {
    // ---- producer: x by TMA (cp.async where d > 1), weights by TMA ----
    lfb::reg_dealloc<56>();
    const int ptid = tid - 256;
    const int piece = ptid & 7;             // this thread's 16 bytes of a row
    auto take = [&]() {
      lfb::mbar_wait(&empty[ring.slot], ring.phase ^ 1);
      return sbase + ring.slot * kSlot;
    };
    // `rows` rows of a (K, N) weight matrix from row `row`, `panels`
    // 64-column panels from column `col`, into the next slot.
    auto weights = [&](const CUtensorMap* map, int panels, int rows, int col,
                       int row) {
      if (ptid == 0) {
        const uint32_t dst = take();
        lfb::mbar_arrive_expect_tx(&full[ring.slot], panels * rows * 128);
        for (int q = 0; q < panels; ++q)
          lfb::tma_load_3d(dst + q * rows * 128, map, &full[ring.slot],
                           col + 64 * q, row, 0);
      }
      ring.next();
    };
    // 1. branch2a: per pass of PR h1 rows, per temporal tap inside [0, T)
    // and 64 input channels, a slot of x (zeros past C and past the tensor;
    // rows past h1's are not stored) and the 64 rows of w2a.
    for (int mp = 0; mp < m1_passes; ++mp) {
      int off[PR / 16];                     // frame pixel of each row, or -1
#pragma unroll
      for (int q = 0; q < PR / 16; ++q) {
        const int m = mp * PR + (ptid >> 3) + 16 * q;
        off[q] = m < u.M1 ? fb_pixel(p, u, u.s_lo + m / u.Wq, m % u.Wq) : -1;
      }
      for (int np = 0; np < n_passes; ++np)
        for (int tap = tap_lo; tap < tap_hi; ++tap) {
          const int fin = b * p.Tn + t + tap - pt;
          const bf16* xf = p.x + (size_t)fin * HW * p.C;
          for (int c0 = 0; c0 < p.Cq; c0 += 64) {
            if (p.d == 1) {                 // h1's rows are contiguous in x
              if (ptid == 0) {
                const uint32_t sx = take();
                lfb::mbar_arrive_expect_tx(&full[ring.slot], PR * 128);
                lfb::tma_load_3d(sx, &tx, &full[ring.slot], c0,
                                 u.s_lo * p.W + mp * PR, fin);
              }
            } else {
              const uint32_t sx = take();
              const bool c_ok = c0 + 8 * piece < p.C;
#pragma unroll
              for (int q = 0; q < PR / 16; ++q) {
                const int r = (ptid >> 3) + 16 * q;
                const bool ok = c_ok && off[q] >= 0;
                const bf16* src =
                    ok ? xf + (size_t)off[q] * p.C + c0 + 8 * piece : p.x;
                asm volatile(
                    "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                        sx + r * 128 + ((piece ^ (r & 7)) << 4)),
                    "l"(src), "r"(ok ? 16 : 0));
              }
              // Every thread's copies hold the phase open; then thread 0
              // makes the barrier's one arrival.
              lfb::cp_async_arrive_inc(&full[ring.slot]);
              lfb::named_bar_sync(3, 128);
              if (ptid == 0) lfb::mbar_arrive(&full[ring.slot]);
            }
            ring.next();
            for (int k = 0; k < 64; k += WR)
              weights(&tw2a, NP / 64, WR, np * NP, tap * p.C + c0 + k);
          }
        }
    }
    // 2 and 3, per pass of PR output pixels: w2b chunks (9 taps x 64
    // channels), then w2c chunks (64 rows x N3 columns).
    for (int op = 0; op < m2_passes; ++op) {
      for (int np = 0; np < n_passes; ++np)
        for (int tap = 0; tap < 9; ++tap)
          for (int c0 = 0; c0 < p.Cp; c0 += 64)
            for (int k = 0; k < 64; k += WR)
              weights(&tw2b, NP / 64, WR, np * NP, tap * p.Ci + c0 + k);
      for (int n3 = 0; n3 < p.C; n3 += N3)
        for (int k0 = 0; k0 < p.Cp; k0 += WR3)
          weights(&tw2c, N3 / 64, WR3, n3, k0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // before exiting
    return;
  }

  // ---- consumers ----
  lfb::reg_alloc<224>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // This warpgroup's first pixel row of a pass, its first column of a
  // pass's N, and those columns' panel in a weight slot of `rows` rows.
  const int row0 = kSplitN ? 0 : 64 * wg;
  const int col0 = kSplitN ? 128 * wg : 0;
  auto bpan = [&](int rows) { return kSplitN ? 2 * wg * rows * 128 : 0; };
  auto next_full = [&]() {
    lfb::mbar_wait(&full[ring.slot], ring.phase);
    const uint32_t a = sbase + ring.slot * kSlot;
    ring.next();
    return a;
  };
  // Hand back the last n slots taken (their products have finished).
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) {
      int s = ring.slot;
      for (int i = 0; i < n; ++i) {
        s = s == 0 ? ring.n - 1 : s - 1;
        lfb::mbar_arrive(&empty[s]);
      }
    }
  };
  // The B descriptor of k16 step j of a 64-deep chunk whose weights sit in
  // the slots w[0 ..], `rows` rows each (MN-major, panels of 64 columns
  // `rows` * 128 bytes apart).  Formed by desc_add after the slots' waits,
  // so no register of a running product is rewritten.
  auto bdesc = [&](const uint32_t* w, int rows, int pan, int j) {
    const int e = j / (rows / 16), jj = j % (rows / 16);
    return lfb::desc_add(lfb::desc_sw128(w[e] + pan, rows * 128),
                         jj * (2048 >> 4));
  };
  float acc[kNW / 2];

  // 1. branch2a -> h1.
  for (int mp = 0; mp < m1_passes; ++mp)
    for (int np = 0; np < n_passes; ++np) {
      zero(acc);
      for (int tap = tap_lo; tap < tap_hi; ++tap)
        for (int c0 = 0; c0 < p.Cq; c0 += 64) {
          const uint32_t sx = next_full();
          uint32_t w[64 / WR];
#pragma unroll
          for (int e = 0; e < 64 / WR; ++e) w[e] = next_full();
          if (p.d != 1) lfb::fence_proxy_async();   // x came by cp.async
          const uint64_t da =
              lfb::desc_add(lfb::desc_sw128(sx + row0 * 128, 16), 0);
          lfb::wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            lfb::Wgmma<kNW>::template ss_t<1>(acc, da + 2 * j,
                                              bdesc(w, WR, bpan(WR), j));
          lfb::wgmma_commit();
          lfb::wgmma_wait<0>();
          release(1 + 64 / WR);
        }
      lfb::fence_operand(acc);
      // + b2a, relu, bf16 -> h1 (rows past M1 are not stored).
      bias_relu(acc, p.b2a, np * NP + col0 + 2 * tq, p.Ci);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mp * PR + row0 + 16 * warp + g + 8 * h;
        if (m >= u.M1) continue;
#pragma unroll
        for (int i = 0; i < kNW / 8; ++i)
          *reinterpret_cast<uint32_t*>(
              base + p.h1_off +
              h1_byte(m, np * NP + col0 + 8 * i + 2 * tq, p.Cp)) =
              lfb::pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  lfb::named_bar_sync(1, 256);              // h1 complete

  // 2 and 3, per pass of output pixels.
  const int hoff = (u.j0 - u.s_lo) * u.Wq;  // h1 row of the band's pixel 0
  // The taps (dh, dw) at which output pixel m reads a pixel of h1 (not
  // branch2b's zero padding); none past the band.
  auto taps_ok = [&](int m) {
    if (m >= u.M2) return 0;
    const int i = u.j0 + m / u.Wq, j = m % u.Wq;
    int ok = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ii = i + tap / 3 - 1, jj = j + tap % 3 - 1;
      if (ii >= 0 && ii < u.Hq && jj >= 0 && jj < u.Wq) ok |= 1 << tap;
    }
    return ok;
  };
  for (int op = 0; op < m2_passes; ++op) {
    // This lane's ldmatrix row (its h1 row at tap (0, 0), and the taps at
    // which it reads a pixel) and the two rows of its fragments.
    const int mw = op * PR + row0 + 16 * warp;
    const int ml = mw + (lane & 15);
    const int lrow = ml < u.M2 ? ml + hoff : 0;
    const int lane_ok = taps_ok(ml);
    const int frag_ok0 = taps_ok(mw + g), frag_ok1 = taps_ok(mw + g + 8);
    const uint32_t khalf = lane >> 4;

    if constexpr (kSplitN)
      lfb::named_bar_sync(2, 256);          // the last pass's h2 is read
    uint32_t h2a[kSplitN ? 1 : kNW / 16][4];
    for (int np = 0; np < n_passes; ++np) {
      zero(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int row = ((lane_ok >> tap) & 1)
                            ? lrow + (tap / 3 - 1) * u.Wq + tap % 3 - 1
                            : lrow;
        const uint32_t arow = sh1 + (uint32_t)row * p.Cp * 2;
        const bool fo0 = (frag_ok0 >> tap) & 1, fo1 = (frag_ok1 >> tap) & 1;
        for (int c0 = 0; c0 < p.Cp; c0 += 64) {
          uint32_t w[64 / WR];
#pragma unroll
          for (int e = 0; e < 64 / WR; ++e) w[e] = next_full();
          uint32_t a[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t lc = (c0 >> 3) + 2 * j + khalf;
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
                "[%4];\n"
                : "=r"(a[j][0]), "=r"(a[j][1]), "=r"(a[j][2]), "=r"(a[j][3])
                : "r"(arow + (((lc & ~7u) | ((lc ^ row) & 7)) << 4)));
            // branch2b's zero padding where the tap leaves the image.
            a[j][0] = fo0 ? a[j][0] : 0u;
            a[j][2] = fo0 ? a[j][2] : 0u;
            a[j][1] = fo1 ? a[j][1] : 0u;
            a[j][3] = fo1 ? a[j][3] : 0u;
          }
          lfb::wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            lfb::Wgmma<kNW>::template rs_t<1>(acc, a[j],
                                              bdesc(w, WR, bpan(WR), j));
          lfb::wgmma_commit();
          lfb::wgmma_wait<0>();
          release(64 / WR);
        }
      }
      lfb::fence_operand(acc);
      // + b2b, relu: h2, rounded to bf16 as it is stored or packed.
      bias_relu(acc, p.b2b, np * NP + col0 + 2 * tq, p.Ci);
      if constexpr (kSplitN) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g + 8 * h;
#pragma unroll
          for (int i = 0; i < kNW / 8; ++i)
            *reinterpret_cast<uint32_t*>(
                base + p.h2_off + h2_byte(r, np * NP + col0 + 8 * i + 2 * tq)) =
                lfb::pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < kNW / 16; ++kc) lfb::acc_to_a(h2a[kc], acc, kc);
      }
    }
    if constexpr (kSplitN) {
      lfb::fence_proxy_async();             // h2 is read by wgmma
      lfb::named_bar_sync(1, 256);
    }

    // 3. branch2c + b2c + x, relu -> out, N3 columns a chunk.
    size_t o_row[2];                        // this thread's output rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mw + g + 8 * h;
      o_row[h] = m < u.M2 ? (((size_t)b * p.Tn + t) * HW +
                             fb_pixel(p, u, u.j0 + m / u.Wq, m % u.Wq)) *
                                p.C
                          : ~(size_t)0;
    }
    float acc3[NW3 / 2];
    for (int n3 = 0; n3 < p.C; n3 += N3) {
      OutTile<NW3> ot;
      out_load<NW3>(p, ot, o_row, n3 + col0, tq);
      zero(acc3);
      if constexpr (kSplitN) {
        for (int k0 = 0; k0 < p.Cp; k0 += 64) {
          uint32_t w[64 / WR3];
#pragma unroll
          for (int e = 0; e < 64 / WR3; ++e) w[e] = next_full();
          const uint64_t da = lfb::desc_add(
              lfb::desc_sw128(sh2 + (k0 >> 6) * 8192, 16), 0);
          lfb::wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            lfb::Wgmma<NW3>::template ss_t<1>(acc3, da + 2 * j,
                                              bdesc(w, WR3, bpan(WR3), j));
          lfb::wgmma_commit();
          lfb::wgmma_wait<0>();
          release(64 / WR3);
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < kNW / 64; ++kc) {
          uint32_t w[64 / WR3];
#pragma unroll
          for (int e = 0; e < 64 / WR3; ++e) w[e] = next_full();
          lfb::wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            lfb::Wgmma<NW3>::template rs_t<1>(acc3, h2a[4 * kc + j],
                                              bdesc(w, WR3, 0, j));
          lfb::wgmma_commit();
          lfb::wgmma_wait<0>();
          release(64 / WR3);
        }
      }
      lfb::fence_operand(acc3);
      out_store<NW3>(p, ot, acc3, o_row, n3 + col0, tq);
    }
  }
}

template <int kNW, bool kSplitN>
cudaError_t launch_wgmma(const void* x, const void* w2a, const void* b2a,
                         const void* w2b, const void* b2b, const void* w2c,
                         const void* b2c, void* out, int B, int Tn, int H,
                         int W, int C, int Ci, int kT, int d, int max_smem,
                         int sms, cudaStream_t stream) {
  using F = Fb<kNW, kSplitN>;
  FbArgs a;
  a.x = static_cast<const bf16*>(x);
  a.b2a = static_cast<const bf16*>(b2a);
  a.b2b = static_cast<const bf16*>(b2b);
  a.b2c = static_cast<const bf16*>(b2c);
  a.out = static_cast<bf16*>(out);
  a.Tn = Tn;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Ci = Ci;
  a.Cp = kSplitN ? (Ci + 255) / 256 * 256 : kNW;
  a.Cq = (C + 63) / 64 * 64;
  a.kT = kT;
  a.d = d;
  // The band height (rows of a residue's sub-image): of those whose h1
  // (band + 2 rows), h2 and at least 4 ring slots fit, the least (pixel
  // rows padded to passes of PR) x (products a row) x (waves of CTAs over
  // the SMs) x max(1, 6 / slots) (a ring of fewer slots hides less of the
  // loads' latency).
  const int Hq = (H + d - 1) / d, Wq = (W + d - 1) / d;
  const size_t h2_bytes = kSplitN ? (size_t)64 * a.Cp * 2 : 0;
  const double k1 = (double)kT * a.Cq * a.Cp;
  const double k23 =
      9.0 * a.Cp * a.Cp + (double)a.Cp * ((C + F::N3 - 1) / F::N3 * F::N3);
  double best = 0;
  a.R = 0;
  size_t h1_bytes = 0;
  for (int bands = 1; bands <= Hq; ++bands) {
    const int r = (Hq + bands - 1) / bands;
    if ((Hq + r - 1) / r != bands) continue;   // one height per band count
    const long long m1 = (long long)std::min(Hq, r + 2) * Wq;
    const long long m2 = (long long)r * Wq;
    const size_t h1 = ((size_t)m1 * a.Cp * 2 + 1023) & ~(size_t)1023;
    const size_t fixed = 1024 + h1 + h2_bytes + kBarBytes;
    if (fixed + 4 * (size_t)kSlot > (size_t)max_smem) continue;
    const int slots =
        (int)std::min<size_t>(kMaxSlots, (max_smem - fixed) / kSlot);
    const long long ctas = (long long)d * d * bands * Tn * B;
    const double cost = (double)((ctas + sms - 1) / sms) *
                        ((double)((m1 + F::PR - 1) / F::PR) * k1 +
                         (double)((m2 + F::PR - 1) / F::PR) * k23) *
                        std::max(1.0, 6.0 / slots);
    if (a.R == 0 || cost < best) {
      a.R = r;
      a.bands = bands;
      a.nslot = slots;
      h1_bytes = h1;
      best = cost;
    }
  }
  if (a.R == 0 || (long long)d * d * a.bands > INT_MAX)
    return cudaErrorInvalidValue;
  a.h1_off = a.nslot * kSlot;
  a.h2_off = a.h1_off + (int)h1_bytes;
  const size_t smem = 1024 + (size_t)a.h2_off + h2_bytes + kBarBytes;
  CUtensorMap tx, tw2a, tw2b, tw2c;
  cudaError_t err = lfb::tma_map_bf16(&tx, x, B * Tn, H * W, C, F::PR);
  if (err == cudaSuccess)
    err = lfb::tma_map_bf16(&tw2a, w2a, 1, kT * C, Ci, F::WR);
  if (err == cudaSuccess)
    err = lfb::tma_map_bf16(&tw2b, w2b, 1, 9 * Ci, Ci, F::WR);
  if (err == cudaSuccess)
    err = lfb::tma_map_bf16(&tw2c, w2c, 1, Ci, C, F::WR3);
  if (err == cudaSuccess)
    err = lfb::allow_smem(fused_bottleneck_wgmma_kernel<kNW, kSplitN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(d * d * a.bands, Tn, B);
  fused_bottleneck_wgmma_kernel<kNW, kSplitN>
      <<<grid, kFbThreads, smem, stream>>>(tx, tw2a, tw2b, tw2c, a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* w2a, const void* b2a,
                        const void* w2b, const void* b2b, const void* w2c,
                        const void* b2c, void* out, int B, int Tn, int H,
                        int W, int C, int Ci, int kT, int d,
                        cudaStream_t stream) {
  int max_smem = 0, sms = 0;
  cudaError_t err = check_shape(B, Tn, H, W, C, Ci, kT, d, &max_smem, &sms);
  if (err != cudaSuccess) return err;
  // x and the weights are read by TMA (and x by 16-byte cp.async), the
  // biases as bf16 pairs.
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w2a) |
       reinterpret_cast<uintptr_t>(w2b) | reinterpret_cast<uintptr_t>(w2c)) &
          15 ||
      (reinterpret_cast<uintptr_t>(b2a) | reinterpret_cast<uintptr_t>(b2b) |
       reinterpret_cast<uintptr_t>(b2c) | reinterpret_cast<uintptr_t>(out)) &
          3)
    return cudaErrorMisalignedAddress;
  if ((long long)B * Tn > INT_MAX || (long long)H * W > INT_MAX)
    return cudaErrorInvalidValue;
  auto args = [&](auto launcher) {
    return launcher(x, w2a, b2a, w2b, b2b, w2c, b2c, out, B, Tn, H, W, C, Ci,
                    kT, d, max_smem, sms, stream);
  };
  if (Ci <= 64) return args(launch_wgmma<64, false>);
  if (Ci <= 128) return args(launch_wgmma<128, false>);
  if (Ci <= 256) return args(launch_wgmma<256, false>);
  return args(launch_wgmma<128, true>);
}

}  // namespace

// x, out (B, T, H, W, C); w2a (kT, C, Ci), w2b (9, Ci, Ci) with taps
// row-major in (dh, dw), w2c (Ci, C), biases (Ci), (Ci), (C): all in the
// input type, affine scales folded in.  Temporal padding kT / 2, spatial
// padding and dilation d.  C and Ci multiples of 16 (checked here and by the
// Python wrapper).
LFB_EXPORT int lfb_fused_bottleneck_f32(const void* x, const void* w2a,
                                        const void* b2a, const void* w2b,
                                        const void* b2b, const void* w2c,
                                        const void* b2c, void* out, int B,
                                        int T, int H, int W, int C, int Ci,
                                        int kT, int d, void* stream) {
  return launch<float>(x, w2a, b2a, w2b, b2b, w2c, b2c, out, B, T, H, W, C,
                       Ci, kT, d, static_cast<cudaStream_t>(stream));
}

LFB_EXPORT int lfb_fused_bottleneck_bf16(const void* x, const void* w2a,
                                         const void* b2a, const void* w2b,
                                         const void* b2b, const void* w2c,
                                         const void* b2c, void* out, int B,
                                         int T, int H, int W, int C, int Ci,
                                         int kT, int d, void* stream) {
  return launch_bf16(x, w2a, b2a, w2b, b2b, w2c, b2c, out, B, T, H, W, C, Ci,
                     kT, d, static_cast<cudaStream_t>(stream));
}
