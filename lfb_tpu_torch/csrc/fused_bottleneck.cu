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
// not fit a 227 KB block and is not carried over.  Both instantiations run
// one CTA per (clip, frame, band of output rows):
//   1. branch2a for the band and its halo rows that lie in the image -> h1
//      in shared memory (input type).  Temporal taps outside [0, T) are
//      skipped (their product is the conv's temporal zero padding).
//   2. branch2b as 9 shifted taps over h1; rows and columns outside the
//      image read 0 (branch2b's spatial zero padding, not relu(b2a)).
//   3. branch2c, + b2c, + x, relu, one write.
//
// bf16 (fused_bottleneck_mma_kernel): the three stages are GEMMs on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).  A band is R rows of one
// residue mod d (rows p, p + d, ...): a tap of dilation d then moves one
// band row, so h1 needs one halo row on each side whatever d (res5 at d = 2
// needs 6 rows of h1 for 4 output rows, not 8).  16 warps in two groups of
// 8; each warp owns a 32 x 32 tile (2 x 4 MMA tiles) of a 64 x 128 CTA tile
// (128 x 64 when Ci <= 64).  The weights stay in the wrapper's (K, N)
// row-major layout and stream in 64-deep k chunks through a 3-stage
// cp.async ring; B fragments come through ldmatrix.trans (k along rows, as
// V in P V).  In stages 1 and 2 the two groups split each chunk's k16 steps
// and group 1 hands its sums to group 0 through the ring at the end of the
// tile (a fixed order: no atomics, the same bits every run).  A operands:
//   * stage 1: x rows of the band, 64 channels of one temporal tap per
//     chunk, streamed by cp.async beside the weights (into the h2 buffer,
//     free until stage 2).  h1 holds only rows inside the image.
//   * stage 2: h1 through ldmatrix with a row address per lane: the pixel
//     shifted by (dh d, dw d), or a zero row in shared memory where the
//     shift leaves the image.
//   * stage 3: h2.  K = Ci is short here, so the groups take the two halves
//     of a 64 x 256 tile instead, and all n-tiles' 32-deep chunks run
//     through the ring as one stream, so the next n-tile's loads overlap
//     this one's epilogue (with the split-K exchange and a cold ring at
//     every tile, stage 3 was the slowest stage per FLOP at res2-res4).
// Stages 2 and 3 run per 64-pixel tile: branch2b writes the tile's h2 (all
// Ci channels) and branch2c reads it, so h2 is one tile and the rest of
// shared memory goes to h1, i.e. to taller bands.  Each epilogue works on
// the C fragments: + bias, relu, bf16 pairs into h1 / h2, or + bias +
// residual, relu, one bf16 pair store.  Rows of h1, h2 and the ring are
// padded by 8 bf16 (conflict-free ldmatrix).  R is chosen at launch: of the
// band heights whose buffers fit the block's shared memory, the one with
// the least MMA work (tiles padded to the CTA tile, halo recompute counted)
// times the waves of CTAs over the SMs: at crop 256, whole frames at res4,
// 8 rows at res2 and res3, 4 at res5.
//
// What bounds it: instruction issue as much as the tensor cores.  A chunk
// gives each warp only 16 MMAs between two barriers, so the chunk loops do
// no division: each thread's cp.async offsets are fixed per tile
// (ChunkCopy) and the tap / channel counters step.  With the divisions of
// a generic tile loader and per-chunk address arithmetic in them (600+
// instructions per 16 MMAs in the SASS), the 29 launches of a forward took
// 1.5x as long (PERF.md, PR 5).  8 warps of 64 x 32 tiles, 32-deep
// chunks, 4-row bands with two CTAs an SM and a 16-warp layout without
// split-K were all slower on the H100 than this layout.
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
#include "common.cuh"
#include "mma_bf16.cuh"

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

// ---- bf16: tensor cores ----------------------------------------------------

using lfb::bf16;

constexpr int kMmaThreads = 512;   // 2 groups of 8 warps, each a 32 x 32 tile
constexpr int kGroups = 2;
constexpr int kMmaKC = 64;         // reduction depth of one ring stage
constexpr int kStages = 3;
constexpr int kALd = kMmaKC + 8;   // row stride of a staged x chunk
constexpr int kRedFloats = 8 * 32 * 32;   // one group's accumulators

// WM warps of a group along the pixels, 8 / WM along the channels.
template <int WM>
struct MmaTile {
  static constexpr int TM = 32 * WM;        // pixels
  static constexpr int TN = 32 * (8 / WM);  // channels
  static constexpr int BLd = TN + 8;        // row stride of a weight chunk
  // The weight ring, which also holds the split-K exchange.
  static constexpr int RING = kStages * kMmaKC * BLd > 2 * kRedFloats
                                  ? kStages * kMmaKC * BLd
                                  : 2 * kRedFloats;
};

// Shared memory (bf16 elements) for h1_rows rows of h1: the weight ring,
// the zero row, h1 and the h2 tile (which holds the x ring during stage 1).
template <int WM>
size_t mma_smem_elems(int h1_rows, int W, int Ci) {
  using Tl = MmaTile<WM>;
  const size_t pitch = Ci + 8;
  const size_t h2 = pitch > (size_t)kStages * kALd ? pitch : kStages * kALd;
  return (size_t)Tl::RING + pitch + (size_t)h1_rows * W * pitch + Tl::TM * h2;
}

// One thread's share of the cp.async copies of a chunk: a rows x cols
// (cols a multiple of 8) piece of a row-major matrix with row stride ld_g
// into a tile with row stride ld_s, as at most kCopies 16-byte copies at
// offsets fixed for the whole tile, so the chunk loop does no division.
struct ChunkCopy {
  static constexpr int kCopies = 2;   // rows * cols / 8 <= 2 * kMmaThreads
  int s_off[kCopies], g_off[kCopies], row[kCopies];

  __device__ void init(int rows, int cols, int ld_s, int ld_g) {
    const int cpr = cols >> 3;
#pragma unroll
    for (int q = 0; q < kCopies; ++q) {
      const int e = threadIdx.x + q * kMmaThreads;
      const int r = e / cpr;
      row[q] = r < rows ? r : 1 << 30;
      s_off[q] = r * ld_s + (e - r * cpr) * 8;
      g_off[q] = r * ld_g + (e - r * cpr) * 8;
    }
  }

  // The rows below `valid`, from src (the piece's first element) to dst.
  __device__ void issue(bf16* dst, const bf16* src, int valid) const {
#pragma unroll
    for (int q = 0; q < kCopies; ++q)
      if (row[q] < valid) lfb::cp_async_16(dst + s_off[q], src + g_off[q], true);
  }
};

__device__ __forceinline__ int wrap_stage(int s) {
  return s + 1 == kStages ? 0 : s + 1;
}

// acc = A (TM x K) . B (K x TN) over n chunks of up to kMmaKC.  issue(s)
// issues the next chunk's cp.async copies (chunks in order) into ring
// stage s (the weights at ring + s * kMmaKC * BLd); for the chunk being
// computed, klen() is its depth (a multiple of 16), afrag(s, mt) this
// lane's ldmatrix address of the A fragment of m-tile mt at its depth 0,
// and next() moves on to the following chunk.  Group g takes the k16 steps
// 2 j + g of each chunk; at the end group 1 hands its sums to group 0
// through the ring, so only group 0's acc holds the tile (in a fixed
// order: the result does not change from run to run).  Ends with the ring
// free.
template <int WM, typename Issue, typename KLen, typename AFrag, typename Next>
__device__ __forceinline__ void gemm_tile(float (&acc)[2][4][4], int n,
                                          Issue& issue, const KLen& klen,
                                          const AFrag& afrag, Next& next,
                                          bf16* ring, int lane, int warp) {
  using Tl = MmaTile<WM>;
  const int group = warp >> 3;
  // This lane's B fragment rows and columns (lfb::bt_frag at depth 0).
  const bf16* b_lane =
      lfb::bt_frag(ring, Tl::BLd, 0, (warp & 7) / WM * 32, lane);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  int s_ld = 0;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < n) issue(s_ld);
    lfb::cp_async_commit();
    s_ld = wrap_stage(s_ld);
  }
  int s = 0;
  for (int i = 0; i < n; ++i) {
    lfb::cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk i landed; every warp is done with chunk i - 1
    if (i + kStages - 1 < n) issue(s_ld);
    lfb::cp_async_commit();
    s_ld = wrap_stage(s_ld);
    const bf16* sB = b_lane + s * kMmaKC * Tl::BLd;
    const int kl = klen();
    const bf16* a0 = afrag(s, 0);
    const bf16* a1 = afrag(s, 1);
#pragma unroll
    for (int step = 0; step < kMmaKC / (16 * kGroups); ++step) {
      const int kk = 16 * kGroups * step + 16 * group;
      if (kk < kl) {
        uint32_t a[2][4];
        lfb::ldsm_x4(a[0], a0 + kk);
        lfb::ldsm_x4(a[1], a1 + kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          lfb::ldsm_x4_trans(bb, sB + kk * Tl::BLd + np * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            lfb::mma_16816(acc[mt][2 * np], a[mt], bb[0], bb[1]);
            lfb::mma_16816(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }
    next();
    s = wrap_stage(s);
  }
  lfb::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring) + (warp & 7) * 32 * 32 + lane;
  if (group == 1) {
#pragma unroll
    for (int e = 0; e < 32; ++e) red[e * 32] = acc[e >> 4][(e >> 2) & 3][e & 3];
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e >> 4][(e >> 2) & 3][e & 3] += red[e * 32];
  }
  __syncthreads();
}

// f(row, col, v0, v1) for each accumulator pair of a group-0 warp: row and
// (even) col in the CTA tile.
template <int WM, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[2][4][4],
                                              int lane, int warp, const F& f) {
  if (warp >= 8) return;
  const int wm = warp % WM;
  const int wn = warp / WM;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(wm * 32 + mt * 16 + (lane >> 2) + 8 * h,
          wn * 32 + nt * 8 + (lane & 3) * 2, acc[mt][nt][2 * h],
          acc[mt][nt][2 * h + 1]);
}

__device__ __forceinline__ float2 bf16_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_relu(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
}

// A band is R sub-rows of one residue p mod d: image rows p + d j for
// j0 <= j < j0 + R.  A 3 x 3 tap of dilation d moves j by one, so h1 needs
// one sub-row of halo on each side, whatever d.
template <int WM>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_bottleneck_mma_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ w2a,
                            const bf16* __restrict__ b2a,
                            const bf16* __restrict__ w2b,
                            const bf16* __restrict__ b2b,
                            const bf16* __restrict__ w2c,
                            const bf16* __restrict__ b2c,
                            bf16* __restrict__ out, int Tn, int H, int W,
                            int C, int Ci, int kT, int d, int R) {
  using Tl = MmaTile<WM>;
  constexpr int TM = Tl::TM;
  constexpr int TN = Tl::TN;
  constexpr int kKC3 = kMmaKC / kGroups;    // stage 3: 32-deep chunks
  constexpr int TN3 = kGroups * TN;         // of 2 TN weight columns
  constexpr int kBLd3 = TN3 + 8;
  static_assert(kStages * kKC3 * kBLd3 <= Tl::RING, "stage 3 ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bands = ((H + d - 1) / d + R - 1) / R;   // per residue
  const int p = blockIdx.x / bands;
  const int Hp = (H - p + d - 1) / d;       // rows of residue p
  const int j0 = (blockIdx.x - p * bands) * R;
  if (j0 >= Hp) return;                     // uniform over the CTA
  const int rows = min(R, Hp - j0);
  const int s_lo = max(0, j0 - 1);          // h1 holds sub-rows s_lo..s_hi-1
  const int s_hi = min(Hp, j0 + rows + 1);
  const int M1 = (s_hi - s_lo) * W;
  const int M2 = rows * W;
  const int pitch = Ci + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* zero = ring + Tl::RING;
  bf16* h1 = zero + pitch;
  bf16* h2 = h1 + (size_t)M1 * pitch;       // TM rows; the x ring in stage 1
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 7) % WM;
  const int pt = kT / 2;
  const size_t frame = (size_t)H * W * C;
  for (int i = threadIdx.x; i < pitch; i += kMmaThreads)
    zero[i] = __float2bfloat16(0.f);
  float acc[2][4][4];
  ChunkCopy wcopy;

  // 1. branch2a over h1's rows: chunks of 64 channels of one temporal tap.
  const int tap_lo = max(0, pt - t);
  const int n1 = (min(kT, Tn + pt - t) - tap_lo) * ((C + kMmaKC - 1) / kMmaKC);
  const bf16* xb = x + (size_t)b * Tn * frame;
  // This lane's A row in the x ring, at depth 0.
  const int a_x = (wm * 32 + (lane & 15)) * kALd + (lane >> 4) * 8;
  for (int m0 = 0; m0 < M1; m0 += TM) {
    // This thread's 16-byte pieces of an x chunk: tile row e / 8, pixel
    // offsets fixed for the tile; rows past M1 read as 0.
    int x_off[ChunkCopy::kCopies], x_s[ChunkCopy::kCopies];
    bool x_ok[ChunkCopy::kCopies];
#pragma unroll
    for (int q = 0; q < ChunkCopy::kCopies; ++q) {
      const int e = threadIdx.x + q * kMmaThreads;
      const int m = m0 + (e >> 3);
      x_ok[q] = e < TM * 8 && m < M1;
      x_off[q] = x_ok[q] ? ((p + d * (s_lo + m / W)) * W + m % W) * C +
                               (e & 7) * 8
                         : 0;
      x_s[q] = (e >> 3) * kALd + (e & 7) * 8;
    }
    for (int n0 = 0; n0 < Ci; n0 += TN) {
      wcopy.init(kMmaKC, min(TN, Ci - n0), Tl::BLd, Ci);
      int ld_tap = tap_lo, ld_c0 = 0, cp_c0 = 0;
      auto issue = [&](int s) {
        const bf16* xf = xb + (size_t)(t + ld_tap - pt) * frame + ld_c0;
        bf16* dst = h2 + s * TM * kALd;
#pragma unroll
        for (int q = 0; q < ChunkCopy::kCopies; ++q)
          if (threadIdx.x + q * kMmaThreads < TM * 8)
            lfb::cp_async_16(dst + x_s[q], xf + x_off[q], x_ok[q]);
        wcopy.issue(ring + s * kMmaKC * Tl::BLd,
                    w2a + (size_t)(ld_tap * C + ld_c0) * Ci + n0,
                    min(kMmaKC, C - ld_c0));
        ld_c0 += kMmaKC;
        if (ld_c0 >= C) {
          ld_c0 = 0;
          ++ld_tap;
        }
      };
      auto next = [&]() {
        cp_c0 += kMmaKC;
        if (cp_c0 >= C) cp_c0 = 0;
      };
      gemm_tile<WM>(
          acc, n1, issue, [&]() { return min(kMmaKC, C - cp_c0); },
          [&](int s, int mt) { return h2 + s * TM * kALd + a_x + mt * 16 * kALd; },
          next, ring, lane, warp);
      for_each_pair<WM>(acc, lane, warp, [&](int r, int c, float v0, float v1) {
        const int m = m0 + r;
        const int n = n0 + c;
        if (m < M1 && n < Ci) {
          const float2 bias = bf16_pair(b2a + n);
          store_relu(h1 + (size_t)m * pitch + n, v0 + bias.x, v1 + bias.y);
        }
      });
    }
  }

  // 2 and 3, per tile of TM band pixels.
  const int wn3 = warp / WM;                // stage 3: 32 of the TN3 columns
  for (int m0 = 0; m0 < M2; m0 += TM) {
    // The sub-row and column of this lane's A row in each m-tile (far
    // outside the image past the band).
    int pj[2], pc[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = m0 + wm * 32 + mt * 16 + (lane & 15);
      pj[mt] = m < M2 ? j0 + m / W : -(1 << 20);
      pc[mt] = m % W;
    }
    // branch2b: 9 taps x chunks of 64 channels -> h2 (TM x Ci).
    for (int n0 = 0; n0 < Ci; n0 += TN) {
      wcopy.init(kMmaKC, min(TN, Ci - n0), Tl::BLd, Ci);
      int ld_k0 = 0, ld_c0 = 0, cp_c0 = 0, dh = -1, dw = -1;
      const bf16* rowp[2];
      auto tap_rows = [&]() {   // this lane's h1 rows of tap (dh, dw)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int jj = pj[mt] + dh;
          const int cc = pc[mt] + dw * d;
          rowp[mt] = (jj >= 0 && jj < Hp && cc >= 0 && cc < W)
                         ? h1 + ((jj - s_lo) * W + cc) * pitch
                         : zero;
        }
      };
      tap_rows();
      auto issue = [&](int s) {
        wcopy.issue(ring + s * kMmaKC * Tl::BLd, w2b + (size_t)ld_k0 * Ci + n0,
                    min(kMmaKC, Ci - ld_c0));
        ld_k0 += kMmaKC;
        ld_c0 += kMmaKC;
        if (ld_c0 >= Ci) {   // the next tap's rows start at a multiple of Ci
          ld_k0 += Ci - ld_c0;
          ld_c0 = 0;
        }
      };
      auto next = [&]() {
        cp_c0 += kMmaKC;
        if (cp_c0 >= Ci) {
          cp_c0 = 0;
          if (++dw == 2) {
            dw = -1;
            ++dh;
          }
          tap_rows();
        }
      };
      gemm_tile<WM>(
          acc, 9 * ((Ci + kMmaKC - 1) / kMmaKC), issue,
          [&]() { return min(kMmaKC, Ci - cp_c0); },
          [&](int, int mt) { return rowp[mt] + cp_c0 + (lane >> 4) * 8; },
          next, ring, lane, warp);
      for_each_pair<WM>(acc, lane, warp, [&](int r, int c, float v0, float v1) {
        const int n = n0 + c;
        if (n < Ci) {
          const float2 bias = bf16_pair(b2b + n);
          store_relu(h2 + (size_t)r * pitch + n, v0 + bias.x, v1 + bias.y);
        }
      });
    }
    // branch2c + b2c + x, relu -> out.  K = Ci is short, so the two groups
    // take the two halves of a TM x 2 TN tile instead of splitting K, and
    // the n-tiles' 32-deep chunks run through the ring as one stream: the
    // loads of the next n-tile overlap this one's epilogue.
    size_t o_row[2][2];   // this thread's output rows (SIZE_MAX past M2)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + (lane >> 2) + 8 * h;
        o_row[mt][h] =
            m < M2 ? ((((size_t)b * Tn + t) * H + p + d * (j0 + m / W)) * W +
                      m % W) * C
                   : ~(size_t)0;
      }
    const int cpi3 = (Ci + kKC3 - 1) / kKC3;
    const int total = (C + TN3 - 1) / TN3 * cpi3;
    int ld_n0 = 0, ld_c0 = 0, s_ld = 0;
    wcopy.init(kKC3, min(TN3, C), kBLd3, C);
    auto issue3 = [&]() {
      wcopy.issue(ring + s_ld * kKC3 * kBLd3, w2c + (size_t)ld_c0 * C + ld_n0,
                  min(kKC3, Ci - ld_c0));
      s_ld = wrap_stage(s_ld);
      ld_c0 += kKC3;
      if (ld_c0 >= Ci) {
        ld_c0 = 0;
        ld_n0 += TN3;
        if (ld_n0 < C) wcopy.init(kKC3, min(TN3, C - ld_n0), kBLd3, C);
      }
    };
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < total) issue3();
      lfb::cp_async_commit();
    }
    const bf16* a3 = h2 + (wm * 32 + (lane & 15)) * pitch + (lane >> 4) * 8;
    const bf16* b3 = lfb::bt_frag(ring, kBLd3, 0, wn3 * 32, lane);
    int s = 0, n0 = 0, c0 = 0;
    for (int i = 0; i < total; ++i) {
      lfb::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (i + kStages - 1 < total) issue3();
      lfb::cp_async_commit();
      if (c0 == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
      }
      const bf16* sB = b3 + s * kKC3 * kBLd3;
#pragma unroll
      for (int kk = 0; kk < kKC3; kk += 16) {
        if (c0 + kk < Ci) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            lfb::ldsm_x4(a[mt], a3 + mt * 16 * pitch + c0 + kk);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            lfb::ldsm_x4_trans(bb, sB + kk * kBLd3 + np * 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              lfb::mma_16816(acc[mt][2 * np], a[mt], bb[0], bb[1]);
              lfb::mma_16816(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
            }
          }
        }
      }
      s = wrap_stage(s);
      c0 += kKC3;
      if (c0 >= Ci) {   // the n-tile is done: its epilogue
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = n0 + wn3 * 32 + n * 8 + (lane & 3) * 2;
          if (c >= C) continue;
          const float2 bias = bf16_pair(b2c + c);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (o_row[mt][h] == ~(size_t)0) continue;
              const size_t o = o_row[mt][h] + c;
              const float2 res = bf16_pair(x + o);
              store_relu(out + o, acc[mt][n][2 * h] + bias.x + res.x,
                         acc[mt][n][2 * h + 1] + bias.y + res.y);
            }
        }
        c0 = 0;
        n0 += TN3;
      }
    }
    lfb::cp_async_wait<0>();
    __syncthreads();
  }
}

template <int WM>
cudaError_t launch_mma(const bf16* x, const bf16* w2a, const bf16* b2a,
                       const bf16* w2b, const bf16* b2b, const bf16* w2c,
                       const bf16* b2c, bf16* out, int B, int Tn, int H, int W,
                       int C, int Ci, int kT, int d, int max_smem, int sms,
                       cudaStream_t stream) {
  using Tl = MmaTile<WM>;
  // The band height (in sub-rows): of those whose buffers fit, the least
  // (MMA tiles of the tallest band, padded to the CTA tile) x (waves of
  // CTAs over the SMs).
  auto tiles = [](int n, int t) { return (double)((n + t - 1) / t) * t; };
  const double k1 = (double)kT * C * tiles(Ci, Tl::TN);
  const double k23 = 9.0 * Ci * tiles(Ci, Tl::TN) + (double)Ci * tiles(C, Tl::TN);
  const int Hs = (H + d - 1) / d;           // sub-rows of residue 0
  int R = 0;
  double best = 0;
  for (int bands = 1; bands <= Hs; ++bands) {
    const int r = (Hs + bands - 1) / bands;
    if ((Hs + r - 1) / r != bands) continue;    // one height per band count
    const int h1_rows = min(Hs, r + 2);
    if (mma_smem_elems<WM>(h1_rows, W, Ci) * sizeof(bf16) > (size_t)max_smem)
      continue;
    const long long ctas = (long long)d * bands * Tn * B;
    const double cost = (double)((ctas + sms - 1) / sms) *
                        (tiles(h1_rows * W, Tl::TM) * k1 +
                         tiles(r * W, Tl::TM) * k23);
    if (R == 0 || cost < best) {
      R = r;
      best = cost;
    }
  }
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = mma_smem_elems<WM>(min(Hs, R + 2), W, Ci) * sizeof(bf16);
  cudaError_t err = lfb::allow_smem(fused_bottleneck_mma_kernel<WM>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(d * ((Hs + R - 1) / R), Tn, B);
  fused_bottleneck_mma_kernel<WM><<<grid, kMmaThreads, smem, stream>>>(
      x, w2a, b2a, w2b, b2b, w2c, b2c, out, Tn, H, W, C, Ci, kT, d, R);
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
  auto args = [&](auto launcher) {
    return launcher(static_cast<const bf16*>(x), static_cast<const bf16*>(w2a),
                    static_cast<const bf16*>(b2a), static_cast<const bf16*>(w2b),
                    static_cast<const bf16*>(b2b), static_cast<const bf16*>(w2c),
                    static_cast<const bf16*>(b2c), static_cast<bf16*>(out), B,
                    Tn, H, W, C, Ci, kT, d, max_smem, sms, stream);
  };
  // 128 x 64 CTA tiles where Ci <= 64 (res2), else 64 x 128.
  return Ci <= 64 ? args(launch_mma<4>) : args(launch_mma<2>);
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
