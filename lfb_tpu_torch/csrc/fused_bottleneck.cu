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
// card's bytes-per-FLOP line, so it is bound by arithmetic.  This first
// kernel runs on the f32 FMA units (no tensor cores): its job is to keep
// the Ci-wide intermediates out of device memory, as the TPU kernel does,
// and to read x once (plus the residual) and write the output once.  The
// TPU design (a ring of whole input frames in a 32 MB VMEM, DMA prefetch)
// does not fit a 227 KB block and is not carried over.
//
// Design: one CTA per (clip, frame, band of R output rows).
//   1. branch2a for the band and d halo rows above and below -> h1 in shared
//      memory ((R + 2d) x W x Ci, input type).  Halo rows outside the image
//      are written as 0, not relu(b2a): they are branch2b's spatial zero
//      padding.  Temporal taps outside [0, T) are skipped (their product is
//      the conv's temporal zero padding).
//   2. branch2b as 9 shifted taps over h1 (columns outside the image read
//      0) -> h2 in shared memory (R x W x Ci).
//   3. branch2c, + b2c, + x, relu, one write.
// Each stage is a tiled product (pixels x reduction x channels): the
// reduction is staged 16 deep in shared memory as f32 (A transposed, so a
// thread reads its 4 pixels as one float4), and each of the 256 threads keeps
// 4 pixels x 8 channels of accumulators.  The tile shape (TY: 128 x 64,
// 64 x 128 or 32 x 256 pixels x channels) follows the band's pixel count.
// R is chosen so that a band has about 16384 / Ci pixels and at least 4 rows
// (R = 4 at every R101 stage at crop 256), then cut until the buffers fit the
// block's shared memory.  On the H100 (H100 80GB HBM3, 700 W), R = 4 beat
// R = 8 at res2-res4 (two CTAs per SM against one) and R = 2 at res5 (less
// halo recompute: 65.7 against 87.5 ms at d = 2).
#include "common.cuh"

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
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
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
  if (B < 1 || Tn < 1 || H < 1 || W < 1 || C % kKC || Ci % kKC || C < kKC ||
      Ci < kKC || kT < 1 || kT % 2 == 0 || d < 1 || Tn > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
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
  return launch<__nv_bfloat16>(x, w2a, b2a, w2b, b2b, w2c, b2c, out, B, T, H,
                               W, C, Ci, kT, d,
                               static_cast<cudaStream_t>(stream));
}
