// Stem convolution, forward: conv1 of the I3D/C2D backbones,
// kT x 7 x 7, stride (1, 2, 2), padding (kT / 2, 3, 3), Cin 3 -> Cout 64,
// channels-last: x (B, T, H, W, 3) -> out (B, T, Ho, Wo, 64), f32
// accumulation, output in the input type.  Replaces
// lfb_tpu/ops/pallas_stem.py:_stem_kernel (stem_conv_s2d).
//
// A direct convolution.  One CTA per (b, t, tile of TH output rows), with TH
// the largest row count whose pixels fit the CTA's 256 pixel slots.  For each
// temporal tap the CTA stages that frame's input halo (2 TH + 5 rows, padded
// width, 3 channels) and the tap's 7 x 7 x 3 x 64 weights in shared memory as
// f32; each thread accumulates 4 pixels x 16 output channels in registers
// (64 FMAs per 4 input loads and 4 broadcast float4 weight loads).  With
// Cin = 3 the reduction (kT * 147) is too shallow for the Hopper tensor cores
// to pay off in a first kernel, and the TPU's 2x2 space-to-depth packing
// (which existed to fill a 128-lane MXU) is not carried over: the kernel is
// bound by FMA issue and shared-memory bandwidth.
#include "common.cuh"

namespace {

using lfb::from_f32;
using lfb::to_f32;

constexpr int kThreads = 256;
constexpr int kCin = 3;
constexpr int kCout = 64;
constexpr int kK = 7;
constexpr int kPad = 3;
constexpr int kTapW = kK * kK * kCin * kCout;   // weights of one temporal tap
constexpr int kPixPerThread = 4;
constexpr int kPixSlots = 64 * kPixPerThread;   // 64 pixel groups per CTA
constexpr int kChPerThread = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ out, int Tn, int H, int W, int kT, int Ho,
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
    const T* xf = x + ((size_t)b * Tn + (t_ok ? tin : 0)) * frame;
    for (int i = tid; i < rows_in * Wp * kCin; i += kThreads) {
      const int ci = i % kCin;
      const int rest = i / kCin;
      const int col = rest % Wp;
      const int row = rest / Wp;
      const int hin = hin0 + row;
      const int win = col - kPad;
      float val = 0.f;
      if (t_ok && hin >= 0 && hin < H && win >= 0 && win < W)
        val = to_f32(xf[((size_t)hin * W + win) * kCin + ci]);
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
    T* o = out + ((((size_t)b * Tn + t) * Ho + ho0 + prow[i]) * Wo + pcol[i]) *
                     kCout + cg * kChPerThread;
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) o[j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int B, int Tn,
                   int H, int W, int kT, cudaStream_t stream) {
  const int Ho = (H + 2 * kPad - kK) / 2 + 1;
  const int Wo = (W + 2 * kPad - kK) / 2 + 1;
  const int TH = kPixSlots / Wo;   // >= 1: the wrapper checks Wo <= 256
  const int rows_in = 2 * TH + kK - 2;
  const size_t smem =
      (size_t)(kTapW + rows_in * (W + 2 * kPad) * kCin) * sizeof(float);
  cudaError_t err = lfb::allow_smem(stem_conv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ho + TH - 1) / TH, Tn, B);
  stem_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), Tn, H, W, kT, Ho, Wo, TH);
  return cudaGetLastError();
}

}  // namespace

// w is f32 (kT, 7, 7, 3, 64), already rounded to the input type by the
// wrapper.  Requires Wo <= 256 (checked by the Python wrapper).
LFB_EXPORT int lfb_stem_conv_f32(const void* x, const void* w, void* out,
                                 int B, int T, int H, int W, int kT,
                                 void* stream) {
  return launch<float>(x, w, out, B, T, H, W, kT,
                       static_cast<cudaStream_t>(stream));
}

LFB_EXPORT int lfb_stem_conv_bf16(const void* x, const void* w, void* out,
                                  int B, int T, int H, int W, int kT,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, w, out, B, T, H, W, kT,
                               static_cast<cudaStream_t>(stream));
}
