// Stem convolution, weight gradient: dW of conv1 (kT x 7 x 7, stride
// (1, 2, 2), padding (kT / 2, 3, 3), Cin 3 -> Cout 64, channels-last) from
// the input x (B, T, H, W, 3) and the output gradient g (B, T, Ho, Wo, 64),
// both in the input type:
//   dW[kt, kh, kw, ci, co] = sum over (b, t, ho, wo) of
//       x[b, t + kt - kT/2, 2 ho + kh - 3, 2 wo + kw - 3, ci] * g[b, t, ho, wo, co]
// in f32, out of range taps reading zero.  Replaces
// lfb_tpu/ops/pallas_stem.py:_stem_dw_kernel (stem_conv_s2d_dw).
//
// 47,040 outputs (kT = 5), each a sum over B * T * Ho * Wo positions (3.2 M
// at B = 8, T = 32, crop 224).  The TPU kernel kept the whole dW resident in
// VMEM across a sequential grid; CTAs run in parallel and in no order, so
// the work is split in two launches with no atomics (deterministic):
//  * stem_dw_partial_kernel -- one CTA per (frame b, t; temporal tap kt)
//    stages, band by band, the frame's output gradient (at most 256 pixels x
//    64 channels) and the matching input halo of frame t + kt - kT/2 in
//    shared memory as f32.  Each of its 196 threads owns one (kh, kw) tap x
//    3 input channels x 16 output channels: 48 f32 accumulators in registers
//    and 48 FMAs for 3 + 16 shared-memory reads per position.  It writes the
//    frame's partial dW of that tap.
//  * stem_dw_reduce_kernel -- one thread per dW element sums the frames'
//    partials in frame order.
// Like the forward kernel it is bound by FMA throughput and shared-memory
// reads, not by device memory (the partials are 9,408 floats per CTA).
#include "common.cuh"

namespace {

using lfb::to_f32;

constexpr int kCin = 3;
constexpr int kCout = 64;
constexpr int kK = 7;
constexpr int kPad = 3;
constexpr int kTaps = kK * kK;                     // (kh, kw) pairs
constexpr int kChPerThread = 16;
constexpr int kThreads = kTaps * (kCout / kChPerThread);   // 196
constexpr int kTapW = kTaps * kCin * kCout;        // dW of one temporal tap
constexpr int kPixSlots = 256;                     // output pixels per band

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
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
    const T* xf = x + ((size_t)b * Tn + tin) * H * W * kCin;
    const T* gf = g + (size_t)frame * Ho * Wo * kCout;
    for (int ho0 = 0; ho0 < Ho; ho0 += TH) {
      const int rows = min(TH, Ho - ho0);
      const int rows_in = 2 * rows + kK - 2;
      const int hin0 = 2 * ho0 - kPad;
      __syncthreads();                   // the previous band's readers are done
      for (int i = tid; i < rows * Wo * kCout; i += kThreads)
        sg[i] = to_f32(gf[(size_t)ho0 * Wo * kCout + i]);
      for (int i = tid; i < rows_in * Wp * kCin; i += kThreads) {
        const int ci = i % kCin;
        const int rest = i / kCin;
        const int col = rest % Wp;
        const int row = rest / Wp;
        const int hin = hin0 + row;
        const int win = col - kPad;
        float val = 0.f;
        if (hin >= 0 && hin < H && win >= 0 && win < W)
          val = to_f32(xf[((size_t)hin * W + win) * kCin + ci]);
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

// dw[kt, e] = sum over frames f (in order) of partial[kt, f, e].
__global__ void stem_dw_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dw, int frames,
                                      int kT) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kT * kTapW) return;
  const int kt = i / kTapW;
  const int e = i - kt * kTapW;
  const float* p = partial + (size_t)kt * frames * kTapW + e;
  float s = 0.f;
  for (int f = 0; f < frames; ++f) s += p[(size_t)f * kTapW];
  dw[i] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* g, void* partial, void* dw,
                   int B, int Tn, int H, int W, int kT, cudaStream_t stream) {
  const int Ho = (H + 2 * kPad - kK) / 2 + 1;
  const int Wo = (W + 2 * kPad - kK) / 2 + 1;
  const int TH = kPixSlots / Wo;   // >= 1: the wrapper checks Wo <= 256
  const size_t smem = (size_t)(kPixSlots * kCout +
                               (2 * TH + kK - 2) * (W + 2 * kPad) * kCin) *
                      sizeof(float);
  cudaError_t err = lfb::allow_smem(stem_dw_partial_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int frames = B * Tn;
  stem_dw_partial_kernel<T><<<dim3(frames, kT), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(partial), Tn, H, W, kT, Ho, Wo, TH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = kT * kTapW;
  stem_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), frames, kT);
  return cudaGetLastError();
}

}  // namespace

// partial: f32 scratch of kT * B * T * 9408 floats; dw: f32 (kT, 7, 7, 3, 64).
// Requires Wo <= 256 (checked by the Python wrapper).
LFB_EXPORT int lfb_stem_conv_dw_f32(const void* x, const void* g,
                                    void* partial, void* dw, int B, int T,
                                    int H, int W, int kT, void* stream) {
  return launch<float>(x, g, partial, dw, B, T, H, W, kT,
                       static_cast<cudaStream_t>(stream));
}

LFB_EXPORT int lfb_stem_conv_dw_bf16(const void* x, const void* g,
                                     void* partial, void* dw, int B, int T,
                                     int H, int W, int kT, void* stream) {
  return launch<__nv_bfloat16>(x, g, partial, dw, B, T, H, W, kT,
                               static_cast<cudaStream_t>(stream));
}
