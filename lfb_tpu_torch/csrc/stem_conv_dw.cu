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
// at B = 8, T = 32, crop 224): per frame and temporal tap, one product
// (taps x pixels) . (pixels x 64 channels) reduced over the frame's 12,544
// output pixels, 302 GFLOP in all, so on the H100 it is bound by
// arithmetic.  The TPU kernel kept the whole dW resident in VMEM across a
// sequential grid; CTAs run in parallel and in no order, so the work is
// split in two launches with no atomics (deterministic):
//  * a partial kernel, one CTA per (frame b, t; temporal tap kt), writes
//    the frame's partial dW of that tap;
//  * stem_dw_reduce_kernel, one thread per dW element, sums the frames'
//    partials in frame order.
//
// bf16 (stem_dw_mma_kernel): the product runs on mma.sync.m16n8k16 (bf16
// in, f32 accumulate) over the TPU kernel's space-to-depth packing
// (pallas_stem.py:_pack_x / _unpack_dw4), which the wrapper does on the
// host side: x becomes (B, T, Ho + 3, Wo + 3, 16), pixel (r, c) holding the
// 2 x 2 input pixels (2r + hp - 4, 2c + wp - 4) x 3 channels, (hp, wp, ci),
// zero-padded to 16.  The stride-2 7 x 7 conv is then a stride-1 4 x 4 conv
// over 16 channels (the 7 x 7 taps padded to 8 x 8 with a leading zero),
// and each (dh, dw) tap reads one contiguous 16-channel row: exactly one
// k16 ldmatrix.trans operand, with no im2col.  This was taken over an im2col
// of the 147 (kh, kw, ci) taps in shared memory, which every CTA would
// build by writing 147 values per output pixel, against 16 for a packed
// pixel here; the packing costs 16 / 12 x 64 / 49 = 1.74x the multiply-adds.  dW
// of one temporal tap is then (16 taps x 16 channels) x 64 = 16,384 f32:
// each of the 8 warps owns 2 (dh, dw) taps x 64 channels, 64 accumulators
// a thread.  Bands of up to 256 output pixels of g (rows padded to 72
// bf16) and the matching band of packed x, 3 rows taller (the two 16-byte
// halves of a pixel swapped every fourth pixel, so 8 consecutive pixels'
// rows fall in distinct banks) stream through a two-stage cp.async ring.
// Per 16 pixels a warp takes g's B fragments with ldmatrix.trans (pixels
// along rows, as V in P V) and, per tap, x's A fragment with
// ldmatrix.trans from per-lane pixel addresses shifted by (dh, dw); pixels
// past the band read pixel 0 against zero rows of g.  The grid is (kT,
// frames) with the tap the fast index, so the kT CTAs that read one frame
// of g run together and share it in L2.
//
// f32 (stem_dw_partial_kernel): the f32 train step is held to the CPU at
// 1e-4, which TF32 would break, so f32 stays on the FMA units: each of its
// 196 threads owns one (kh, kw) tap x 3 input channels x 16 output
// channels, 48 f32 accumulators and 48 FMAs for 3 + 16 shared-memory reads
// per position, over the frame's output gradient and input halo staged as
// f32 band by band.
#include "common.cuh"
#include "mma_bf16.cuh"

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

// dw[kt, e] = sum over frames f (in order) of partial[kt, f, e], for tap_w
// elements e per temporal tap.
__global__ void stem_dw_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dw, int frames,
                                      int kT, int tap_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kT * tap_w) return;
  const int kt = i / tap_w;
  const int e = i - kt * tap_w;
  const float* p = partial + (size_t)kt * frames * tap_w + e;
  float s = 0.f;
  for (int f = 0; f < frames; ++f) s += p[(size_t)f * tap_w];
  dw[i] = s;
}

cudaError_t reduce(const void* partial, void* dw, int frames, int kT,
                   int tap_w, cudaStream_t stream) {
  const int n = kT * tap_w;
  stem_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), frames, kT,
      tap_w);
  return cudaGetLastError();
}

// ---- bf16: tensor cores ----------------------------------------------------

using lfb::bf16;

constexpr int kS2dC = 16;                       // packed channels (hp, wp, ci)
constexpr int kS2dTapW = 16 * kS2dC * kCout;    // dW of one temporal tap
constexpr int kMmaThreads = 256;                // 8 warps x 2 (dh, dw) taps
constexpr int kGLd = kCout + 8;                 // row stride of the g band

// One stage of the ring: kPixSlots rows of g, (R + 3) x (Wo + 3) packed x.
__host__ __device__ inline size_t mma_stage_elems(int R, int Wo) {
  return (size_t)kPixSlots * kGLd + (size_t)(R + 3) * (Wo + 3) * kS2dC;
}

__global__ void __launch_bounds__(kMmaThreads)
stem_dw_mma_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ g,
                   float* __restrict__ partial, int Tn, int kT, int Ho, int Wo,
                   int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Wp = Wo + 3;
  const size_t stage = mma_stage_elems(R, Wo);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int kt = blockIdx.x;
  const int frame = blockIdx.y;             // b * Tn + t
  const int b = frame / Tn;
  const int t = frame - b * Tn;
  const int tin = t + kt - kT / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = (lane >> 3) & 1;         // channels 0-7 or 8-15 of a pixel

  float acc[2][kCout / 8][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < kCout / 8; ++n)
      acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;

  if (tin >= 0 && tin < Tn) {               // uniform over the CTA
    const bf16* xf = xs + ((size_t)b * Tn + tin) * (Ho + 3) * Wp * kS2dC;
    const bf16* gf = g + (size_t)frame * Ho * Wo * kCout;
    const int bands = (Ho + R - 1) / R;
    auto load = [&](int band, int buf) {
      const int ho0 = band * R;
      const int npix = min(R, Ho - ho0) * Wo;
      bf16* sg = ring + buf * stage;
      bf16* sx = sg + kPixSlots * kGLd;
      lfb::load_tile_async(sg, kGLd, gf + (size_t)ho0 * Wo * kCout, kCout, 0,
                           (npix + 15) & ~15, npix, 0, kCout);
      // Packed rows ho0 .. ho0 + rows + 2, contiguous: 2 chunks a pixel.
      const bf16* src = xf + (size_t)ho0 * Wp * kS2dC;
      const int n = (min(R, Ho - ho0) + 3) * Wp * 2;
      for (int i = threadIdx.x; i < n; i += kMmaThreads) {
        const int p = i >> 1;
        lfb::cp_async_16(sx + p * kS2dC + (((i & 1) ^ ((p >> 2) & 1)) << 3),
                         src + (size_t)i * 8, true);
      }
    };
    load(0, 0);
    lfb::cp_async_commit();
    for (int band = 0; band < bands; ++band) {
      const int buf = band & 1;
      if (band + 1 < bands) {
        load(band + 1, buf ^ 1);
        lfb::cp_async_commit();
        lfb::cp_async_wait<1>();
      } else {
        lfb::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sg = ring + buf * stage;
      const bf16* sx = sg + kPixSlots * kGLd;
      const int npix = min(R, Ho - band * R) * Wo;
      for (int k0 = 0; k0 < npix; k0 += 16) {
        uint32_t bf[kCout / 8][2];
#pragma unroll
        for (int np = 0; np < kCout / 16; ++np) {
          uint32_t bb[4];
          lfb::ldsm_x4_trans(bb, lfb::bt_frag(sg, kGLd, k0, np * 16, lane));
          bf[2 * np][0] = bb[0];
          bf[2 * np][1] = bb[1];
          bf[2 * np + 1][0] = bb[2];
          bf[2 * np + 1][1] = bb[3];
        }
        // This lane's pixel of the A fragment (k = pixel, m = channel).
        int k = k0 + (lane & 7) + ((lane >> 4) << 3);
        if (k >= npix) k = 0;                 // against a zero row of g
        const int r = k / Wo;
        const int p0 = r * Wp + k - r * Wo;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int tap = warp * 2 + j;       // (dh, dw) = (tap / 4, tap % 4)
          const int p = p0 + (tap >> 2) * Wp + (tap & 3);
          uint32_t a[4];
          lfb::ldsm_x4_trans(a, sx + p * kS2dC + ((half ^ ((p >> 2) & 1)) << 3));
#pragma unroll
          for (int n = 0; n < kCout / 8; ++n)
            lfb::mma_16816(acc[j][n], a, bf[n][0], bf[n][1]);
        }
      }
      __syncthreads();                        // before this stage is reloaded
    }
  }

  // partial[kt, frame, (dh, dw), c16, co]
  float* out = partial + ((size_t)kt * gridDim.y + frame) * kS2dTapW;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < kCout / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (lane >> 2) + 8 * h;
        const int co = n * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + ((warp * 2 + j) * kS2dC + m) * kCout +
                                   co) =
            make_float2(acc[j][n][2 * h], acc[j][n][2 * h + 1]);
      }
}

cudaError_t launch_bf16(const void* xs, const void* g, void* partial,
                        void* dw, int B, int Tn, int H, int W, int kT,
                        cudaStream_t stream) {
  const int Ho = (H + 2 * kPad - kK) / 2 + 1;
  const int Wo = (W + 2 * kPad - kK) / 2 + 1;
  const int R = min(Ho, kPixSlots / Wo);   // >= 1: the wrapper checks Wo <= 256
  if ((long long)B * Tn > 65535) return cudaErrorInvalidValue;
  const size_t smem = 2 * mma_stage_elems(R, Wo) * sizeof(bf16);
  cudaError_t err = lfb::allow_smem(stem_dw_mma_kernel, smem);
  if (err != cudaSuccess) return err;
  const int frames = B * Tn;
  stem_dw_mma_kernel<<<dim3(kT, frames), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(g),
      static_cast<float*>(partial), Tn, kT, Ho, Wo, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, dw, frames, kT, kS2dTapW, stream);
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
  return reduce(partial, dw, frames, kT, kTapW, stream);
}

}  // namespace

// f32: x (B, T, H, W, 3); partial: scratch of kT * B * T * 9408 floats; dw:
// (kT, 7, 7, 3, 64).  bf16: x packed by space-to-depth, (B, T, Ho + 3,
// Wo + 3, 16); partial: kT * B * T * 16384 floats; dw: (kT, 4, 4, 16, 64),
// the packed taps (dh, dw) x channels (hp, wp, ci).  Requires Wo <= 256
// (checked by the Python wrapper).
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
