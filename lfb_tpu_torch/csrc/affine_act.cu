// The frozen-BN affine of the unfused blocks with what follows it, as one
// pass over a channels-last tensor viewed as (N, C), forward and backward:
//   y = act(x * s + b [+ r | + (r * sr + br)]),  act: ReLU or identity,
// with s, b, sr, br the f32 per-channel scales and biases.  It serves a
// bottleneck's 2a and 2b (affine + ReLU) and its 2c with the shortcut
// (identity, or branch1's own affine) and the final ReLU, and a non-local
// block's affine + residual; the stem's affine + ReLU runs fused into
// pool1 (max_pool.cu), with this file's arithmetic.
//
// It replaces no TPU kernel: XLA folds this affine, the residual add and the
// ReLU into the convolution's epilogue, so lfb_tpu has none
// (lfb_tpu/ops/affine.py).  PyTorch runs the same arithmetic as separate
// passes: two casts of s and b, a broadcast multiply and a broadcast add (in
// its non-vectorised elementwise kernel), the ReLU, and for 2c a second
// affine, the add and the ReLU.
//
// What bounds it on an H100: bytes.  A few f32 operations an element against
// reading x (and r) and writing y once; the least time is those bytes over
// 3.35 TB/s.
//
// What the design does about it: every thread moves 16 bytes a load and a
// store (8 bf16 or 4 f32 channels of one row), neighbouring threads on
// neighbouring addresses.  A CTA of 256 threads covers (256 / VRb) rows of
// VRb 16-byte columns; each thread keeps its columns' s and b (and sr, br),
// already rounded to the working type, in registers and strides over the
// rows, 4 rows' loads in flight before the first store.  C not a multiple
// of 8 (bf16) or 4 (f32), or a pointer off 16 bytes, takes a scalar kernel
// over the elements; any N and C run.
//
// The numbers are PyTorch's composition (affine_nd, +, F.relu) bit for bit:
// each operation in f32, rounded to the working type after each, as
// PyTorch's opmath does: t = rnd(x * s), t = rnd(t + b), t = rnd(t + sc);
// with explicitly rounded intrinsics, so no multiply-add is contracted.  The
// ReLU is clamp_min's (a NaN passes, else max(t, 0)); the backward's gate
// is threshold_backward's (0 where y <= 0, else dy), so a NaN y passes dy.
// The backward: g = gate(dy, y), dx = rnd(g * s) and for an affine
// shortcut dr = rnd(g * sr); g itself is an identity shortcut's gradient.
// s and b get none: they are frozen, as the reference's AffineNdGradient.
#include "common.cuh"

namespace {

using lfb::aligned;
using lfb::from_f32;
using lfb::Pack;
using lfb::relu;
using lfb::rnd;
using lfb::sm_count;
using lfb::to_f32;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;

enum Shortcut { kNone = 0, kIdentity = 1, kAffine = 2 };

template <typename T, int SC, bool RELU>
__device__ __forceinline__ float fwd_one(float x, float s, float b, float r,
                                         float sr, float br) {
  float t = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, s)), b));
  if (SC == kAffine) {
    r = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(r, sr)), br));
  }
  if (SC != kNone) t = rnd<T>(__fadd_rn(t, r));
  return RELU ? relu(t) : t;
}

// The (row, 16-byte column) tiling shared by the two vector kernels: thread
// (ty, tx) of block (bx, by) takes column by * vrb + tx and rows
// bx * rpb + ty + k * gridDim.x * rpb.
struct Tiling {
  long long rows;
  int vr;    // 16-byte columns a row (C / V)
  int vrb;   // columns a CTA
  int rpb;   // rows a CTA at a time (kThreads / vrb)
};

template <typename T, int SC, bool RELU>
__global__ void __launch_bounds__(kThreads) affine_act_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ r,
    const float* __restrict__ s, const float* __restrict__ b,
    const float* __restrict__ sr, const float* __restrict__ br,
    uint4* __restrict__ y, Tiling t) {
  constexpr int V = Pack<T>::V;
  const int tx = threadIdx.x % t.vrb, ty = threadIdx.x / t.vrb;
  const int col = blockIdx.y * t.vrb + tx;
  if (ty >= t.rpb || col >= t.vr) return;
  float sv[V], bv[V], srv[V], brv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = col * V + k;
    sv[k] = rnd<T>(s[c]);
    bv[k] = rnd<T>(b[c]);
    srv[k] = SC == kAffine ? rnd<T>(sr[c]) : 0.f;
    brv[k] = SC == kAffine ? rnd<T>(br[c]) : 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * t.rpb;
  for (long long row0 = static_cast<long long>(blockIdx.x) * t.rpb + ty;
       row0 < t.rows; row0 += kUnroll * step) {
    uint4 xq[kUnroll], rq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = row0 + u * step;
      if (row < t.rows) {
        const long long i = row * t.vr + col;
        xq[u] = __ldcs(x + i);
        if (SC != kNone) rq[u] = __ldcs(r + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = row0 + u * step;
      if (row >= t.rows) break;
      float xf[V], rf[V];
      Pack<T>::unpack(xq[u], xf);
      if (SC != kNone) Pack<T>::unpack(rq[u], rf);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xf[k] = fwd_one<T, SC, RELU>(xf[k], sv[k], bv[k],
                                     SC != kNone ? rf[k] : 0.f, srv[k],
                                     brv[k]);
      }
      y[row * t.vr + col] = Pack<T>::pack(xf);
    }
  }
}

template <typename T, int SC, bool RELU>
__global__ void __launch_bounds__(kThreads) affine_act_scalar_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const float* __restrict__ s, const float* __restrict__ b,
    const float* __restrict__ sr, const float* __restrict__ br,
    T* __restrict__ y, long long n, int C) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % C);
    const float rf = SC != kNone ? to_f32(r[i]) : 0.f;
    const float srf = SC == kAffine ? rnd<T>(sr[c]) : 0.f;
    const float brf = SC == kAffine ? rnd<T>(br[c]) : 0.f;
    y[i] = from_f32<T>(fwd_one<T, SC, RELU>(to_f32(x[i]), rnd<T>(s[c]),
                                            rnd<T>(b[c]), rf, srf, brf));
  }
}

// g = threshold_backward(dy, y, 0) with RELU, else dy; then dx = rnd(g * s)
// and dr = rnd(g * sr); each output is written where its pointer is set.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads) affine_act_bwd_kernel(
    const uint4* __restrict__ dy, const uint4* __restrict__ y,
    const float* __restrict__ s, const float* __restrict__ sr,
    uint4* __restrict__ dx, uint4* __restrict__ g, uint4* __restrict__ dr,
    Tiling t) {
  constexpr int V = Pack<T>::V;
  const int tx = threadIdx.x % t.vrb, ty = threadIdx.x / t.vrb;
  const int col = blockIdx.y * t.vrb + tx;
  if (ty >= t.rpb || col >= t.vr) return;
  float sv[V], srv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = col * V + k;
    sv[k] = dx ? rnd<T>(s[c]) : 0.f;
    srv[k] = dr ? rnd<T>(sr[c]) : 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * t.rpb;
  for (long long row0 = static_cast<long long>(blockIdx.x) * t.rpb + ty;
       row0 < t.rows; row0 += kUnroll * step) {
    uint4 dq[kUnroll], yq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = row0 + u * step;
      if (row < t.rows) {
        const long long i = row * t.vr + col;
        dq[u] = __ldcs(dy + i);
        if (RELU) yq[u] = __ldcs(y + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = row0 + u * step;
      if (row >= t.rows) break;
      const long long i = row * t.vr + col;
      float gf[V], yf[V], out[V];
      Pack<T>::unpack(dq[u], gf);
      if (RELU) {
        Pack<T>::unpack(yq[u], yf);
#pragma unroll
        for (int k = 0; k < V; ++k) gf[k] = yf[k] <= 0.f ? 0.f : gf[k];
        if (g) g[i] = Pack<T>::pack(gf);
      }
      if (dx) {
#pragma unroll
        for (int k = 0; k < V; ++k) out[k] = rnd<T>(__fmul_rn(gf[k], sv[k]));
        dx[i] = Pack<T>::pack(out);
      }
      if (dr) {
#pragma unroll
        for (int k = 0; k < V; ++k) out[k] = rnd<T>(__fmul_rn(gf[k], srv[k]));
        dr[i] = Pack<T>::pack(out);
      }
    }
  }
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads) affine_act_bwd_scalar_kernel(
    const T* __restrict__ dy, const T* __restrict__ y,
    const float* __restrict__ s, const float* __restrict__ sr,
    T* __restrict__ dx, T* __restrict__ g, T* __restrict__ dr, long long n,
    int C) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % C);
    float gf = to_f32(dy[i]);
    if (RELU) {
      gf = to_f32(y[i]) <= 0.f ? 0.f : gf;
      if (g) g[i] = from_f32<T>(gf);
    }
    if (dx) dx[i] = from_f32<T>(__fmul_rn(gf, rnd<T>(s[c])));
    if (dr) dr[i] = from_f32<T>(__fmul_rn(gf, rnd<T>(sr[c])));
  }
}

// The tiling and grid of the vector kernels for rows x C of T.
template <typename T>
dim3 vector_grid(long long rows, int C, Tiling* t) {
  t->rows = rows;
  t->vr = C / Pack<T>::V;
  t->vrb = t->vr < kThreads ? t->vr : kThreads;
  t->rpb = kThreads / t->vrb;
  const int gy = (t->vr + t->vrb - 1) / t->vrb;
  const long long groups = (rows + t->rpb - 1) / t->rpb;
  long long gx = sm_count() * kBlocksPerSm / gy;
  if (gx < 1) gx = 1;
  if (gx > groups) gx = groups;
  return dim3(static_cast<unsigned>(gx), gy);
}

unsigned scalar_grid(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  return static_cast<unsigned>(blocks < most ? blocks : most);
}

template <typename T, int SC, bool RELU>
cudaError_t launch_fwd(const void* x, const void* r, const float* s,
                       const float* b, const float* sr, const float* br,
                       void* y, long long rows, int C, cudaStream_t stream) {
  if (C % Pack<T>::V == 0 && aligned(x) && aligned(y) &&
      (SC == kNone || aligned(r))) {
    Tiling t;
    const dim3 grid = vector_grid<T>(rows, C, &t);
    affine_act_kernel<T, SC, RELU><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(r), s, b, sr,
        br, static_cast<uint4*>(y), t);
  } else {
    const long long n = rows * C;
    affine_act_scalar_kernel<T, SC, RELU>
        <<<scalar_grid(n), kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(r), s, b, sr, br,
            static_cast<T*>(y), n, C);
  }
  return cudaGetLastError();
}

template <typename T, bool RELU>
cudaError_t launch_bwd(const void* dy, const void* y, const float* s,
                       const float* sr, void* dx, void* g, void* dr,
                       long long rows, int C, cudaStream_t stream) {
  const bool vec = C % Pack<T>::V == 0 && aligned(dy) &&
                   (!RELU || aligned(y)) && aligned(dx) && aligned(g) &&
                   aligned(dr);
  if (vec) {
    Tiling t;
    const dim3 grid = vector_grid<T>(rows, C, &t);
    affine_act_bwd_kernel<T, RELU><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(dy), static_cast<const uint4*>(y), s, sr,
        static_cast<uint4*>(dx), static_cast<uint4*>(g),
        static_cast<uint4*>(dr), t);
  } else {
    const long long n = rows * C;
    affine_act_bwd_scalar_kernel<T, RELU>
        <<<scalar_grid(n), kThreads, 0, stream>>>(
            static_cast<const T*>(dy), static_cast<const T*>(y), s, sr,
            static_cast<T*>(dx), static_cast<T*>(g), static_cast<T*>(dr), n,
            C);
  }
  return cudaGetLastError();
}

template <typename T>
int forward(const void* x, const void* r, const void* s, const void* b,
            const void* sr, const void* br, void* y, long long rows, int C,
            int shortcut, int relu, void* stream) {
  if (rows <= 0 || C <= 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto fs = static_cast<const float*>(s);
  const auto fb = static_cast<const float*>(b);
  const auto fsr = static_cast<const float*>(sr);
  const auto fbr = static_cast<const float*>(br);
  switch (shortcut * 2 + (relu ? 1 : 0)) {
    case kNone * 2:
      return launch_fwd<T, kNone, false>(x, r, fs, fb, fsr, fbr, y, rows, C, st);
    case kNone * 2 + 1:
      return launch_fwd<T, kNone, true>(x, r, fs, fb, fsr, fbr, y, rows, C, st);
    case kIdentity * 2:
      return launch_fwd<T, kIdentity, false>(x, r, fs, fb, fsr, fbr, y, rows,
                                             C, st);
    case kIdentity * 2 + 1:
      return launch_fwd<T, kIdentity, true>(x, r, fs, fb, fsr, fbr, y, rows,
                                            C, st);
    case kAffine * 2:
      return launch_fwd<T, kAffine, false>(x, r, fs, fb, fsr, fbr, y, rows, C,
                                           st);
    case kAffine * 2 + 1:
      return launch_fwd<T, kAffine, true>(x, r, fs, fb, fsr, fbr, y, rows, C,
                                          st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int backward(const void* dy, const void* y, const void* s, const void* sr,
             void* dx, void* g, void* dr, long long rows, int C, int relu,
             void* stream) {
  if (rows <= 0 || C <= 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto fs = static_cast<const float*>(s);
  const auto fsr = static_cast<const float*>(sr);
  return relu ? launch_bwd<T, true>(dy, y, fs, fsr, dx, g, dr, rows, C, st)
              : launch_bwd<T, false>(dy, y, fs, fsr, dx, g, dr, rows, C, st);
}

}  // namespace

// shortcut: 0 none (r, sr, br unused), 1 identity (r), 2 affine (r, sr, br).
LFB_EXPORT int lfb_affine_act_f32(const void* x, const void* r, const void* s,
                                  const void* b, const void* sr,
                                  const void* br, void* y, long long rows,
                                  int C, int shortcut, int relu,
                                  void* stream) {
  return forward<float>(x, r, s, b, sr, br, y, rows, C, shortcut, relu,
                        stream);
}

LFB_EXPORT int lfb_affine_act_bf16(const void* x, const void* r, const void* s,
                                   const void* b, const void* sr,
                                   const void* br, void* y, long long rows,
                                   int C, int shortcut, int relu,
                                   void* stream) {
  return forward<__nv_bfloat16>(x, r, s, b, sr, br, y, rows, C, shortcut,
                                relu, stream);
}

// y is read only with relu; g (relu only), dx and dr (with sr) are written
// where not null.
LFB_EXPORT int lfb_affine_act_bwd_f32(const void* dy, const void* y,
                                      const void* s, const void* sr, void* dx,
                                      void* g, void* dr, long long rows, int C,
                                      int relu, void* stream) {
  return backward<float>(dy, y, s, sr, dx, g, dr, rows, C, relu, stream);
}

LFB_EXPORT int lfb_affine_act_bwd_bf16(const void* dy, const void* y,
                                       const void* s, const void* sr, void* dx,
                                       void* g, void* dr, long long rows,
                                       int C, int relu, void* stream) {
  return backward<__nv_bfloat16>(dy, y, s, sr, dx, g, dr, rows, C, relu,
                                 stream);
}
