// Max pooling over channels-last (B, T, H, W, C) tensors, forward and
// backward, for every window the port pools with: pool1 1x3x3 / 1x2x2 /
// pad 0,1,1, pool2 2x1x1 / 2x1x1 and the non-local blocks' 1x2x2 / 1x2x2.
// The forward also runs fused behind the stem's frozen affine and ReLU:
//   y = maxpool(relu(x * s + b)),
// reading the stem conv's output once and writing only the pooled map.
//
// It replaces no TPU kernel: lfb_tpu pools with XLA's reduce_window
// (lfb_tpu/ops/pooling.py).  PyTorch's max_pool3d on CUDA writes an int64
// flat index for every output, with or without autograd (4x the bytes of a
// bf16 output), and sums its backward with atomics into a zero-filled
// gradient, so overlapping windows (pool1's) sum in a different order every
// run.
//
// What bounds it on an H100: bytes.  A few compares an element against
// reading the input once and writing the output once; the least time is
// those bytes over 3.35 TB/s.
//
// What the design does about it:
// * A CTA takes one output row (n, t', h') at a time and its threads the
//   row's (w', 16-byte channel column) items, neighbouring threads on
//   neighbouring addresses: 16 bytes a load and a store (8 bf16 or 4 f32
//   channels), the window's loads all issued before the compares for the
//   three windows the port uses (template cases; any other window runs the
//   same code with runtime bounds).  C not a multiple of 8 (bf16) or 4
//   (f32), or a pointer off 16 bytes, takes one channel a thread.
// * Indices are written only when autograd will call the backward, and
//   then as a uint8 offset within the window, (dt * kh + dh) * kw + dw
//   (at most 256 positions), one byte an output element.
// * The backward gathers: each input element sums, in f32 and in the order
//   of its outputs (t', h', w' ascending), the gradients of the outputs
//   whose window covers it and whose offset names it (at most 4 for pool1,
//   1 for pool2 and the non-local pools), and is written once, rounded
//   once.  No atomics, no zero fill: the same bits every run.
//
// The numbers are ATen's: the scan over (t, h, w) in order from the first
// position inside the input, the rule `v > m || isnan(v)` and the value
// moved as its own bits, so the value and the chosen position are
// max_pool3d's bit for bit, ties and NaN included; padding never wins and
// output sizes use floor mode.  The fused stem computes each element as
// affine_act.cu does (rnd(rnd(x * s) + b), then clamp_min's ReLU, with s and
// b rounded to the working type) before the compare, so its output is
// max_pool3d(affine_act(x)) bit for bit.  Its backward is the composition's
// pool backward, threshold_backward on y and multiply:
//   dx = rnd(g * s),  g = y_claim <= 0 ? 0 : rnd(sum of the claiming dy),
// where y_claim, the ReLU output at the element, equals the pooled value of
// any window that claims it (0 and no sum where none does).
#include <cstdint>

#include "common.cuh"

namespace {

using lfb::aligned;
using lfb::Pack;
using lfb::relu;
using lfb::rnd;
using lfb::sm_count;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// Input (B, T, H, W, C), output (B, To, Ho, Wo, C); window k, stride s and
// padding p over (t, h, w).
struct Geometry {
  int B, T, H, W, C, To, Ho, Wo;
  int kt, kh, kw, st, sh, sw, pt, ph, pw;
};

// One working-type element as its own bits (16 or 32 of an unsigned), and
// V of them moved as one access: 16 bytes (V = Pack<T>::V) or one element.
template <typename T>
struct Bits;

template <>
struct Bits<float> {
  static __device__ __forceinline__ float value(unsigned b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ unsigned one(const float* p) {
    return __float_as_uint(*p);
  }
  static __device__ __forceinline__ void put(float* p, unsigned b) {
    *p = __uint_as_float(b);
  }
  static __device__ __forceinline__ void split(uint4 q, unsigned* b) {
    b[0] = q.x;
    b[1] = q.y;
    b[2] = q.z;
    b[3] = q.w;
  }
  static __device__ __forceinline__ uint4 join(const unsigned* b) {
    return make_uint4(b[0], b[1], b[2], b[3]);
  }
};

template <>
struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ float value(unsigned b) {
    return __uint_as_float(b << 16);
  }
  static __device__ __forceinline__ unsigned one(const __nv_bfloat16* p) {
    return __bfloat16_as_ushort(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, unsigned b) {
    *p = __ushort_as_bfloat16(static_cast<unsigned short>(b));
  }
  static __device__ __forceinline__ void split(uint4 q, unsigned* b) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = w[i] & 0xffffu;
      b[2 * i + 1] = w[i] >> 16;
    }
  }
  static __device__ __forceinline__ uint4 join(const unsigned* b) {
    return make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16,
                      b[4] | b[5] << 16, b[6] | b[7] << 16);
  }
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, unsigned* b) {
  if constexpr (V == 1) {
    b[0] = Bits<T>::one(p);
  } else {
    Bits<T>::split(__ldg(reinterpret_cast<const uint4*>(p)), b);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const unsigned* b) {
  if constexpr (V == 1) {
    Bits<T>::put(p, b[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = Bits<T>::join(b);
  }
}

// V one-byte window offsets as one access.
template <int V>
__device__ __forceinline__ void load_offsets(const uint8_t* p, unsigned* k) {
  if constexpr (V == 1) {
    k[0] = __ldg(p);
  } else {
    unsigned w[V / 4];
    if constexpr (V == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x;
      w[1] = q.y;
    }
#pragma unroll
    for (int l = 0; l < V; ++l) k[l] = (w[l / 4] >> (8 * (l % 4))) & 0xffu;
  }
}

template <int V>
__device__ __forceinline__ void store_offsets(uint8_t* p, const unsigned* k) {
  if constexpr (V == 1) {
    p[0] = static_cast<uint8_t>(k[0]);
  } else {
    unsigned w[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      w[i] = k[4 * i] | k[4 * i + 1] << 8 | k[4 * i + 2] << 16 |
             k[4 * i + 3] << 24;
    }
    if constexpr (V == 4) {
      *reinterpret_cast<unsigned*>(p) = w[0];
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  }
}

// The stem's element before the pool, as affine_act.cu's fwd_one with no
// shortcut and a ReLU; s and b already rounded to T.
template <typename T>
__device__ __forceinline__ unsigned stem_bits(unsigned xb, float s, float b) {
  const float t = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(Bits<T>::value(xb), s)),
                                   b));
  return Pack<T>::bits(relu(t));
}

// The window's extent: the template case, or the geometry's (0).
template <int K>
__device__ __forceinline__ int extent(int k) {
  return K ? K : k;
}

// y (and, with SAVE, the window offsets) of each output element; with STEM
// the affine and the ReLU of s and b first.
template <typename T, int V, int KT, int KH, int KW, bool SAVE, bool STEM>
__global__ void __launch_bounds__(kThreads) max_pool_cl_kernel(
    const T* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ b, T* __restrict__ y,
    uint8_t* __restrict__ offsets, Geometry g) {
  const int kt = extent<KT>(g.kt), kh = extent<KH>(g.kh),
            kw = extent<KW>(g.kw);
  const int cv = g.C / V;
  const int per_row = g.Wo * cv;
  const long long rows = static_cast<long long>(g.B) * g.To * g.Ho;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int oh = static_cast<int>(row % g.Ho);
    const long long nt = row / g.Ho;
    const int ot = static_cast<int>(nt % g.To);
    const long long n = nt / g.To;
    const int t0 = ot * g.st - g.pt, h0 = oh * g.sh - g.ph;
    for (int j = threadIdx.x; j < per_row; j += kThreads) {
      const int ow = j / cv;
      const int c0 = (j - ow * cv) * V;
      const int w0 = ow * g.sw - g.pw;
      float sv[V], bv[V];
      if constexpr (STEM) {
#pragma unroll
        for (int l = 0; l < V; ++l) {
          sv[l] = rnd<T>(s[c0 + l]);
          bv[l] = rnd<T>(b[c0 + l]);
        }
      }
      // ATen's start: -inf, at the first position inside the input.
      const unsigned first =
          ((max(t0, 0) - t0) * kh + (max(h0, 0) - h0)) * kw + (max(w0, 0) - w0);
      float m[V];
      unsigned best[V], k[V];
#pragma unroll
      for (int l = 0; l < V; ++l) {
        m[l] = -INFINITY;
        best[l] = Pack<T>::bits(-INFINITY);
        k[l] = first;
      }
#pragma unroll
      for (int dt = 0; dt < kt; ++dt) {
        const int t = t0 + dt;
#pragma unroll
        for (int dh = 0; dh < kh; ++dh) {
          const int h = h0 + dh;
#pragma unroll
          for (int dw = 0; dw < kw; ++dw) {
            const int w = w0 + dw;
            if (t < 0 || t >= g.T || h < 0 || h >= g.H || w < 0 || w >= g.W) {
              continue;
            }
            unsigned v[V];
            load<T, V>(x + (((n * g.T + t) * g.H + h) * g.W + w) * g.C + c0,
                       v);
#pragma unroll
            for (int l = 0; l < V; ++l) {
              if constexpr (STEM) v[l] = stem_bits<T>(v[l], sv[l], bv[l]);
              const float f = Bits<T>::value(v[l]);
              if (f > m[l] || isnan(f)) {
                m[l] = f;
                best[l] = v[l];
                k[l] = (dt * kh + dh) * kw + dw;
              }
            }
          }
        }
      }
      const long long o = ((n * g.To + ot) * g.Ho + oh) * g.Wo + ow;
      store<T, V>(y + o * g.C + c0, best);
      if constexpr (SAVE) store_offsets<V>(offsets + o * g.C + c0, k);
    }
  }
}

// dx of each input element from the outputs whose window claims it; with
// STEM through the ReLU (on the pooled y) and the affine's scale s.
template <typename T, int V, bool STEM>
__global__ void __launch_bounds__(kThreads) max_pool_cl_bwd_kernel(
    const T* __restrict__ dy, const uint8_t* __restrict__ offsets,
    const T* __restrict__ y, const float* __restrict__ s,
    T* __restrict__ dx, Geometry g) {
  const int cv = g.C / V;
  const int per_row = g.W * cv;
  const long long rows = static_cast<long long>(g.B) * g.T * g.H;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int h = static_cast<int>(row % g.H);
    const long long nt = row / g.H;
    const int t = static_cast<int>(nt % g.T);
    const long long n = nt / g.T;
    // The outputs whose window covers t (and h): o * stride - pad + d = t,
    // 0 <= d < k.
    const int at = t + g.pt - g.kt + 1, ah = h + g.ph - g.kh + 1;
    const int ot_lo = at > 0 ? (at + g.st - 1) / g.st : 0;
    const int ot_hi = min(g.To - 1, (t + g.pt) / g.st);
    const int oh_lo = ah > 0 ? (ah + g.sh - 1) / g.sh : 0;
    const int oh_hi = min(g.Ho - 1, (h + g.ph) / g.sh);
    for (int j = threadIdx.x; j < per_row; j += kThreads) {
      const int w = j / cv;
      const int c0 = (j - w * cv) * V;
      const int aw = w + g.pw - g.kw + 1;
      const int ow_lo = aw > 0 ? (aw + g.sw - 1) / g.sw : 0;
      const int ow_hi = min(g.Wo - 1, (w + g.pw) / g.sw);
      float acc[V], yc[V];
      bool claimed[V];
#pragma unroll
      for (int l = 0; l < V; ++l) {
        acc[l] = 0.f;
        yc[l] = 0.f;
        claimed[l] = false;
      }
      for (int ot = ot_lo; ot <= ot_hi; ++ot) {
        for (int oh = oh_lo; oh <= oh_hi; ++oh) {
          for (int ow = ow_lo; ow <= ow_hi; ++ow) {
            const unsigned here =
                ((t + g.pt - ot * g.st) * g.kh + (h + g.ph - oh * g.sh)) *
                    g.kw + (w + g.pw - ow * g.sw);
            const long long o =
                (((n * g.To + ot) * g.Ho + oh) * g.Wo + ow) * g.C + c0;
            unsigned k[V], d[V], yb[V];
            load_offsets<V>(offsets + o, k);
            load<T, V>(dy + o, d);
            if constexpr (STEM) load<T, V>(y + o, yb);
#pragma unroll
            for (int l = 0; l < V; ++l) {
              if (k[l] != here) continue;
              acc[l] = __fadd_rn(acc[l], Bits<T>::value(d[l]));
              if constexpr (STEM) {
                if (!claimed[l]) yc[l] = Bits<T>::value(yb[l]);
              }
              claimed[l] = true;
            }
          }
        }
      }
      unsigned out[V];
#pragma unroll
      for (int l = 0; l < V; ++l) {
        if constexpr (STEM) {
          const float gf = yc[l] <= 0.f ? 0.f : rnd<T>(acc[l]);
          out[l] = Pack<T>::bits(__fmul_rn(gf, rnd<T>(s[c0 + l])));
        } else {
          out[l] = Pack<T>::bits(acc[l]);
        }
      }
      store<T, V>(dx + (((n * g.T + t) * g.H + h) * g.W + w) * g.C + c0, out);
    }
  }
}

unsigned grid(long long rows) {
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  return static_cast<unsigned>(rows < most ? rows : most);
}

template <typename T, int V, int KT, int KH, int KW, bool SAVE, bool STEM>
cudaError_t launch_window(const T* x, const float* s, const float* b, T* y,
                          uint8_t* offsets, const Geometry& g,
                          cudaStream_t stream) {
  max_pool_cl_kernel<T, V, KT, KH, KW, SAVE, STEM>
      <<<grid(static_cast<long long>(g.B) * g.To * g.Ho), kThreads, 0,
         stream>>>(x, s, b, y, offsets, g);
  return cudaGetLastError();
}

// The port's three windows as template cases, any other with runtime bounds
// (the fused stem: its own window, or runtime bounds).
template <typename T, int V, bool SAVE, bool STEM>
cudaError_t launch_fwd(const T* x, const float* s, const float* b, T* y,
                       uint8_t* offsets, const Geometry& g,
                       cudaStream_t st) {
  if (g.kt == 1 && g.kh == 3 && g.kw == 3) {
    return launch_window<T, V, 1, 3, 3, SAVE, STEM>(x, s, b, y, offsets, g,
                                                    st);
  }
  if constexpr (!STEM) {
    if (g.kt == 2 && g.kh == 1 && g.kw == 1) {
      return launch_window<T, V, 2, 1, 1, SAVE, STEM>(x, s, b, y, offsets, g,
                                                      st);
    }
    if (g.kt == 1 && g.kh == 2 && g.kw == 2) {
      return launch_window<T, V, 1, 2, 2, SAVE, STEM>(x, s, b, y, offsets, g,
                                                      st);
    }
  }
  return launch_window<T, V, 0, 0, 0, SAVE, STEM>(x, s, b, y, offsets, g, st);
}

template <typename T, int V>
cudaError_t launch_fwd_vec(const T* x, const float* s, const float* b, T* y,
                           uint8_t* offsets, const Geometry& g,
                           cudaStream_t st) {
  const bool stem = s != nullptr;
  if (offsets) {
    return stem ? launch_fwd<T, V, true, true>(x, s, b, y, offsets, g, st)
                : launch_fwd<T, V, true, false>(x, s, b, y, offsets, g, st);
  }
  return stem ? launch_fwd<T, V, false, true>(x, s, b, y, offsets, g, st)
              : launch_fwd<T, V, false, false>(x, s, b, y, offsets, g, st);
}

template <typename T, int V>
cudaError_t launch_bwd_vec(const T* dy, const uint8_t* offsets, const T* y,
                           const float* s, T* dx, const Geometry& g,
                           cudaStream_t st) {
  const unsigned blocks = grid(static_cast<long long>(g.B) * g.T * g.H);
  if (s) {
    max_pool_cl_bwd_kernel<T, V, true>
        <<<blocks, kThreads, 0, st>>>(dy, offsets, y, s, dx, g);
  } else {
    max_pool_cl_bwd_kernel<T, V, false>
        <<<blocks, kThreads, 0, st>>>(dy, offsets, y, s, dx, g);
  }
  return cudaGetLastError();
}

// The geometry of the launchers' arguments: dims (B, T, H, W, C) and
// window (kt, kh, kw, st, sh, sw, pt, ph, pw); output sizes in floor mode.
Geometry geometry(const int* dims, const int* window) {
  Geometry g;
  g.B = dims[0];
  g.T = dims[1];
  g.H = dims[2];
  g.W = dims[3];
  g.C = dims[4];
  g.kt = window[0];
  g.kh = window[1];
  g.kw = window[2];
  g.st = window[3];
  g.sh = window[4];
  g.sw = window[5];
  g.pt = window[6];
  g.ph = window[7];
  g.pw = window[8];
  g.To = (g.T + 2 * g.pt - g.kt) / g.st + 1;
  g.Ho = (g.H + 2 * g.ph - g.kh) / g.sh + 1;
  g.Wo = (g.W + 2 * g.pw - g.kw) / g.sw + 1;
  return g;
}

bool empty(const Geometry& g) {
  return g.B <= 0 || g.C <= 0 || g.T <= 0 || g.H <= 0 || g.W <= 0 ||
         g.To <= 0 || g.Ho <= 0 || g.Wo <= 0;
}

template <typename T>
int forward(const void* x, const void* s, const void* b, void* y,
            void* offsets, const int* dims, const int* window, void* stream) {
  const Geometry g = geometry(dims, window);
  if (empty(g)) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xt = static_cast<const T*>(x);
  const auto fs = static_cast<const float*>(s);
  const auto fb = static_cast<const float*>(b);
  const auto yt = static_cast<T*>(y);
  const auto ot = static_cast<uint8_t*>(offsets);
  if (g.C % Pack<T>::V == 0 && aligned(x) && aligned(y) && aligned(offsets)) {
    return launch_fwd_vec<T, Pack<T>::V>(xt, fs, fb, yt, ot, g, st);
  }
  return launch_fwd_vec<T, 1>(xt, fs, fb, yt, ot, g, st);
}

template <typename T>
int backward(const void* dy, const void* offsets, const void* y,
             const void* s, void* dx, const int* dims, const int* window,
             void* stream) {
  const Geometry g = geometry(dims, window);
  if (empty(g)) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto dyt = static_cast<const T*>(dy);
  const auto ot = static_cast<const uint8_t*>(offsets);
  const auto yt = static_cast<const T*>(y);
  const auto fs = static_cast<const float*>(s);
  const auto dxt = static_cast<T*>(dx);
  if (g.C % Pack<T>::V == 0 && aligned(dy) && aligned(offsets) &&
      aligned(y) && aligned(dx)) {
    return launch_bwd_vec<T, Pack<T>::V>(dyt, ot, yt, fs, dxt, g, st);
  }
  return launch_bwd_vec<T, 1>(dyt, ot, yt, fs, dxt, g, st);
}

}  // namespace

// dims: (B, T, H, W, C) of x; window: (kt, kh, kw, st, sh, sw, pt, ph, pw).
// s and b (f32, C): the stem's affine and ReLU before the pool, or both
// null.  offsets (uint8, y's shape): written where not null.
LFB_EXPORT int lfb_max_pool_f32(const void* x, const void* s, const void* b,
                                void* y, void* offsets, const int* dims,
                                const int* window, void* stream) {
  return forward<float>(x, s, b, y, offsets, dims, window, stream);
}

LFB_EXPORT int lfb_max_pool_bf16(const void* x, const void* s, const void* b,
                                 void* y, void* offsets, const int* dims,
                                 const int* window, void* stream) {
  return forward<__nv_bfloat16>(x, s, b, y, offsets, dims, window, stream);
}

// dx (x's shape) from dy and the offsets (y's shape); with the stem's scale
// s, through its ReLU on the pooled y and the affine (y null otherwise).
LFB_EXPORT int lfb_max_pool_bwd_f32(const void* dy, const void* offsets,
                                    const void* y, const void* s, void* dx,
                                    const int* dims, const int* window,
                                    void* stream) {
  return backward<float>(dy, offsets, y, s, dx, dims, window, stream);
}

LFB_EXPORT int lfb_max_pool_bwd_bf16(const void* dy, const void* offsets,
                                     const void* y, const void* s, void* dx,
                                     const int* dims, const int* window,
                                     void* stream) {
  return backward<__nv_bfloat16>(dy, offsets, y, s, dx, dims, window, stream);
}
