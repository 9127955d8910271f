// Legacy-Caffe2 RoIAlign (sampling_ratio 0: adaptive grid ceil(roi/P),
// clipped to [1, 4]) fused with the P x P max-pool of the AVA head, forward
// and backward.  Forward: (B, H, W, C) f32 feature map + (N, 5) f32 rois
// [batch_idx, x1, y1, x2, y2] -> (N, C) f32; replaces
// lfb_tpu/ops/pallas_roi_align.py:_roi_kernel.  Backward: dout (N, C) ->
// d fmap (B, H, W, C) f32; replaces pallas_roi_align.py:_roi_bwd_kernel.
//
// Forward: one CTA per (box, 128-channel chunk).  The box's per-axis sample
// positions (P * 4 entries per axis: corner rows/cols, fractions, validity)
// are computed once into shared memory; each thread then owns one channel and
// walks the bins, reading NHWC rows in channel order, so a warp's loads are
// coalesced.  The op is a data-dependent gather bound by memory latency (each
// box touches at most 49 * 16 * 4 rows of C floats, mostly from L2);
// everything stays in f32, since rounding can flip near-tie max bins.
//
// Backward: one CTA per (batch element, 128-channel chunk) walks every box of
// that batch element in proposal order, so boxes may come in any order and
// each d fmap element has exactly one writer (no atomics; deterministic).
// The TPU expressed the scatter as a transposed one-hot matmul; here each
// thread recomputes its channel's bin means with the forward's code
// (bin_mean), routes the gradient to the FIRST maximal bin in row-major bin
// order (as XLA's select_and_scatter and the TPU kernel do) and scatters
// dout / count times the bilinear weights into its channel of d fmap.
//
// The sample and bin arithmetic uses explicitly rounded intrinsics in the
// order of the plain version (lfb_tpu_torch/ops/roi_align.py), so no
// contracted multiply-add moves a sample across a pixel boundary, and the
// backward's bin means are bit-identical to the forward's.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGrid = 4;
constexpr int kMaxPooled = 16;
constexpr int kAxis = kMaxPooled * kMaxGrid;   // entries per axis

struct Axis {
  int lo[kAxis];
  int hi[kAxis];
  float frac[kAxis];
  bool ok[kAxis];
};

// Sample e = p * kMaxGrid + i of one axis (see roi_align.py:corners).
__device__ void axis_entry(Axis& ax, int e, float start, float bin, int grid,
                           int size) {
  const int p = e / kMaxGrid;
  const int i = e - p * kMaxGrid;
  float v = __fadd_rn(__fadd_rn(start, __fmul_rn((float)p, bin)),
                      __fdiv_rn(__fmul_rn((float)i + 0.5f, bin), (float)grid));
  const bool outside = (v < -1.f) || (v > (float)size);
  v = fmaxf(v, 0.f);
  float lo = floorf(v);
  float hi;
  if (lo >= (float)(size - 1)) {
    lo = (float)(size - 1);
    v = lo;
    hi = lo;
  } else {
    hi = lo + 1.f;
  }
  ax.lo[e] = (int)lo;
  ax.hi[e] = (int)hi;
  ax.frac[e] = __fsub_rn(v, lo);
  ax.ok[e] = !outside && i < grid;
}

struct Box {
  int b, grid_h, grid_w;
  float count;
};

// A box's batch element, adaptive grid and sample count; fills the shared
// per-axis sample tables (needs 64 + pooled * 4 <= blockDim.x threads).  The
// caller synchronises before reading `ys` / `xs`.
__device__ Box load_box(const float* __restrict__ roi, int B, int H, int W,
                        int pooled, float spatial_scale, Axis& ys, Axis& xs) {
  const float x1 = __fmul_rn(roi[1], spatial_scale);
  const float y1 = __fmul_rn(roi[2], spatial_scale);
  const float x2 = __fmul_rn(roi[3], spatial_scale);
  const float y2 = __fmul_rn(roi[4], spatial_scale);
  const float roi_w = fmaxf(__fsub_rn(x2, x1), 1.f);
  const float roi_h = fmaxf(__fsub_rn(y2, y1), 1.f);
  const float bin_w = __fdiv_rn(roi_w, (float)pooled);
  const float bin_h = __fdiv_rn(roi_h, (float)pooled);
  Box box;
  box.b = min(max((int)roi[0], 0), B - 1);
  box.grid_w = (int)fminf(fmaxf(ceilf(bin_w), 1.f), (float)kMaxGrid);
  box.grid_h = (int)fminf(fmaxf(ceilf(bin_h), 1.f), (float)kMaxGrid);
  box.count = (float)(box.grid_h * box.grid_w);
  const int n_axis = pooled * kMaxGrid;
  const int tid = threadIdx.x;
  if (tid < n_axis) axis_entry(ys, tid, y1, bin_h, box.grid_h, H);
  if (tid >= 64 && tid - 64 < n_axis)
    axis_entry(xs, tid - 64, x1, bin_w, box.grid_w, W);
  return box;
}

// Mean of bin (ph, pw) for the channel at `fb` (NHWC, row stride W * C).
__device__ __forceinline__ float bin_mean(const float* __restrict__ fb, int W,
                                          int C, const Axis& ys,
                                          const Axis& xs, const Box& box,
                                          int ph, int pw) {
  float sum = 0.f;
  for (int iy = 0; iy < box.grid_h; ++iy) {
    const int ey = ph * kMaxGrid + iy;
    if (!ys.ok[ey]) continue;
    const float fy = ys.frac[ey];
    const float gy = __fsub_rn(1.f, fy);
    const size_t rlo = (size_t)ys.lo[ey] * W;
    const size_t rhi = (size_t)ys.hi[ey] * W;
    for (int ix = 0; ix < box.grid_w; ++ix) {
      const int ex = pw * kMaxGrid + ix;
      if (!xs.ok[ex]) continue;
      const float fx = xs.frac[ex];
      const float gx = __fsub_rn(1.f, fx);
      const int xl = xs.lo[ex];
      const int xh = xs.hi[ex];
      float val = __fmul_rn(fb[(rlo + xl) * C], __fmul_rn(gy, gx));
      val = __fadd_rn(val, __fmul_rn(fb[(rlo + xh) * C], __fmul_rn(gy, fx)));
      val = __fadd_rn(val, __fmul_rn(fb[(rhi + xl) * C], __fmul_rn(fy, gx)));
      val = __fadd_rn(val, __fmul_rn(fb[(rhi + xh) * C], __fmul_rn(fy, fx)));
      sum = __fadd_rn(sum, val);
    }
  }
  return __fdiv_rn(sum, box.count);
}

__global__ void __launch_bounds__(kThreads)
roi_align_maxpool_kernel(const float* __restrict__ fmap,
                         const float* __restrict__ rois,
                         float* __restrict__ out, int B, int H, int W, int C,
                         int pooled, float spatial_scale) {
  __shared__ Axis ys, xs;
  const int n = blockIdx.y;
  const Box box = load_box(rois + (size_t)n * 5, B, H, W, pooled,
                           spatial_scale, ys, xs);
  __syncthreads();

  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float* fb = fmap + (size_t)box.b * H * W * C + c;
  float best = -CUDART_INF_F;
  for (int ph = 0; ph < pooled; ++ph)
    for (int pw = 0; pw < pooled; ++pw)
      best = fmaxf(best, bin_mean(fb, W, C, ys, xs, box, ph, pw));
  out[(size_t)n * C + c] = best;
}

__global__ void __launch_bounds__(kThreads)
roi_align_maxpool_bwd_kernel(const float* __restrict__ fmap,
                             const float* __restrict__ rois,
                             const float* __restrict__ dout,
                             float* __restrict__ dfmap, int B, int H, int W,
                             int C, int N, int pooled, float spatial_scale) {
  __shared__ Axis ys, xs;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const float* fb = fmap + (size_t)b * H * W * C + c;
  float* db = dfmap + (size_t)b * H * W * C + c;
  for (int n = 0; n < N; ++n) {
    const float* roi = rois + (size_t)n * 5;
    if (min(max((int)roi[0], 0), B - 1) != b) continue;   // uniform per CTA
    __syncthreads();                    // the previous box's readers are done
    const Box box = load_box(roi, B, H, W, pooled, spatial_scale, ys, xs);
    __syncthreads();
    if (c >= C) continue;

    float best = -CUDART_INF_F;
    int arg = 0;
    for (int ph = 0; ph < pooled; ++ph) {
      for (int pw = 0; pw < pooled; ++pw) {
        const float m = bin_mean(fb, W, C, ys, xs, box, ph, pw);
        if (m > best) {                 // strict: the first maximal bin wins
          best = m;
          arg = ph * pooled + pw;
        }
      }
    }
    const int ph = arg / pooled;
    const int pw = arg - ph * pooled;
    const float g = __fdiv_rn(dout[(size_t)n * C + c], box.count);
    for (int iy = 0; iy < box.grid_h; ++iy) {
      const int ey = ph * kMaxGrid + iy;
      if (!ys.ok[ey]) continue;
      const float fy = ys.frac[ey];
      const float gy = __fsub_rn(1.f, fy);
      const size_t rlo = (size_t)ys.lo[ey] * W;
      const size_t rhi = (size_t)ys.hi[ey] * W;
      for (int ix = 0; ix < box.grid_w; ++ix) {
        const int ex = pw * kMaxGrid + ix;
        if (!xs.ok[ex]) continue;
        const float fx = xs.frac[ex];
        const float gx = __fsub_rn(1.f, fx);
        const int xl = xs.lo[ex];
        const int xh = xs.hi[ex];
        float* p = db + (rlo + xl) * C;
        *p = __fadd_rn(*p, __fmul_rn(g, __fmul_rn(gy, gx)));
        p = db + (rlo + xh) * C;
        *p = __fadd_rn(*p, __fmul_rn(g, __fmul_rn(gy, fx)));
        p = db + (rhi + xl) * C;
        *p = __fadd_rn(*p, __fmul_rn(g, __fmul_rn(fy, gx)));
        p = db + (rhi + xh) * C;
        *p = __fadd_rn(*p, __fmul_rn(g, __fmul_rn(fy, fx)));
      }
    }
  }
}

}  // namespace

// pooled <= 16 (checked by the Python wrapper).
LFB_EXPORT int lfb_roi_align_maxpool(const void* fmap, const void* rois,
                                     void* out, int B, int H, int W, int C,
                                     int N, int pooled, float spatial_scale,
                                     void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, N);
  roi_align_maxpool_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fmap), static_cast<const float*>(rois),
      static_cast<float*>(out), B, H, W, C, pooled, spatial_scale);
  return cudaGetLastError();
}

// dfmap must be zeroed by the caller; pooled <= 16 (checked by the wrapper).
LFB_EXPORT int lfb_roi_align_maxpool_bwd(const void* fmap, const void* rois,
                                         const void* dout, void* dfmap, int B,
                                         int H, int W, int C, int N,
                                         int pooled, float spatial_scale,
                                         void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  roi_align_maxpool_bwd_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fmap), static_cast<const float*>(rois),
      static_cast<const float*>(dout), static_cast<float*>(dfmap), B, H, W, C,
      N, pooled, spatial_scale);
  return cudaGetLastError();
}
