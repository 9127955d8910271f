// Legacy-Caffe2 RoIAlign (sampling_ratio 0: adaptive grid ceil(roi/P),
// clipped to [1, 4]) fused with the P x P max-pool of the AVA head:
// (B, H, W, C) f32 feature map + (N, 5) f32 rois [batch_idx, x1, y1, x2, y2]
// -> (N, C) f32.  Replaces lfb_tpu/ops/pallas_roi_align.py:_roi_kernel.
//
// One CTA per (box, 128-channel chunk).  The box's per-axis sample positions
// (P * 4 entries per axis: corner rows/cols, fractions, validity) are computed
// once into shared memory; each thread then owns one channel and walks the
// bins, reading NHWC rows in channel order, so a warp's loads are coalesced.
// The op is a data-dependent gather bound by memory latency (each box touches
// at most 49 * 16 * 4 rows of C floats, mostly from L2); everything stays in
// f32, since rounding can flip near-tie max bins.
//
// The sample arithmetic uses explicitly rounded intrinsics in the order of
// the plain version (lfb_tpu_torch/ops/roi_align.py), so no fused
// multiply-add moves a sample across a pixel boundary.
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

__global__ void __launch_bounds__(kThreads)
roi_align_maxpool_kernel(const float* __restrict__ fmap,
                         const float* __restrict__ rois,
                         float* __restrict__ out, int B, int H, int W, int C,
                         int pooled, float spatial_scale) {
  __shared__ Axis ys, xs;
  const int n = blockIdx.y;
  const float* roi = rois + (size_t)n * 5;
  const int b = min(max((int)roi[0], 0), B - 1);
  const float x1 = __fmul_rn(roi[1], spatial_scale);
  const float y1 = __fmul_rn(roi[2], spatial_scale);
  const float x2 = __fmul_rn(roi[3], spatial_scale);
  const float y2 = __fmul_rn(roi[4], spatial_scale);
  const float roi_w = fmaxf(__fsub_rn(x2, x1), 1.f);
  const float roi_h = fmaxf(__fsub_rn(y2, y1), 1.f);
  const float bin_w = __fdiv_rn(roi_w, (float)pooled);
  const float bin_h = __fdiv_rn(roi_h, (float)pooled);
  const int grid_w = (int)fminf(fmaxf(ceilf(bin_w), 1.f), (float)kMaxGrid);
  const int grid_h = (int)fminf(fmaxf(ceilf(bin_h), 1.f), (float)kMaxGrid);
  const int n_axis = pooled * kMaxGrid;

  const int tid = threadIdx.x;
  if (tid < n_axis) axis_entry(ys, tid, y1, bin_h, grid_h, H);
  if (tid >= 64 && tid - 64 < n_axis) axis_entry(xs, tid - 64, x1, bin_w, grid_w, W);
  __syncthreads();

  const int c = blockIdx.x * kThreads + tid;
  if (c >= C) return;
  const float* fb = fmap + (size_t)b * H * W * C + c;
  const float count = (float)(grid_h * grid_w);
  float best = -CUDART_INF_F;
  for (int ph = 0; ph < pooled; ++ph) {
    for (int pw = 0; pw < pooled; ++pw) {
      float sum = 0.f;
      for (int iy = 0; iy < grid_h; ++iy) {
        const int ey = ph * kMaxGrid + iy;
        if (!ys.ok[ey]) continue;
        const float fy = ys.frac[ey];
        const size_t rlo = (size_t)ys.lo[ey] * W;
        const size_t rhi = (size_t)ys.hi[ey] * W;
        for (int ix = 0; ix < grid_w; ++ix) {
          const int ex = pw * kMaxGrid + ix;
          if (!xs.ok[ex]) continue;
          const float fx = xs.frac[ex];
          const int xl = xs.lo[ex];
          const int xh = xs.hi[ex];
          const float v_ll = fb[(rlo + xl) * C];
          const float v_lh = fb[(rlo + xh) * C];
          const float v_hl = fb[(rhi + xl) * C];
          const float v_hh = fb[(rhi + xh) * C];
          sum += v_ll * ((1.f - fy) * (1.f - fx)) + v_lh * ((1.f - fy) * fx) +
                 v_hl * (fy * (1.f - fx)) + v_hh * (fy * fx);
        }
      }
      best = fmaxf(best, sum / count);
    }
  }
  out[(size_t)n * C + c] = best;
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
