// Legacy-Caffe2 RoIAlign (sampling_ratio 0: adaptive grid ceil(roi/P),
// clipped to [1, 4]) fused with the P x P max-pool of the AVA head, forward
// and backward.  Forward: (B, H, W, C) f32 feature map + (N, 5) f32 rois
// [batch_idx, x1, y1, x2, y2] -> (N, C) f32; replaces
// lfb_tpu/ops/pallas_roi_align.py:_fwd_call (kernel _roi_kernel).  Backward:
// dout (N, C) -> d fmap (B, H, W, C) f32, each (box, channel) gradient
// routed through the box's FIRST maximal bin in row-major order; replaces
// pallas_roi_align.py:_bwd_call (kernel _roi_bwd_kernel).
//
// What bounds it on an H100: bytes.  A box costs a few hundred f32
// operations per channel, so the least time is the map pixels the boxes
// reach, read once, and in the backward the whole d fmap written once.  A
// design that walks each box from global memory instead reaches a pixel once
// per box, sample and corner (up to 3,136 loads per box and channel) and is
// bound by the latency of those loads.
//
// What the design does about it: one CTA of 256 threads per (batch element
// b, chunk of Cc channels), in both kernels.
// - The CTA starts the copy of its H x W x Cc slice of the map into shared
//   memory first thing (16-byte cp.async; plain loads when C is not a
//   multiple of 4), so each pixel leaves L2 or device memory once however
//   many boxes reach it, and the roi scan and the tables below are built
//   while the copy is in flight.  The wrapper picks Cc (64 down to 8) so
//   the slice fits, and refuses a map whose slice does not fit at Cc = 8.
// - The CTA scans the rois itself and keeps those whose clamped batch index
//   is b, in proposal order (a ballot compaction of 256 rois at a time):
//   the wrapper does not sort and nothing waits on the host.
// - Per batch of up to 4 of its boxes, one thread per sample builds their
//   per-axis sample tables in shared memory (build_tables): for each bin
//   row and column, the samples that lie inside the map, in order, with
//   their neighbours and weights, so the sample loop has no bounds or
//   validity test.
// - The threads split the batch's (box, bin) pairs as (8 channels: the
//   float4 quads q and q + Cc / 8; group), so every group gets about as
//   many bins, and sum each bin's samples from shared memory.  The
//   forward keeps the largest sum: divided once by the sample count it is
//   the max of the bin means bit for bit, since the rounded division is
//   monotonic, so it divides once per output instead of once per bin.  Warp
//   shuffles merge the groups of a warp; after one barrier, thread (box,
//   channel) merges the warps' maxima and writes that row of (N, C).
// - Backward: one buffer holds the map slice while a batch's bins are
//   formed, then the slice of d fmap (zeroed) while the batch scatters.  The
//   first max is over the bin means, formed as the plain version forms them
//   (one division per bin), ties going to the lower bin through the
//   shuffles and the merge, so the first maximal bin in row-major order
//   wins, as in XLA's select_and_scatter and the TPU kernel.  Then thread c
//   takes channel c, box by box in proposal order, and adds dout / count
//   times the bilinear weights of its bin's samples: one writer per element
//   in a fixed order, no atomics, the result repeatable bit for bit; each
//   sample's four corners are read at once and written back once.  The
//   slice leaves as one write of d fmap with 16-byte stores, so d fmap
//   needs no zero fill: a batch element that no box reaches writes its
//   zeros from its own CTA.  With more than 4 boxes on b, each later batch
//   stages the map again and picks d fmap's slice up where the last one
//   wrote it (this CTA is its only writer).
//
// The sample and bin arithmetic uses explicitly rounded intrinsics in the
// order of the plain version (lfb_tpu_torch/ops/roi_align.py), so no
// contracted multiply-add moves a sample across a pixel boundary, and the
// backward's bin means are bit-identical to the forward's.  The TPU's
// T = Q @ select product is not used: it reorders the sums, and a near-tie
// bin could then flip the argmax against the plain version.  No tensor
// cores or TF32: the work is bytes, and f32 exactness decides the max.
#include <math_constants.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 4;
constexpr int kBoxes = 4;                      // boxes whose tables build at once
constexpr int kV = 2;                          // float4 quads a thread

// The sample tables of kBoxes boxes, in dynamic shared memory, for bin rows
// (axis 0) and columns (axis 1) of P bins: bin p of axis a of box k keeps
// its samples that lie inside [-1, size], in sample order, at
// e[((k * 2 + a) * P + p) * kMaxGrid + j] for j < n[(k * 2 + a) * P + p]:
// {the low and the high neighbour, as int bits (rows: the pixel row; columns:
// the column's offset in float4s, column << lq); frac; 1 - frac}; count[k]
// is the box's samples per bin.
struct Tables {
  float4* e;
  int* n;
  float* count;
};

size_t table_bytes(int pooled) {
  return kBoxes * (2 * pooled * (kMaxGrid * sizeof(float4) + sizeof(int)) +
                   sizeof(float));
}

__device__ Tables tables_at(void* p, int pooled) {
  Tables t;
  t.e = static_cast<float4*>(p);
  t.n = reinterpret_cast<int*>(t.e + kBoxes * 2 * pooled * kMaxGrid);
  t.count = reinterpret_cast<float*>(t.n + kBoxes * 2 * pooled);
  return t;
}

// The tables of the nb <= kBoxes boxes rois[boxes[k]], one thread per
// (box, axis, bin, sample); a ballot keeps each bin's samples inside the
// map in order (see roi_align.py:coords / corners for the arithmetic).
__device__ void build_tables(const float* __restrict__ rois, const int* boxes,
                             int nb, int H, int W, int pooled,
                             float spatial_scale, int lq, Tables t) {
  const int per_box = 2 * pooled * kMaxGrid;
  const int lane = threadIdx.x & 31;
  for (int e0 = 0; e0 < nb * per_box; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    const bool live = e < nb * per_box;
    const int k = e / per_box;
    const int a = (e - k * per_box) / (pooled * kMaxGrid);   // 0 rows, 1 cols
    const int p = ((e - k * per_box) >> 2) - a * pooled;
    const int i = e & (kMaxGrid - 1);
    bool ok = false;
    float4 entry = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      const float* roi = rois + (size_t)boxes[k] * 5;
      const float start = __fmul_rn(roi[2 - a], spatial_scale);
      const float bin = __fdiv_rn(
          fmaxf(__fsub_rn(__fmul_rn(roi[4 - a], spatial_scale), start), 1.f),
          (float)pooled);
      const int grid = (int)fminf(fmaxf(ceilf(bin), 1.f), (float)kMaxGrid);
      const int size = a == 0 ? H : W;
      float v = __fadd_rn(__fadd_rn(start, __fmul_rn((float)p, bin)),
                          __fdiv_rn(__fmul_rn((float)i + 0.5f, bin),
                                    (float)grid));
      ok = i < grid && !((v < -1.f) || (v > (float)size));
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
      const int stride = a == 0 ? 1 : 1 << lq;
      const float frac = __fsub_rn(v, lo);
      entry = make_float4(__int_as_float((int)lo * stride),
                          __int_as_float((int)hi * stride), frac,
                          __fsub_rn(1.f, frac));
      if (a == 0 && p == 0 && i == 0) {
        const float bin_w = __fdiv_rn(
            fmaxf(__fsub_rn(__fmul_rn(roi[3], spatial_scale),
                            __fmul_rn(roi[1], spatial_scale)), 1.f),
            (float)pooled);
        t.count[k] = (float)(grid * (int)fminf(fmaxf(ceilf(bin_w), 1.f),
                                               (float)kMaxGrid));
      }
    }
    // Lanes 4m..4m+3 hold the samples of one bin.
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    const unsigned bin_mask = 0xfu << (lane & ~3);
    const int slot = (e >> 2) * kMaxGrid;
    if (ok) t.e[slot + __popc(mask & bin_mask & ((1u << lane) - 1u))] = entry;
    if (live && i == 0) t.n[e >> 2] = __popc(mask & bin_mask);
  }
}

// The rois in [base, base + kThreads) whose clamped batch index is b, in
// proposal order, into `list`; returns their count (the same in every
// thread).
__device__ int boxes_of(const float* __restrict__ rois, int base, int N,
                        int B, int b, int* list, int* warp_counts) {
  const int n = base + threadIdx.x;
  const bool mine = n < N && min(max((int)rois[(size_t)n * 5], 0), B - 1) == b;
  const unsigned ballot = __ballot_sync(0xffffffffu, mine);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                  // the previous chunk's list is read
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0, count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    offset += w < warp ? c : 0;
    count += c;
  }
  if (mine) list[offset + __popc(ballot & ((1u << lane) - 1u))] = n;
  __syncthreads();
  return count;
}

// Stage channels [c0, c0 + valid) of the (H * W, C) map `src` into `dst`,
// [H * W][nq] float4 (nq = 1 << lq quads, Cc = 4 * nq channels a pixel);
// channels past `valid` read 0.  kVec: 16-byte cp.async (C % 4 == 0 and a
// 16-byte aligned map); the caller waits with cp_async_wait<0>().
template <bool kVec>
__device__ void stage_slice(float4* dst, const float* __restrict__ src,
                            int HW, int C, int c0, int valid, int lq) {
  const int nq = 1 << lq;
  for (int i = threadIdx.x; i < (HW << lq); i += kThreads) {
    const int c = (i & (nq - 1)) * 4;
    const float* p = src + (size_t)(i >> lq) * C + c0 + c;
    if (kVec) {
      lfb::cp_async_16(dst + i, c < valid ? p : src, c < valid);
    } else {
      dst[i] = make_float4(c < valid ? p[0] : 0.f, c + 1 < valid ? p[1] : 0.f,
                           c + 2 < valid ? p[2] : 0.f,
                           c + 3 < valid ? p[3] : 0.f);
    }
  }
  if (kVec) lfb::cp_async_commit();
}

// Write the [H * W][nq] slice `src` (or zeros) to channels [0, valid) of
// the (H * W, C) map at `dst`; kVec: 16-byte stores.
template <bool kVec>
__device__ void write_slice(float* dst, const float4* src, int HW, int C,
                            int valid, int lq, bool zeros) {
  const int nq = 1 << lq;
  for (int i = threadIdx.x; i < (HW << lq); i += kThreads) {
    const float4 val = zeros ? make_float4(0.f, 0.f, 0.f, 0.f) : src[i];
    const int c = (i & (nq - 1)) * 4;
    float* p = dst + (size_t)(i >> lq) * C + c;
    if (kVec) {
      if (c < valid) *reinterpret_cast<float4*>(p) = val;
    } else {
      if (c < valid) p[0] = val.x;
      if (c + 1 < valid) p[1] = val.y;
      if (c + 2 < valid) p[2] = val.z;
      if (c + 3 < valid) p[3] = val.w;
    }
  }
}

// One bilinear sample: the four corners times their weights, in the plain
// version's order.
__device__ __forceinline__ float sample(float ll, float lh, float hl, float hh,
                                        const float4& wt) {
  float val = __fmul_rn(ll, wt.x);
  val = __fadd_rn(val, __fmul_rn(lh, wt.y));
  val = __fadd_rn(val, __fmul_rn(hl, wt.z));
  return __fadd_rn(val, __fmul_rn(hh, wt.w));
}

// One box's tables: rows ye / yn, columns xe / xn.
struct BoxTables {
  const float4* ye;
  const int* yn;
  const float4* xe;
  const int* xn;
};

__device__ __forceinline__ BoxTables box_tables(const Tables& t, int k,
                                                int pooled) {
  const float4* ye = t.e + 2 * k * pooled * kMaxGrid;
  const int* yn = t.n + 2 * k * pooled;
  return BoxTables{ye, yn, ye + pooled * kMaxGrid, yn + pooled};
}

// Sums of bin (ph, pw)'s samples for the kV float4s of channels at quads q
// and q + half (`s` is the slice at quad q, `half` = nq / 2, so a
// quarter-warp's loads stay on 128 contiguous bytes); `row` is a pixel
// row's length in float4s (W << lq).  The samples are added in the plain
// version's (iy, ix) order; the bin's mean is the sum / count.
__device__ __forceinline__ void bin_sum(float4 (&sum)[kV],
                                        const float4* __restrict__ s, int half,
                                        int row, const BoxTables& bt, int ph,
                                        int pw) {
#pragma unroll
  for (int v = 0; v < kV; ++v) sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ny = bt.yn[ph];
  const int nx = bt.xn[pw];
  for (int iy = 0; iy < ny; ++iy) {
    const float4 ty = bt.ye[ph * kMaxGrid + iy];
    const float4* rlo = s + __float_as_int(ty.x) * row;
    const float4* rhi = s + __float_as_int(ty.y) * row;
    for (int ix = 0; ix < nx; ++ix) {
      const float4 tx = bt.xe[pw * kMaxGrid + ix];
      const int xl = __float_as_int(tx.x);
      const int xh = __float_as_int(tx.y);
      // ty.w, tx.w = 1 - frac (gy, gx); ty.z, tx.z = frac (fy, fx).
      const float4 wt = make_float4(__fmul_rn(ty.w, tx.w), __fmul_rn(ty.w, tx.z),
                                    __fmul_rn(ty.z, tx.w), __fmul_rn(ty.z, tx.z));
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float4 a = rlo[xl + v * half];
        const float4 b = rlo[xh + v * half];
        const float4 c = rhi[xl + v * half];
        const float4 d = rhi[xh + v * half];
        sum[v].x = __fadd_rn(sum[v].x, sample(a.x, b.x, c.x, d.x, wt));
        sum[v].y = __fadd_rn(sum[v].y, sample(a.y, b.y, c.y, d.y, wt));
        sum[v].z = __fadd_rn(sum[v].z, sample(a.z, b.z, c.z, d.z, wt));
        sum[v].w = __fadd_rn(sum[v].w, sample(a.w, b.w, c.w, d.w, wt));
      }
    }
  }
}

// dout / count (g) times the bilinear weights of bin (ph, pw)'s samples,
// added into one channel of the accumulator (`acc` at that channel; `row`
// a pixel row's length in floats, columns' offsets 4 x the table's).  The
// terms reach each element in the serial order (sample row, sample column,
// corner); a sample's four corners are read at once and written back once,
// the border cases where two corners are one element (lo == hi or xl ==
// xh) taken in that order.
__device__ __forceinline__ void scatter_bin(float* acc, int row,
                                            const BoxTables& bt, int ph,
                                            int pw, float g) {
  for (int iy = 0; iy < bt.yn[ph]; ++iy) {
    const float4 ty = bt.ye[ph * kMaxGrid + iy];
    const int lo = __float_as_int(ty.x);
    const int hi = __float_as_int(ty.y);
    const bool sy = lo == hi;
    float* rlo = acc + lo * row;
    float* rhi = acc + hi * row;
    for (int ix = 0; ix < bt.xn[pw]; ++ix) {
      const float4 tx = bt.xe[pw * kMaxGrid + ix];
      const int xl = 4 * __float_as_int(tx.x);
      const int xh = 4 * __float_as_int(tx.y);
      const bool sx = xl == xh;
      const float t00 = __fmul_rn(g, __fmul_rn(ty.w, tx.w));
      const float t01 = __fmul_rn(g, __fmul_rn(ty.w, tx.z));
      const float t10 = __fmul_rn(g, __fmul_rn(ty.z, tx.w));
      const float t11 = __fmul_rn(g, __fmul_rn(ty.z, tx.z));
      float v00 = rlo[xl], v01 = rlo[xh], v10 = rhi[xl], v11 = rhi[xh];
      v00 = __fadd_rn(v00, t00);
      if (sx) v00 = __fadd_rn(v00, t01); else v01 = __fadd_rn(v01, t01);
      if (sy) {
        if (sx) {
          v00 = __fadd_rn(__fadd_rn(v00, t10), t11);
        } else {
          v00 = __fadd_rn(v00, t10);
          v01 = __fadd_rn(v01, t11);
        }
      } else {
        v10 = __fadd_rn(v10, t10);
        if (sx) v10 = __fadd_rn(v10, t11); else v11 = __fadd_rn(v11, t11);
      }
      rlo[xl] = v00;
      if (!sx) rlo[xh] = v01;
      if (!sy) {
        rhi[xl] = v10;
        if (!sx) rhi[xh] = v11;
      }
    }
  }
}

__device__ __forceinline__ float4 fmax4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// (mean, bin) pairs: the larger mean wins, the lower bin on a tie, so the
// first maximal bin in row-major order comes out whatever the split.
__device__ __forceinline__ void take_max(float& v, int& j, float u, int k) {
  if (u > v || (u == v && k < j)) {
    v = u;
    j = k;
  }
}

template <typename T>
__device__ __forceinline__ T shfl_xor4(T v, int o) {
  v.x = __shfl_xor_sync(0xffffffffu, v.x, o);
  v.y = __shfl_xor_sync(0xffffffffu, v.y, o);
  v.z = __shfl_xor_sync(0xffffffffu, v.z, o);
  v.w = __shfl_xor_sync(0xffffffffu, v.w, o);
  return v;
}

// Dynamic shared memory: the slice of H * W pixels x Cc channels, each
// warp's partials for kBoxes boxes (forward: a max sum per channel;
// backward: a mean and its bin), then the tables.  The wrapper's
// cuda_roi_align.smem_bytes mirrors these.
size_t fwd_smem(int HW, int cc, int pooled) {
  return (size_t)cc * (HW + kBoxes * kWarps) * sizeof(float) +
         table_bytes(pooled);
}
size_t bwd_smem(int HW, int cc, int pooled) {
  return (size_t)cc * (HW + 2 * kBoxes * kWarps) * sizeof(float) +
         table_bytes(pooled);
}

// The bins of a batch of nb boxes, as nb * P^2 (box, bin) pairs: thread
// (quads q and q + nq / 2, group g) takes the pairs
// g, g + groups, ..., so the bins of all the batch's boxes spread evenly,
// and keeps per box the max (forward) or the first max (backward) of its
// share; warp shuffles merge the groups of a warp into the partials of box
// k, [k][warp][quad].  The first bin of box k that group g takes:
// (g - k * P^2) mod groups (groups is a power of 2).
__device__ __forceinline__ int first_bin(int group, int groups, int k,
                                         int pp) {
  return (group - k * pp) & (groups - 1);
}

// Each CTA copies its slice first thing, so the roi scan and the tables
// are built while the copy is in flight.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
roi_align_maxpool_kernel(const float* __restrict__ fmap,
                         const float* __restrict__ rois,
                         float* __restrict__ out, int B, int H, int W, int C,
                         int N, int pooled, float spatial_scale, int lq) {
  extern __shared__ float4 smem[];
  __shared__ int list[kThreads], warp_counts[kWarps];
  const int HW = H * W;
  const int nq = 1 << lq;
  const int cc = 4 * nq;
  const int half = nq / 2;
  const int lt = lq - 1;                          // threads per pixel: 1 << lt
  const int pp = pooled * pooled;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cc;
  const int valid = min(cc, C - c0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = tid & ((1 << lt) - 1);
  const int group = tid >> lt;
  const int groups = kThreads >> lt;
  float4* slice = smem;                           // [HW][nq]
  float4* partial = slice + (HW << lq);           // [kBoxes][kWarps][nq]
  const Tables t = tables_at(partial + kBoxes * kWarps * nq, pooled);

  stage_slice<kVec>(slice, fmap + (size_t)b * HW * C, HW, C, c0, valid, lq);
  bool waited = false;
  for (int base = 0; base < N; base += kThreads) {
    const int count = boxes_of(rois, base, N, B, b, list, warp_counts);
    for (int k0 = 0; k0 < count; k0 += kBoxes) {
      const int nb = min(kBoxes, count - k0);
      __syncthreads();                  // the previous batch is written out
      build_tables(rois, list + k0, nb, H, W, pooled, spatial_scale, lq, t);
      if (kVec && !waited) lfb::cp_async_wait<0>();
      waited = true;
      __syncthreads();
      for (int k = 0; k < nb; ++k) {
        const BoxTables bt = box_tables(t, k, pooled);
        // The max of the bin sums; dividing once by the count gives the max
        // of the bin means, bit for bit (the rounding is monotonic).
        float4 best[kV];
#pragma unroll
        for (int v = 0; v < kV; ++v)
          best[v] = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                                -CUDART_INF_F);
        for (int j = first_bin(group, groups, k, pp); j < pp; j += groups) {
          const int ph = j / pooled;
          float4 sum[kV];
          bin_sum(sum, slice + q, half, W << lq, bt, ph, j - ph * pooled);
#pragma unroll
          for (int v = 0; v < kV; ++v) best[v] = fmax4(best[v], sum[v]);
        }
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          for (int o = 1 << lt; o < 32; o <<= 1)
            best[v] = fmax4(best[v], shfl_xor4(best[v], o));
          if (lane < (1 << lt))
            partial[(k * kWarps + (tid >> 5)) * nq + q + v * half] = best[v];
        }
      }
      __syncthreads();
      // Thread (box k, channel ch) merges the warps' maxima.
      for (int i = tid; i < nb * cc; i += kThreads) {
        const int k = i >> (lq + 2);
        const int ch = i & (cc - 1);
        if (ch >= valid) continue;
        const float* pf = reinterpret_cast<const float*>(
            partial + k * kWarps * nq) + ch;
        float v = pf[0];
        for (int w = 1; w < kWarps; ++w) v = fmaxf(v, pf[w * cc]);
        out[(size_t)list[k0 + k] * C + c0 + ch] = __fdiv_rn(v, t.count[k]);
      }
    }
  }
  if (kVec && !waited) lfb::cp_async_wait<0>();   // no box: drain the copy
}

// One buffer holds the map slice while a batch's bins are formed, then the
// slice of d fmap while the batch scatters.  With more than kBoxes boxes on
// b, each later batch stages the map again and picks up d fmap's slice
// where the last one wrote it (this CTA is its only writer).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
roi_align_maxpool_bwd_kernel(const float* __restrict__ fmap,
                             const float* __restrict__ rois,
                             const float* __restrict__ dout,
                             float* __restrict__ dfmap, int B, int H, int W,
                             int C, int N, int pooled, float spatial_scale,
                             int lq) {
  extern __shared__ float4 smem[];
  __shared__ int list[kThreads], warp_counts[kWarps];
  __shared__ float grads[kBoxes * 64];          // dout / count, [k][ch]
  const int HW = H * W;
  const int nq = 1 << lq;
  const int cc = 4 * nq;
  const int half = nq / 2;
  const int lt = lq - 1;                          // threads per pixel: 1 << lt
  const int pp = pooled * pooled;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cc;
  const int valid = min(cc, C - c0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = tid & ((1 << lt) - 1);
  const int group = tid >> lt;
  const int groups = kThreads >> lt;
  float4* buf = smem;                             // [HW][nq]
  float4* part_val = buf + (HW << lq);            // [kBoxes][kWarps][nq]
  int4* part_bin = reinterpret_cast<int4*>(part_val + kBoxes * kWarps * nq);
  const Tables t = tables_at(part_bin + kBoxes * kWarps * nq, pooled);
  const size_t offset = (size_t)b * HW * C;
  float* dst = dfmap + offset + c0;

  stage_slice<kVec>(buf, fmap + offset, HW, C, c0, valid, lq);
  bool first = true;                    // no batch scattered yet
  for (int base = 0; base < N; base += kThreads) {
    const int count = boxes_of(rois, base, N, B, b, list, warp_counts);
    for (int k0 = 0; k0 < count; k0 += kBoxes) {
      const int nb = min(kBoxes, count - k0);
      __syncthreads();                  // the previous batch is written out
      if (!first) stage_slice<kVec>(buf, fmap + offset, HW, C, c0, valid, lq);
      build_tables(rois, list + k0, nb, H, W, pooled, spatial_scale, lq, t);
      // This batch's dout, loaded now and stored after the bins.
      const int gk = tid >> (lq + 2);
      const int gc = tid & (cc - 1);
      const float d = gk < nb && gc < valid
          ? dout[(size_t)list[k0 + gk] * C + c0 + gc] : 0.f;
      if (kVec) lfb::cp_async_wait<0>();
      __syncthreads();
      for (int k = 0; k < nb; ++k) {
        const BoxTables bt = box_tables(t, k, pooled);
        const float box_count = t.count[k];
        // The first maximal bin mean of this thread's share, per channel,
        // then of its warp's (the means, as the plain version compares
        // them: one division per bin).
        const int j0 = first_bin(group, groups, k, pp);
        float4 best[kV];
        int4 arg[kV];
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          best[v] = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                                -CUDART_INF_F);
          arg[v] = make_int4(j0, j0, j0, j0);
        }
        for (int j = j0; j < pp; j += groups) {
          const int ph = j / pooled;
          float4 sum[kV];
          bin_sum(sum, buf + q, half, W << lq, bt, ph, j - ph * pooled);
#pragma unroll
          for (int v = 0; v < kV; ++v) {   // strict >: the first max wins
            take_max(best[v].x, arg[v].x, __fdiv_rn(sum[v].x, box_count), j);
            take_max(best[v].y, arg[v].y, __fdiv_rn(sum[v].y, box_count), j);
            take_max(best[v].z, arg[v].z, __fdiv_rn(sum[v].z, box_count), j);
            take_max(best[v].w, arg[v].w, __fdiv_rn(sum[v].w, box_count), j);
          }
        }
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          for (int o = 1 << lt; o < 32; o <<= 1) {
            const float4 u = shfl_xor4(best[v], o);
            const int4 a = shfl_xor4(arg[v], o);
            take_max(best[v].x, arg[v].x, u.x, a.x);
            take_max(best[v].y, arg[v].y, u.y, a.y);
            take_max(best[v].z, arg[v].z, u.z, a.z);
            take_max(best[v].w, arg[v].w, u.w, a.w);
          }
          if (lane < (1 << lt)) {
            const int at = (k * kWarps + (tid >> 5)) * nq + q + v * half;
            part_val[at] = best[v];
            part_bin[at] = arg[v];
          }
        }
      }
      if (gk < nb) grads[gk * cc + gc] = __fdiv_rn(d, t.count[gk]);
      __syncthreads();                  // the map slice is read
      // The buffer takes d fmap's slice: zeros, or what earlier batches
      // wrote.
      for (int i = tid; i < (HW << lq); i += kThreads) {
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!first) {
          const int c = (i & (nq - 1)) * 4;
          const float* p = dst + (size_t)(i >> lq) * C + c;
          if (kVec) {
            if (c < valid) val = *reinterpret_cast<const float4*>(p);
          } else {
            val = make_float4(c < valid ? p[0] : 0.f,
                              c + 1 < valid ? p[1] : 0.f,
                              c + 2 < valid ? p[2] : 0.f,
                              c + 3 < valid ? p[3] : 0.f);
          }
        }
        buf[i] = val;
      }
      __syncthreads();
      if (tid < valid) {
        // Channel tid, box by box in proposal order: the first maximal bin
        // over the warps (ties to the lower bin), then its samples' terms.
        float* accf = reinterpret_cast<float*>(buf) + tid;
        for (int k = 0; k < nb; ++k) {
          const float* pv = reinterpret_cast<const float*>(
              part_val + k * kWarps * nq) + tid;
          const int* pb = reinterpret_cast<const int*>(
              part_bin + k * kWarps * nq) + tid;
          float v = pv[0];
          int bin = pb[0];
          for (int w = 1; w < kWarps; ++w) take_max(v, bin, pv[w * cc], pb[w * cc]);
          const int ph = bin / pooled;
          scatter_bin(accf, 4 * (W << lq), box_tables(t, k, pooled), ph,
                      bin - ph * pooled, grads[k * cc + tid]);
        }
      }
      __syncthreads();                  // the batch is scattered
      write_slice<kVec>(dst, buf, HW, C, valid, lq, false);
      first = false;
    }
  }
  if (first) {                          // no box reaches b: zeros
    if (kVec) lfb::cp_async_wait<0>();  // drain the unused copy
    write_slice<kVec>(dst, buf, HW, C, valid, lq, true);
  }
}

// log2(chunk / 4) for chunk in {8, 16, 32, 64}, else -1.
int quad_shift(int chunk) {
  for (int lq = 1; lq <= 4; ++lq)
    if (chunk == 4 << lq) return lq;
  return -1;
}

}  // namespace

// pooled <= 16 (checked by the Python wrapper); `chunk` channels per CTA
// (8, 16, 32 or 64); `vec`: C % 4 == 0 and fmap 16-byte aligned.
LFB_EXPORT int lfb_roi_align_maxpool(const void* fmap, const void* rois,
                                     void* out, int B, int H, int W, int C,
                                     int N, int pooled, float spatial_scale,
                                     int chunk, int vec, void* stream) {
  const int lq = quad_shift(chunk);
  if (lq < 0 || pooled < 1 || pooled > 16) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem(H * W, chunk, pooled);
  auto kernel = vec ? roi_align_maxpool_kernel<true>
                    : roi_align_maxpool_kernel<false>;
  const cudaError_t err = lfb::allow_smem(kernel, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // leave no error behind for others
    return err;
  }
  const dim3 grid((C + chunk - 1) / chunk, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fmap), static_cast<const float*>(rois),
      static_cast<float*>(out), B, H, W, C, N, pooled, spatial_scale, lq);
  return cudaGetLastError();
}

// Writes every element of dfmap (no zero fill needed); arguments as above.
LFB_EXPORT int lfb_roi_align_maxpool_bwd(const void* fmap, const void* rois,
                                         const void* dout, void* dfmap, int B,
                                         int H, int W, int C, int N,
                                         int pooled, float spatial_scale,
                                         int chunk, int vec, void* stream) {
  const int lq = quad_shift(chunk);
  if (lq < 0 || pooled < 1 || pooled > 16) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(H * W, chunk, pooled);
  auto kernel = vec ? roi_align_maxpool_bwd_kernel<true>
                    : roi_align_maxpool_bwd_kernel<false>;
  const cudaError_t err = lfb::allow_smem(kernel, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // leave no error behind for others
    return err;
  }
  const dim3 grid((C + chunk - 1) / chunk, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fmap), static_cast<const float*>(rois),
      static_cast<const float*>(dout), static_cast<float*>(dfmap), B, H, W, C,
      N, pooled, spatial_scale, lq);
  return cudaGetLastError();
}
