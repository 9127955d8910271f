// Warp-level bf16 tensor-core building blocks for the attention kernels:
// cp.async copies into shared memory, ldmatrix fragment loads and
// mma.sync.aligned.m16n8k16 (bf16 x bf16 -> f32).
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of 2 bf16: a0 (row g, k 2t..2t+1),
//     a1 (row g + 8, k 2t..), a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..).
//   B (16 x 8, k x n), 2 registers: b0 (k 2t..2t+1, col g), b1 (k 2t + 8.., col g).
//   C/D (16 x 8, f32), 4 floats: c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row
//     g + 8, the same cols).
// So the accumulators of two neighbouring n-tiles (cols 0-7 and 8-15), packed
// to bf16 pairs, are exactly the A fragment of a 16-deep k chunk: a score
// tile S becomes the A operand of P.V without a trip through shared memory
// (pack_a below).
//
// Shared-memory tiles are row-major with a row stride of (width + 8) bf16:
// the 16-byte pad shifts each row by four banks, so the eight row addresses
// of one ldmatrix 8 x 8 matrix fall in eight different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace lfb {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills the destination when !valid (src
// must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives matrix i at (row g, cols 2t, 2t + 1), or with
// .trans at (rows 2t, 2t + 1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two matrices (lanes 0-15 give the row addresses): the b0, b1 of one
// n-tile whose n index is the tile's row.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on the tensor cores.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k chunk kc from f32 accumulators c[n][4] (n-tiles 2 kc
// and 2 kc + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Lane addresses into a row-major tile `base` with row stride `ld`:
//  * a_frag: the A fragment of rows r0..r0+15, k k0..k0+15 (ldsm_x4).
//  * b_frag: the B fragments of two n-tiles whose n index is the tile's row
//    (rows n0..n0+15) and whose k index is its column (k0..k0+15), as K in
//    Q K^T (ldsm_x4: b0, b1 of rows n0..n0+7, then of n0+8..n0+15).
//  * bt_frag: the B fragments of two n-tiles whose k index is the tile's row
//    (k0..k0+15) and whose n index is its column (n0..n0+15), as V in P V
//    (ldsm_x4_trans: b0, b1 of cols n0..n0+7, then of n0+8..n0+15).
//  * b1_frag: b_frag for one n-tile (ldsm_x2).
__device__ __forceinline__ const bf16* a_frag(const bf16* base, int ld, int r0,
                                              int k0, int lane) {
  return base + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}

__device__ __forceinline__ const bf16* b_frag(const bf16* base, int ld, int n0,
                                              int k0, int lane) {
  return base + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}

// Lane addresses for ldsm_x2 of one n-tile (rows n0..n0+7, k k0..k0+15).
__device__ __forceinline__ const bf16* b1_frag(const bf16* base, int ld, int n0,
                                               int k0, int lane) {
  return base + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ const bf16* bt_frag(const bf16* base, int ld,
                                               int k0, int n0, int lane) {
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// Rows [r0, r0 + rows) of a row-major (N, width) bf16 tensor, columns
// [c0, c0 + cols) (cols a multiple of 8), into a shared tile with row stride
// ld, by cp.async; rows at or past `valid` are zero-filled.
__device__ __forceinline__ void load_tile_async(bf16* dst, int ld,
                                                const bf16* src, int width,
                                                int r0, int rows, int valid,
                                                int c0, int cols) {
  // Chunk i = r * chunks + ch of the tile, walked in steps of blockDim.x
  // without a division per chunk.
  const int chunks = cols >> 3;
  const int step_r = blockDim.x / chunks;
  const int step_c = blockDim.x - step_r * chunks;
  int r = threadIdx.x / chunks;
  int ch = threadIdx.x - r * chunks;
  for (; r < rows; r += step_r) {
    const bool ok = r0 + r < valid;
    cp_async_16(dst + r * ld + ch * 8,
                src + (size_t)(ok ? r0 + r : 0) * width + c0 + ch * 8, ok);
    ch += step_c;
    if (ch >= chunks) {
      ch -= chunks;
      ++r;
    }
  }
}

}  // namespace lfb
