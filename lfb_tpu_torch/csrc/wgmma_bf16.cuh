// Warpgroup-level bf16 tensor-core building blocks (Hopper, sm_90a):
// wgmma.mma_async with its fence / commit / wait, shared-memory matrix
// descriptors, and the mbarriers that hand shared-memory stages between a
// producer and consumer warpgroups.
//
// wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply-Accumulate"):
// the 4 warps of a warpgroup (warps 4k .. 4k + 3 of the CTA) issue one
// m64nNk16 product together.  With A from registers, warp w holds rows
// 16 w .. 16 w + 15 of the 64 x 16 A tile in mma.m16n8k16's A layout
// (mma_bf16.cuh: a0 row g k 2t.., a1 row g + 8, a2 row g k 2t + 8.., a3 row
// g + 8 k 2t + 8..), so one ldmatrix.x4 per warp loads it.  The f32
// accumulator of m64n64 is 32 floats a thread: warp w owns rows 16 w ..
// 16 w + 15, and d[4 i .. 4 i + 3] is mma.m16n8's C layout for columns
// 8 i .. 8 i + 7 (d[4 i], d[4 i + 1]: row g, cols 8 i + 2 t, + 1; d[4 i + 2],
// d[4 i + 3]: row g + 8).
//
// B comes from shared memory through a 64-bit descriptor.  Without swizzle
// a K-major operand is made of 8 x 8 core matrices, each 8 rows (n) of 16
// contiguous bytes (8 k values), 128 bytes in all; the descriptor gives the
// byte distance between the two core matrices of a k16 step that are
// adjacent in k (the leading byte offset) and between core matrices
// adjacent in n (the stride byte offset).
//
// Ordering: wgmma reads its register operands and accumulates
// asynchronously.  wgmma_fence() must come between the instructions that
// write an A fragment or touch an accumulator and the wgmma that reads
// them; wgmma_commit() closes a group of issued products and
// wgmma_wait<N>() returns once at most N groups are still running, after
// which their A registers may be overwritten and their accumulators read
// (fence_operand() keeps the compiler from moving those reads above the
// wait).  Shared memory written by ordinary stores must pass
// fence_proxy_async() before a wgmma reads it.
#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace lfb {

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After the initialising thread's mbar_init calls, before a __syncthreads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once (release: this thread's earlier shared-memory accesses are
// visible to whoever waits for the phase it completes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait (acquire) until the phase of parity `parity` has completed.  A new
// barrier is in phase 0: waiting with parity 1 returns at once, with parity
// 0 after the first count arrivals.
// The loop stays inside the asm, so the compiler sees no branch that could
// diverge (a wgmma on a path it cannot prove uniform is serialised).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier ordinary shared-memory stores before later
// reads by the async proxy (wgmma's B operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to `d` across this point.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a no-swizzle operand whose first core matrix starts at
// `smem` (16-byte aligned): the leading (k) and stride (m or n) byte
// offsets between core matrices, layout type 0, base offset 0.  Adding
// bytes / 16 to it moves the start address.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem,
                                               uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return (uint64_t)((smem_addr(smem) & 0x3FFFF) >> 4) |
         ((uint64_t)(lead_bytes >> 4) << 16) |
         ((uint64_t)(stride_bytes >> 4) << 32);
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) . B (16 x 64, bf16,
// K-major in shared memory at `desc`).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace lfb
