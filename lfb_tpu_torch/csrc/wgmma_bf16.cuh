// Warpgroup-level bf16 tensor-core building blocks (Hopper, sm_90a):
// wgmma.mma_async with its fence / commit / wait, shared-memory matrix
// descriptors, the mbarriers that hand shared-memory stages between a
// producer and consumer warpgroups, and the Tensor Memory Accelerator (TMA):
// tensor maps encoded on the host, tile loads into shared memory that
// complete on an mbarrier, and tile stores back.
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
// With the 128-byte swizzle (layout type 1, what TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B) a tile is stored as panels of 64 bf16
// columns: row r of a panel is 128 bytes at r * 128, and its 16-byte chunk
// c sits at chunk c ^ (r % 8); panels start on 1024-byte boundaries.
//  * K-major operand (k contiguous, as K in Q K^T): the stride byte offset
//    is 1024 (8 rows), the leading byte offset unused; the k16 step j of a
//    panel starts 32 j bytes into it.
//  * MN-major operand (m or n contiguous, as V in P V; the instruction's
//    transpose bit): the leading byte offset is the distance between
//    panels (64 columns of n), the stride byte offset 1024 (8 rows of k);
//    the k16 step j starts 16 j rows (2048 j bytes) into the panel.
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

#include <cuda.h>
#include <cuda_runtime.h>
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

// Arrive once and add `bytes` to the transactions the current phase waits
// for (the TMA loads that complete on this barrier).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Orders this thread's earlier ordinary shared-memory stores before later
// accesses by the async proxy (wgmma's shared operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A named barrier (1-15; 0 is __syncthreads) over `count` threads, whole
// warps: orders their shared-memory accesses before and after it.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive at named barrier `id` without waiting (the other `count` minus
// these threads wait there with named_bar_sync).
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Warp specialisation: the warpgroup gives registers back (producer) or
// takes them (consumers), so the consumers hold their accumulators without
// spilling; every warp of the group executes it.
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- thread block clusters -------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// All threads of the cluster's CTAs (the mbarrier inits before it are
// visible to the other CTAs after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address in CTA `rank`'s shared memory of this CTA's shared byte
// address `addr` (distributed shared memory).
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::
                   "r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Arrive once (release at cluster scope: this thread's earlier stores,
// local or remote, are visible to whoever acquires the phase) at the
// mbarrier at cluster address `bar`, in this or another CTA.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope, for phases another CTA's
// threads complete.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA -------------------------------------------------------------------

// A 3-d tile (x columns, y rows, z batch) of `map` into shared memory at
// byte address `dst`; its bytes complete a transaction of `bar`.  Elements
// outside the tensor read as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

// The tile at shared byte address `src` to (x, y, z) of `map`; elements
// outside the tensor are not written.  Complete with tma_store_wait().
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int x, int y,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Returns once this thread's TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::
          : "memory");
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (the
// library links no libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a row-major (B, N, C) bf16 tensor at `ptr` (16-byte
// aligned, C a multiple of 8) whose tiles are 64 columns x `rows` rows of
// one batch element, stored with the 128-byte swizzle.
inline cudaError_t tma_map_bf16(CUtensorMap* map, const void* ptr, int B, int N,
                                int C, int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)N * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// Descriptor of a 128-byte-swizzled operand (see above) starting at shared
// byte address `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lead_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lead_bytes >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// The A fragment of k16 step kc from an m64nN f32 accumulator d (its
// columns 16 kc .. 16 kc + 15 as the k of the next product), rounded to
// bf16: the accumulator's and the A operand's register layouts agree, so a
// score tile is the A operand of P V without a trip through shared memory.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N],
                                         int kc) {
  a[0] = pack_bf16(d[8 * kc], d[8 * kc + 1]);
  a[1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
}

// m64nNk16 with f32 sums of bf16 products: ss (A and B from shared memory,
// both K-major) for N in {16, 32, 64}, the score tiles, and rs_t (A from
// registers, B MN-major) for N = 256, the sums over 256 channels.  d holds
// N / 2 floats a thread, in the layout above.  A product that adds to d
// (scale-d) reads it; where ordinary instructions write (or read) the
// accumulator of a product that another one in flight shares a pipeline
// stage with, ptxas serialises all of the function's wgmma (C7515, C7514).
// So a sum that runs across tiles starts unset and its first product does
// not add (acc false) rather than being zeroed, and score tiles are fresh
// arrays each tile.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (64 x 16) = A (64 x 16, shared memory at da, K-major) . B (16 x 16,
  // shared memory at db, K-major), plus d if kAcc.
  template <int kAcc>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                           uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " %8, %9, p, 1, 1, 0, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "n"(kAcc));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32) = A (64 x 16, shared memory at da, K-major) . B (16 x 32,
  // shared memory at db, K-major), plus d if kAcc.
  template <int kAcc>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                           uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "l"(da), "l"(db), "n"(kAcc));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64) = A (64 x 16, shared memory at da, K-major) . B (16 x 64,
  // shared memory at db, K-major), plus d if kAcc.
  template <int kAcc>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                           uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "n"(kAcc));
  }
};

template <>
struct Wgmma<256> {
  // d (64 x 256) = a (64 x 16, registers) . B (16 x 256, shared memory at
  // db, MN-major: the descriptor's transpose bit), plus d if acc.
  static __device__ __forceinline__ void rs_t(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};

// d = A B over one k16 step, added to d unless this is a chain's first step
// (`acc` false): a constant where the caller's loops unroll, so ptxas sees
// which products read d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, bool acc) {
  if (acc)
    Wgmma<N>::template ss<1>(d, da, db);
  else
    Wgmma<N>::template ss<0>(d, da, db);
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
