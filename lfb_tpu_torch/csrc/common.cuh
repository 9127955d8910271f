// Shared helpers for the lfb_tpu_torch CUDA kernels.
//
// Every kernel is exposed through a plain C launcher (no PyTorch headers) that
// takes raw device pointers and a cudaStream_t, launches on that stream and
// returns cudaGetLastError(); the Python wrappers (lfb_tpu_torch/ops/cuda_*.py)
// bind them with ctypes and raise on a non-zero return.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define LFB_EXPORT extern "C" __attribute__((visibility("default")))

namespace lfb {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 2^x on the special-function unit (ex2.approx.ftz: 2 ulp; results below
// 2^-126 flush to zero), as the attention kernels' softmax takes it.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// bf16 and the shared-memory helpers of the kernels that stage tiles
// themselves: a generic pointer as a shared-state-space address, cp.async
// copies into shared memory, and an f32 pair rounded to a bf16 pair.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A working-type value in f32, and an f32 value rounded to the working type.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);        // clamp_min(v, 0)
}

// 16 bytes <-> the V working-type values they hold, in f32.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(uint4 q, float* f) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(uint4 q, float* f) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(bits(f[0]) | bits(f[1]) << 16,
                      bits(f[2]) | bits(f[3]) << 16,
                      bits(f[4]) | bits(f[5]) << 16,
                      bits(f[6]) | bits(f[7]) << 16);
  }
};

// The current device's SM count, read once a device: a train step launches
// the elementwise kernels hundreds of times, and the count never changes.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 132;
  }
  int sms = cached[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      sms = 132;
    }
    cached[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

inline bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace lfb
