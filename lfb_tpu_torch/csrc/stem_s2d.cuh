// The space-to-depth packing of the stem's input (lfb_tpu/ops/pallas_stem.py
// _pack_x), built in shared memory by the bf16 stem kernels: the forward
// (stem_conv.cu) and the weight gradient (stem_conv_dw.cu).  Packed pixel
// (r, c) of a frame holds the 2 x 2 input pixels (2r + hp - 4, 2c + wp - 4)
// x 3 channels, (hp, wp, ci), zero-padded to 16 bf16 (32 bytes); a band of
// packed rows is stored row after row, each Wp = Wo + 3 pixels wide.
#pragma once

#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace lfb {
namespace s2d {

constexpr int kPixBytes = 32;   // a packed pixel: 16 bf16
constexpr int kInC = 3;         // input channels

// Byte `b` of a packed band (pixel p at 32 p, half h at + 16 h) as stored:
// the halves swap every fourth pixel (bit 7 of b flips bit 4).
__device__ __forceinline__ uint32_t swizzle(uint32_t b) {
  return b ^ ((b >> 3) & 16);
}

// 4 bytes global -> shared, zero-filled when !valid (src must still be a
// valid address).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// Packed pixel (lr, pc) of a band whose first packed row is r0, from frame
// xf (H x W x 3): x rows 2 (r0 + lr) - 4 + hp, columns 2 pc - 4 + wp, 3
// channels each, in (hp, wp, ci) order: 12 values, the first 8 in the
// pixel's first half, the rest at the start of its second; outside the
// frame reads zero.  Channels 12-15 are never written: the stages start
// zeroed.
//
// `words` (W even, x 4-byte aligned: every (row, even column) pixel starts
// on a 4-byte boundary): the 6 values of a row are 3 aligned words, copied
// by cp.async, which the band's full barrier waits for.  Else by 2-byte
// loads and two stores.
__device__ __forceinline__ void pack_pixel(uint32_t sx, int lr, int pc, int Wp,
                                           const bf16* xf, int r0, int H,
                                           int W, bool words) {
  const uint32_t dst = sx + swizzle((uint32_t)(lr * Wp + pc) * kPixBytes);
  const int ih = 2 * (r0 + lr) - 4, iw = 2 * pc - 4;
  uint32_t v[6];
#pragma unroll
  for (int hp = 0; hp < 2; ++hp) {
    const int h = ih + hp;
    const bool row_ok = h >= 0 && h < H;
    if (words) {
      const bool ok = row_ok && iw >= 0 && iw + 1 < W;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          ok ? xf + ((size_t)h * W + iw) * kInC : xf);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int word = 3 * hp + k;      // of the pixel's 6
        cp_async_4((word < 4 ? dst : dst ^ 16) + (word & 3) * 4,
                   src + (ok ? k : 0), ok);
      }
    } else {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(xf);
      uint32_t e[6];
#pragma unroll
      for (int wp = 0; wp < 2; ++wp) {
        const int c = iw + wp;
        const bool ok = row_ok && c >= 0 && c < W;
#pragma unroll
        for (int ci = 0; ci < kInC; ++ci)
          e[3 * wp + ci] = ok ? src[((size_t)h * W + c) * kInC + ci] : 0u;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[3 * hp + k] = e[2 * k] | (e[2 * k + 1] << 16);
    }
  }
  if (!words) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(dst ^ 16),
                 "r"(v[4]), "r"(v[5]));
  }
}

}  // namespace s2d
}  // namespace lfb
