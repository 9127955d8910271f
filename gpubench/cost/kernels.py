"""The operations and bytes of each hand-written kernel of the port, from
its call's shapes, and the least time the card could take for them.

Frozen here so that a change to a kernel cannot change its own yardstick.
A call's bound is the larger of its operations over the peak of its dtype
and its bytes over the memory rate, each input counted read once and
each output written once, whatever the kernel reads again:

  attention forward   4 B Nq Nk C operations; q, k, v read, the output
                      (and, when it keeps it for a backward, the f32 row
                      log-sum-exp) written
  attention backward  10 B Nq Nk C (q k^T again, dV, dP, dQ, dK); q, k,
                      v, dO, the f32 lse and delta read, the f32 dq, dk,
                      dv written
  RoI + max-pool      bytes: the map pixels the boxes reach (each box's
                      extent on the map and one pixel more for the
                      bilinear neighbours, once a clip), the rois, the
                      (N, C) f32 output; the backward reads the same
                      pixels, the rois and dOut and writes the whole f32
                      gradient map
  stem forward        2 x out x kT x 7 x 7 x 3 operations; x, the f32
                      weights, the bf16 output
  stem weight grad    2 x dOut x kT x 7 x 7 x 3; x and dOut, the f32 dW
  fused bottleneck    2 x pixels x (kT C Ci + 9 Ci^2 + Ci C); x read and
                      the output written (bf16), the three weights (bf16)

These are the formulas of the port's kernel table (PERF.md, the Bound
column); ``gpubench/tests/test_gpubench_cost.py`` holds them to its values.
Which calls a network's pass makes is that network's launch list
(``cost/<reference>.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Published H100 SXM peaks, dense (NVIDIA's datasheet): bf16 on the tensor
# cores, f32 outside them, and the HBM3 rate.
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12
SIZE = {'bfloat16': 2, 'float32': 4}

Call = Tuple[str, float, float, str]     # (family, operations, bytes, dtype)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def attention_fwd(b, nq, nk, c, dtype, lse=False) -> Call:
    e = SIZE[dtype]
    nbytes = e * (2 * b * nq * c + 2 * b * nk * c) + (4 * b * nq if lse else 0)
    return ('attention', 4.0 * b * nq * nk * c, nbytes, dtype)


def attention_bwd(b, nq, nk, c, dtype) -> Call:
    e = SIZE[dtype]
    nbytes = (e * (2 * b * nq * c + 2 * b * nk * c) + 2 * 4 * b * nq
              + 4 * (b * nq * c + 2 * b * nk * c))
    return ('attention_bwd', 10.0 * b * nq * nk * c, nbytes, dtype)


def roi_pixels(rois: np.ndarray, size: int, scale: float = 1 / 16) -> int:
    """Map pixels the boxes reach, once a clip (``rois`` (N, 5) [clip, x1,
    y1, x2, y2] in input pixels, a square ``size`` map)."""
    seen = np.zeros((int(rois[:, 0].max()) + 1, size, size), bool)
    for b, x1, y1, x2, y2 in rois:
        r0, c0 = (max(0, min(size - 1, int(np.floor(v * scale))))
                  for v in (y1, x1))
        r1, c1 = (max(0, min(size - 1, int(np.floor(v * scale)) + 1))
                  for v in (y2, x2))
        seen[int(b), r0:r1 + 1, c0:c1 + 1] = True
    return int(seen.sum())


def roi_fwd(rois: np.ndarray, size: int, channels: int = 2048) -> Call:
    n = rois.shape[0]
    nbytes = (roi_pixels(rois, size) * channels * 4 + rois.nbytes
              + n * channels * 4)
    return ('roi_align_maxpool', 0.0, nbytes, 'float32')


def roi_bwd(rois: np.ndarray, clips: int, size: int,
            channels: int = 2048) -> Call:
    n = rois.shape[0]
    nbytes = (roi_pixels(rois, size) * channels * 4 + rois.nbytes
              + n * channels * 4 + clips * size * size * channels * 4)
    return ('roi_align_maxpool_bwd', 0.0, nbytes, 'float32')


def stem_fwd(b, t, crop, kt, dtype='bfloat16') -> Call:
    out = b * t * (crop // 2) * (crop // 2) * 64
    nbytes = (SIZE[dtype] * b * t * crop * crop * 3 + 4 * 64 * 3 * kt * 49
              + SIZE[dtype] * out)
    return ('stem_conv', 2.0 * out * kt * 147, nbytes, dtype)


def stem_dw(b, t, crop, kt, dtype='bfloat16') -> Call:
    out = b * t * (crop // 2) * (crop // 2) * 64
    nbytes = (SIZE[dtype] * (b * t * crop * crop * 3 + out)
              + 4 * 64 * 3 * kt * 49)
    return ('stem_conv_dw', 2.0 * out * kt * 147, nbytes, dtype)


def bottleneck(shape, ci, kt, dtype='bfloat16') -> Call:
    c = shape[-1]
    pixels = int(np.prod(shape[:-1]))
    weights = c * ci * kt + 9 * ci * ci + ci * c
    nbytes = SIZE[dtype] * (2 * pixels * c + weights)
    return ('fused_bottleneck', 2.0 * pixels * weights, nbytes, dtype)
