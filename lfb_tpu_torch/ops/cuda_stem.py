"""Stem convolution (conv1): CUDA kernel (``csrc/stem_conv.cu``) and its
plain PyTorch version.

Replaces ``lfb_tpu/ops/pallas_stem.py:stem_conv_s2d`` (kernel
``_stem_kernel`` with ``_ring_window_and_a_matrix``, ``_pack_x`` and
``_pack_w``), forward only: kT x 7 x 7, stride (1, 2, 2), padding
(kT // 2, 3, 3), Cin 3 -> Cout 64, channels-last, f32 accumulation.

What bounds it on an H100: with Cin = 3 each output needs only kT * 147
multiply-adds of a tiny weight set, so the work is FMA issue and
shared-memory traffic rather than device memory (the input is read about
once per temporal tap).  The TPU's 2x2 space-to-depth packing existed to
fill the 128-lane MXU and is not carried over.  The kernel is a direct
conv: per CTA one (clip, frame, band of output rows), the input halo and one
temporal tap's weights staged in shared memory, 4 pixels x 16 channels of
accumulators per thread.  It takes any crop whose output width is at most
256 (224, 256 and 320 all are); the TPU envelope (H/2 % 16 == 0,
W/2 <= 128) is gone.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.conv3d import conv3d

# Launches of the CUDA kernel since the last reset (the chip smoke reads it).
LAUNCHES = 0

MAX_OUT_WIDTH = 256
_LAUNCHERS = {torch.float32: 'lfb_stem_conv_f32',
              torch.bfloat16: 'lfb_stem_conv_bf16'}


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    temporal_pad: int) -> torch.Tensor:
    return conv3d(x, w, strides=(1, 2, 2), padding=(temporal_pad, 3, 3))


def stem_conv(x: torch.Tensor, w: torch.Tensor, *,
              temporal_pad: int) -> torch.Tensor:
    """(B, T, H, W, 3) x (64, 3, kT, 7, 7) -> (B, T, Ho, Wo, 64) in x's
    dtype.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if x.device.type == 'cpu':
        return stem_conv_plain(x, w, temporal_pad)
    _check(x, w, temporal_pad)
    B, T, H, W, _ = x.shape
    kt = w.shape[2]
    # (Cout, Cin, kT, 7, 7) -> (kT, 7, 7, Cin, Cout) f32, rounded to x's
    # dtype first so the kernel multiplies the same weights as cuDNN would.
    w_k = w.to(x.dtype).float().permute(2, 3, 4, 1, 0).contiguous()
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    out = torch.empty((B, T, Ho, Wo, 64), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        cuda_build.launch(_LAUNCHERS[x.dtype], x.data_ptr(), w_k.data_ptr(),
                          out.data_ptr(), B, T, H, W, kt)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check(x, w, temporal_pad) -> None:
    if not x.is_cuda or w.device != x.device:
        raise ValueError('stem_conv: x and w must be on one CUDA device (got '
                         '{}, {})'.format(x.device, w.device))
    if x.dtype not in _LAUNCHERS or x.dim() != 5 or not x.is_contiguous():
        raise ValueError('stem_conv: x must be a contiguous (B, T, H, W, 3) '
                         'float32 or bfloat16 tensor')
    B, T, H, W, C = x.shape
    if w.dim() != 5 or tuple(w.shape[:2]) != (64, 3) or \
            tuple(w.shape[3:]) != (7, 7) or C != 3:
        raise ValueError('stem_conv: takes Cin 3 -> Cout 64, 7x7 taps (got x '
                         '{}, w {})'.format(tuple(x.shape), tuple(w.shape)))
    if temporal_pad != w.shape[2] // 2:
        raise ValueError('stem_conv: temporal_pad must be kT // 2')
    if (W - 1) // 2 + 1 > MAX_OUT_WIDTH or min(B, T, H, W) < 1 or \
            B > 65535 or T > 65535:
        raise ValueError('stem_conv: unsupported input {}'.format(
            tuple(x.shape)))
