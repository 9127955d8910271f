"""Stem convolution (conv1): CUDA kernels (``csrc/stem_conv.cu``,
``csrc/stem_conv_dw.cu``), their plain PyTorch versions, and the autograd
Function that joins them.

Forward: replaces ``lfb_tpu/ops/pallas_stem.py:stem_conv_s2d`` (kernel
``_stem_kernel`` with ``_ring_window_and_a_matrix``, ``_pack_x`` and
``_pack_w``): kT x 7 x 7, stride (1, 2, 2), padding (kT // 2, 3, 3), Cin 3
-> Cout 64, channels-last, f32 accumulation.  Weight gradient: replaces
``pallas_stem.py:stem_conv_s2d_dw`` (kernel ``_stem_dw_kernel``).

What bounds it on an H100: with Cin = 3 each output needs only kT * 147
multiply-adds of a tiny weight set, so the work is FMA issue and
shared-memory traffic rather than device memory (the input is read about
once per temporal tap).  The TPU's 2x2 space-to-depth packing existed to
fill the 128-lane MXU and is not carried over.  The kernel is a direct
conv: per CTA one (clip, frame, band of output rows), the input halo and one
temporal tap's weights staged in shared memory, 4 pixels x 16 channels of
accumulators per thread.  It takes any crop whose output width is at most
256 (224, 256 and 320 all are); the TPU envelope (H/2 % 16 == 0,
W/2 <= 128) is gone.  The weight gradient has the same arithmetic shape
(47,040 outputs, each a sum over B * T * Ho * Wo positions): one CTA per
(frame, temporal tap) keeps a 3 x 16 slice of one 7 x 7 tap per thread in
registers and writes the frame's partial dW; a second launch sums the
partials in frame order, so no sum crosses CTAs.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.conv3d import conv3d

# Launches of the CUDA kernels since the last reset (the chip smoke reads
# them).
LAUNCHES = 0
DW_LAUNCHES = 0

MAX_OUT_WIDTH = 256
_LAUNCHERS = {torch.float32: 'lfb_stem_conv_f32',
              torch.bfloat16: 'lfb_stem_conv_bf16'}
_DW_LAUNCHERS = {torch.float32: 'lfb_stem_conv_dw_f32',
                 torch.bfloat16: 'lfb_stem_conv_dw_bf16'}
_TAP_W = 7 * 7 * 3 * 64


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    temporal_pad: int) -> torch.Tensor:
    return conv3d(x, w, strides=(1, 2, 2), padding=(temporal_pad, 3, 3))


def stem_conv_dw_plain(x: torch.Tensor, g: torch.Tensor,
                       kt: int) -> torch.Tensor:
    """dW (64, 3, kt, 7, 7) f32 of :func:`stem_conv_plain` for the output
    gradient ``g`` (B, T, Ho, Wo, 64): cuDNN's weight gradient on the card,
    computed in x's dtype."""
    dw = torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3), (64, 3, kt, 7, 7),
        g.to(x.dtype).permute(0, 4, 1, 2, 3), stride=(1, 2, 2),
        padding=(kt // 2, 3, 3))
    return dw.float()


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


def stem_conv_dw(x: torch.Tensor, g: torch.Tensor, kt: int) -> torch.Tensor:
    """dW (64, 3, kt, 7, 7) f32 from the input ``x`` (B, T, H, W, 3) and the
    output gradient ``g`` (B, T, Ho, Wo, 64) in x's dtype.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels or raises."""
    if x.device.type == 'cpu':
        return stem_conv_dw_plain(x, g, kt)
    _check_shape(x, kt)
    B, T, H, W, _ = x.shape
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    if not g.is_cuda or g.device != x.device or g.dtype != x.dtype or \
            tuple(g.shape) != (B, T, Ho, Wo, 64) or not g.is_contiguous():
        raise ValueError('stem_conv_dw: g must be a contiguous {} {} tensor on '
                         '{} (got {} {} on {})'.format(
                             (B, T, Ho, Wo, 64), x.dtype, x.device,
                             tuple(g.shape), g.dtype, g.device))
    partial = torch.empty((kt * B * T * _TAP_W,), dtype=torch.float32,
                          device=x.device)
    dw_k = torch.empty((kt, 7, 7, 3, 64), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        cuda_build.launch(_DW_LAUNCHERS[x.dtype], x.data_ptr(), g.data_ptr(),
                          partial.data_ptr(), dw_k.data_ptr(), B, T, H, W, kt)
    global DW_LAUNCHES
    DW_LAUNCHES += 1
    return dw_k.permute(4, 3, 0, 1, 2).contiguous()


class StemConv(torch.autograd.Function):
    """Differentiable stem conv, as lfb_tpu's custom VJP
    (``pallas_stem.py:386-434``): dW from the weight-gradient kernel; dX,
    needed only when the input itself requires a gradient (in training it
    is data), from ``torch.nn.grad.conv3d_input``, as lfb_tpu also takes dX
    outside its kernels."""

    @staticmethod
    def forward(ctx, x, w, temporal_pad):
        if any(ctx.needs_input_grad[:2]):
            ctx.temporal_pad = temporal_pad
            ctx.save_for_backward(x, w)
        return stem_conv(x, w, temporal_pad=temporal_pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = stem_conv_dw(x, g, w.shape[2]).to(w.dtype)
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(
                (x.shape[0], 3) + tuple(x.shape[1:4]), w.to(x.dtype),
                g.permute(0, 4, 1, 2, 3), stride=(1, 2, 2),
                padding=(ctx.temporal_pad, 3, 3)).permute(0, 2, 3, 4, 1)
            dx = dx.contiguous()
        return dx, dw, None


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
    _check_shape(x, w.shape[2])


def _check_shape(x, kt) -> None:
    if not x.is_cuda or x.dtype not in _LAUNCHERS or x.dim() != 5 or \
            x.shape[-1] != 3 or not x.is_contiguous():
        raise ValueError('stem_conv: x must be a contiguous (B, T, H, W, 3) '
                         'float32 or bfloat16 CUDA tensor')
    B, T, H, W, _ = x.shape
    if (W - 1) // 2 + 1 > MAX_OUT_WIDTH or min(B, T, H, W, kt) < 1 or \
            B > 65535 or T > 65535 or kt > 65535:
        raise ValueError('stem_conv: unsupported input {} (kT {})'.format(
            tuple(x.shape), kt))
