"""Stem convolution (conv1): CUDA kernels (``csrc/stem_conv.cu``,
``csrc/stem_conv_dw.cu``), their plain PyTorch versions, and the autograd
Function that joins them.

Forward: replaces ``lfb_tpu/ops/pallas_stem.py:stem_conv_s2d`` (kernel
``_stem_kernel`` with ``_ring_window_and_a_matrix``, ``_pack_x`` and
``_pack_w``): kT x 7 x 7, stride (1, 2, 2), padding (kT // 2, 3, 3), Cin 3
-> Cout 64, channels-last, f32 accumulation.  Weight gradient: replaces
``pallas_stem.py:stem_conv_s2d_dw`` (kernel ``_stem_dw_kernel``).

Both run over the TPU kernel's space-to-depth packing in bf16
(:func:`pack_x_s2d`, :func:`pack_w_s2d`, :func:`unpack_dw_s2d`;
``pallas_stem.py``'s ``_pack_x`` / ``_pack_w`` / ``_unpack_dw4``), which
makes the stride-2 7 x 7 x 3 conv a stride-1 4 x 4 conv over 16 channels:
every (dh, dw) tap is one k16 tensor-core operand.  The forward is an
implicit GEMM on ``wgmma`` (pixels x 64 channels, K = kT x 256) that packs
x inside the kernel, with every temporal tap's packed weights (from
:func:`pack_w_s2d`, at most 160 KB: kT <= 5) resident in shared memory.
It takes any crop whose output width is at most 256 (224, 256 and 320 all
are); the TPU envelope (H/2 % 16 == 0, W/2 <= 128) is gone.  In f32 both
stay on the FMA units (the f32 paths are held to the CPU at 1e-4, which
TF32 would break): a direct conv per (clip, frame, band of output rows).

The weight gradient is a product per frame and temporal tap, reduced over
the frames' output pixels.  In bf16 it runs on ``wgmma``: persistent CTAs,
each one temporal tap over a share of the frames, pack x inside the kernel
(the layout of :func:`pack_x_s2d`), take g by TMA and keep their sums in
registers; each writes one partial and a second launch sums the partials
in a fixed order.  In f32 one CTA per (frame, temporal tap) writes a
partial, summed the same way.  No sum crosses CTAs by atomics, so the
result does not change from run to run.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.conv3d import conv3d
from lfb_tpu_torch.utils.profiling import count

MAX_OUT_WIDTH = 256
MAX_BF16_KT = 5           # the bf16 forward keeps every tap's weights resident
_LAUNCHERS = {torch.float32: 'lfb_stem_conv_f32',
              torch.bfloat16: 'lfb_stem_conv_bf16'}
_DW_LAUNCHERS = {torch.float32: 'lfb_stem_conv_dw_f32',
                 torch.bfloat16: 'lfb_stem_conv_dw_bf16'}
_TAP_W = 7 * 7 * 3 * 64
_S2D_TAP_W = 4 * 4 * 16 * 64


def pack_x_s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) -> (B, T, Ho + 3, Wo + 3, 16), Ho = ceil(H / 2):
    packed pixel (r, c) holds input pixels (2 r + hp - 4, 2 c + wp - 4) for
    hp, wp in {0, 1}, channels ordered (hp, wp, ci) and zero-padded from 12
    to 16; input outside the image is 0.  The stride-2 7 x 7 stem conv is
    a stride-1 4 x 4 conv over this (taps padded to 8 x 8 with a leading
    zero): output (ho, wo) reads packed pixel (ho + dh, wo + dw).  The bf16
    kernels build this layout band by band in shared memory
    (``csrc/stem_s2d.cuh``); here it is the reference of their arithmetic."""
    B, T, H, W, C = x.shape
    hp, wp = (H + 1) // 2 + 3, (W + 1) // 2 + 3
    xp = torch.nn.functional.pad(
        x, (0, 0, 4, 2 * wp - W - 4, 4, 2 * hp - H - 4))
    xp = xp.view(B, T, hp, 2, wp, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    out = x.new_zeros((B, T, hp, wp, 16))
    out[..., :4 * C] = xp.reshape(B, T, hp, wp, 4 * C)
    return out


def unpack_dw_s2d(dw4: torch.Tensor) -> torch.Tensor:
    """dW over the packed taps, (kT, 4, 4, 16, 64) as (kt, dh, dw, (hp, wp,
    ci), co), -> (kT, 7, 7, 3, 64): tap kh = 2 dh + hp - 1, kw = 2 dw + wp
    - 1; the leading zero tap and the padded channels are dropped."""
    kt = dw4.shape[0]
    d = dw4.reshape(kt, 4, 4, 16, 64)[:, :, :, :12]
    d = d.reshape(kt, 4, 4, 2, 2, 3, 64).permute(0, 1, 3, 2, 4, 5, 6)
    return d.reshape(kt, 8, 8, 3, 64)[:, 1:, 1:]


def pack_w_s2d(w: torch.Tensor) -> torch.Tensor:
    """(64, 3, kT, 7, 7) -> the bf16 forward kernel's weights (in w's
    dtype), (kT, 4, 4, 8, 2, 8, 8) as (kt, dh, dw, co // 8, c16 // 8, co %
    8, c16 % 8).

    That is W4[kt, dh, dw, c16, co], ``pallas_stem._pack_w``'s packing (tap
    kh = 2 dh + hp - 1, kw = 2 dw + wp - 1 with a leading zero tap, c16 =
    (hp, wp, ci) zero-padded from 12 to 16), with each tap's 16 x 64 slice
    cut into the 8 x 8 core matrices of a K-major ``wgmma`` B operand
    without swizzle: core matrix (co // 8, c16 // 8) at byte (2 (co // 8) +
    c16 // 8) * 128 of the tap's 2 KB, row co % 8 at 16 bytes each."""
    kt = w.shape[2]
    w = w.permute(2, 3, 4, 1, 0)                        # (kt, 7, 7, 3, 64)
    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))   # 8 x 8 taps
    w = w.reshape(kt, 4, 2, 4, 2, 3, 64).permute(0, 1, 3, 2, 4, 5, 6)
    w = torch.nn.functional.pad(w.reshape(kt, 4, 4, 12, 64), (0, 0, 0, 4))
    return w.reshape(kt, 4, 4, 2, 8, 8, 8).permute(0, 1, 2, 5, 3, 6,
                                                    4).contiguous()


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
    if x.dtype == torch.bfloat16:
        w_k = pack_w_s2d(w.to(torch.bfloat16))
    else:   # (Cout, Cin, kT, 7, 7) -> (kT, 7, 7, Cin, Cout)
        w_k = w.float().permute(2, 3, 4, 1, 0).contiguous()
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    out = torch.empty((B, T, Ho, Wo, 64), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        cuda_build.launch(_LAUNCHERS[x.dtype], x.data_ptr(), w_k.data_ptr(),
                          out.data_ptr(), B, T, H, W, kt)
    count('kernel.stem.fwd')
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
    if B * T > 65535:
        raise ValueError('stem_conv_dw: at most 65535 frames (got {})'.format(
            B * T))
    packed = x.dtype == torch.bfloat16
    if packed and g.data_ptr() % 16:
        raise ValueError('stem_conv_dw: the bf16 kernel reads g by TMA, which '
                         'takes 16-byte aligned addresses (g at {:#x})'.format(
                             g.data_ptr()))
    if packed:   # one partial per persistent CTA: one an SM, one a tap
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        tap_w, parts = _S2D_TAP_W, max(kt, sms)
    else:        # one per frame and tap
        tap_w, parts = _TAP_W, kt * B * T
    partial = torch.empty((parts * tap_w,), dtype=torch.float32,
                          device=x.device)
    dw_k = torch.empty((kt, tap_w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        cuda_build.launch(_DW_LAUNCHERS[x.dtype], x.data_ptr(), g.data_ptr(),
                          partial.data_ptr(), dw_k.data_ptr(), B, T, H, W, kt)
    count('kernel.stem.dw')
    dw_k = unpack_dw_s2d(dw_k) if packed else dw_k.view(kt, 7, 7, 3, 64)
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
    if x.dtype == torch.bfloat16 and w.shape[2] > MAX_BF16_KT:
        raise ValueError('stem_conv: the bf16 kernel takes kT <= {} (got '
                         '{})'.format(MAX_BF16_KT, w.shape[2]))
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
