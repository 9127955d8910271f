"""Fused identity bottleneck for inference: the CUDA kernel
(``csrc/fused_bottleneck.cu``), its plain PyTorch version and the fold of
the frozen affine into the conv weights (port of
``lfb_tpu/ops/pallas_bottleneck.py``).

A ResNet identity block in frozen-affine mode is three convolutions, each
followed by its affine, with relus and the identity shortcut
(``lfb_tpu/models/backbone.py:_bottleneck``).  With the affine scales
folded into the weights it is

    h1  = relu(conv_{kT x 1 x 1}(x) + b2a)
    h2  = relu(conv_{1 x 3 x 3, dilation d}(h1) + b2b)
    out = relu(conv_{1 x 1 x 1}(h2) + b2c + x)

and the kernel runs it per (clip, frame, band of rows) with h1 and h2 in
shared memory: x is read once per temporal tap (and again for the
residual), the output written once, and the Ci-wide intermediates never
reach device memory.  In bf16 its three stages are GEMMs on ``wgmma``, fed
by TMA with the weights in the (K, N) layouts of :func:`kernel_weights`
(read by TMA: x and those matrices must lie on 16-byte aligned addresses,
which the wrapper checks for x); f32 stays on the FMA units (see the
source).

Rounding, as the TPU kernel's: weights and biases are cast to x's dtype,
products accumulate in f32, h1 and h2 are rounded to x's dtype, the
residual is added in f32 and the output rounded once.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.conv3d import conv3d
from lfb_tpu_torch.utils.profiling import count

_LAUNCHERS = {torch.float32: 'lfb_fused_bottleneck_f32',
              torch.bfloat16: 'lfb_fused_bottleneck_bf16'}


def fold_bottleneck_params(p: Mapping[str, torch.Tensor], prefix: str):
    """Fold the frozen affine scales of block ``prefix`` into its conv
    weights, in f32: (w2a, b2a, w2b, b2b, w2c, b2c) with the weights in the
    port's layout, w2a (Ci, C, kT, 1, 1), w2b (Ci, Ci, 1, 3, 3), w2c (C, Ci,
    1, 1, 1).  None if the block's params are not the plain bottleneck set
    (as ``lfb_tpu``'s ``fold_bottleneck_params``)."""
    try:
        w2a, s1, b1 = (p[prefix + '_branch2a' + n] for n in ('_w', '_bn_s',
                                                             '_bn_b'))
        w2b, s2, b2 = (p[prefix + '_branch2b' + n] for n in ('_w', '_bn_s',
                                                             '_bn_b'))
        w2c, s3, b3 = (p[prefix + '_branch2c' + n] for n in ('_w', '_bn_s',
                                                             '_bn_b'))
    except KeyError:
        return None
    if tuple(w2a.shape[3:]) != (1, 1) or tuple(w2b.shape[2:]) != (1, 3, 3):
        return None

    def fold(w, s):
        return w.float() * s.float().reshape(-1, 1, 1, 1, 1)

    return fold(w2a, s1), b1, fold(w2b, s2), b2, fold(w2c, s3), b3


def fused_identity_bottleneck_plain(x, w2a, b2a, w2b, b2b, w2c, b2c, *,
                                    temporal_pad: int,
                                    dilation: int) -> torch.Tensor:
    """The block with the kernel's rounding (see the module docstring),
    through ``conv3d`` in f32."""
    dt = x.dtype

    def cast(t):
        return t.to(dt).float()

    d = dilation
    h = conv3d(x.float(), cast(w2a), padding=(temporal_pad, 0, 0))
    h = F.relu(h + cast(b2a)).to(dt).float()
    h = conv3d(h, cast(w2b), padding=(0, d, d), dilation=(1, d, d))
    h = F.relu(h + cast(b2b)).to(dt).float()
    h = conv3d(h, cast(w2c)) + cast(b2c)
    return F.relu(h + x.float()).to(dt)


def fused_identity_bottleneck(x, w2a, b2a, w2b, b2b, w2c, b2c, *,
                              temporal_pad: int,
                              dilation: int = 1) -> torch.Tensor:
    """x (B, T, H, W, C) -> (B, T, H, W, C) in x's dtype, with the folded
    params of :func:`fold_bottleneck_params`.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == 'cpu':
        return fused_identity_bottleneck_plain(
            x, w2a, b2a, w2b, b2b, w2c, b2c, temporal_pad=temporal_pad,
            dilation=dilation)
    B, T, H, W, C, Ci, kt = _check(x, w2a, w2b, w2c, temporal_pad, dilation)
    dt = x.dtype
    wa, wb, wc = kernel_weights(w2a, w2b, w2c, dt)
    ba, bb, bc = (v.to(device=x.device, dtype=dt).contiguous()
                  for v in (b2a, b2b, b2c))
    if tuple(ba.shape) != (Ci,) or tuple(bb.shape) != (Ci,) or \
            tuple(bc.shape) != (C,):
        raise ValueError('fused_identity_bottleneck: biases must be ({0},), '
                         '({0},), ({1},)'.format(Ci, C))
    if dt == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError('fused_identity_bottleneck: the bf16 kernel reads x '
                         'in 16-byte pieces, which takes a 16-byte aligned '
                         'address (x at {:#x})'.format(x.data_ptr()))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        cuda_build.launch(_LAUNCHERS[dt], x.data_ptr(), wa.data_ptr(),
                          ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                          wc.data_ptr(), bc.data_ptr(), out.data_ptr(), B, T,
                          H, W, C, Ci, kt, dilation)
    count('kernel.bottleneck.fwd')
    return out


def kernel_weights(w2a, w2b, w2c, dtype):
    """The port's conv weights -> the kernel's (K, N) row-major layouts, in
    ``dtype``: w2a (kT * C, Ci) with rows (tap, c), w2b (9 * Ci, Ci) with
    rows (dh, dw, ci) row-major in (dh, dw), w2c (Ci, C)."""
    Ci, C, kt = w2a.shape[:3]
    wa = w2a.to(dtype).permute(2, 1, 0, 3, 4).reshape(kt * C, Ci)
    wb = w2b.to(dtype)[:, :, 0].permute(2, 3, 1, 0).reshape(9 * Ci, Ci)
    wc = w2c.to(dtype).reshape(C, Ci).t()
    return wa.contiguous(), wb.contiguous(), wc.contiguous()


def _check(x, w2a, w2b, w2c, temporal_pad, dilation):
    if not x.is_cuda or any(w.device != x.device for w in (w2a, w2b, w2c)):
        raise ValueError('fused_identity_bottleneck: x and the weights must '
                         'be on one CUDA device')
    if x.dtype not in _LAUNCHERS or x.dim() != 5 or not x.is_contiguous():
        raise ValueError('fused_identity_bottleneck: x must be a contiguous '
                         '(B, T, H, W, C) float32 or bfloat16 tensor')
    B, T, H, W, C = x.shape
    Ci, kt = w2a.shape[0], w2a.shape[2]
    if tuple(w2a.shape) != (Ci, C, kt, 1, 1) or \
            tuple(w2b.shape) != (Ci, Ci, 1, 3, 3) or \
            tuple(w2c.shape) != (C, Ci, 1, 1, 1):
        raise ValueError('fused_identity_bottleneck: weights {}, {}, {} do not '
                         'make an identity block over {} channels'.format(
                             tuple(w2a.shape), tuple(w2b.shape),
                             tuple(w2c.shape), C))
    if C % 16 or Ci % 16 or kt % 2 == 0 or temporal_pad != kt // 2 or \
            dilation < 1 or min(B, T, H, W) < 1 or max(B, T) > 65535:
        raise ValueError('fused_identity_bottleneck: unsupported block (x {}, '
                         'Ci {}, kT {}, temporal_pad {}, dilation {}): C and '
                         'Ci must be multiples of 16, kT odd with '
                         'temporal_pad kT // 2'.format(
                             tuple(x.shape), Ci, kt, temporal_pad, dilation))
    return B, T, H, W, C, Ci, kt
