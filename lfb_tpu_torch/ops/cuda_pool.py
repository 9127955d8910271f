"""Max pooling over channels-last tensors: a CUDA kernel pair
(``csrc/max_pool.cu``), their plain PyTorch versions, and the autograd
Function that joins them.  It serves pool1 (1x3x3 / 1x2x2 / pad 0,1,1,
fused behind the stem's frozen affine and ReLU), pool2 (2x1x1 / 2x1x1) and
the non-local blocks' 1x2x2 / 1x2x2.

It replaces no TPU kernel: ``lfb_tpu/ops/pooling.py`` pools with XLA's
``reduce_window``.  What bounds it on an H100: bytes.  ``F.max_pool3d`` on
CUDA writes an int64 index for every output, with or without autograd, and
its backward sums with atomics; the kernel writes a uint8 offset within the
window only when autograd will call the backward, and its backward gathers
each input element's gradient from the windows that claim it, in a fixed
order, with no atomics.

The forward gives ``F.max_pool3d``'s numbers bit for bit (ATen's scan order
and rule ``v > m or isnan(v)``: the same value and the same chosen position,
ties and NaN included); the fused stem gives ``max_pool3d(affine_act(x))``'s.
The backward sums a position's gradients in f32, in the order of its
outputs, and rounds once: ATen's where one window claims the position;
where several do, ATen's differs by the roundings of its partial sums,
which it adds in the working type in the order its atomics land.  The plain
versions below compute the same arithmetic with PyTorch operations; the
uint8 offset of a window position is ``(dt * kh + dh) * kw + dw``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from lfb_tpu_torch.ops import cuda_affine, cuda_build
from lfb_tpu_torch.utils.profiling import count

_LAUNCHERS = {torch.float32: 'lfb_max_pool_f32',
              torch.bfloat16: 'lfb_max_pool_bf16'}
_BWD_LAUNCHERS = {torch.float32: 'lfb_max_pool_bwd_f32',
                  torch.bfloat16: 'lfb_max_pool_bwd_bf16'}


def out_shape(shape: Sequence[int], kernels, strides, pads) -> tuple:
    """(B, To, Ho, Wo, C) of a (B, T, H, W, C) input, floor mode."""
    B, *thw, C = shape
    return (B, *((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(thw, kernels, strides, pads)), C)


def _taps(kernels):
    """(offset, dt, dh, dw) of each window position, in scan order."""
    kt, kh, kw = kernels
    return [((dt * kh + dh) * kw + dw, dt, dh, dw)
            for dt in range(kt) for dh in range(kh) for dw in range(kw)]


def _tap_view(t: torch.Tensor, tap, strides, out: Sequence[int]):
    """The (B, To, Ho, Wo, C) view of padded ``t`` that window position
    ``tap`` reads for every output."""
    _, dt, dh, dw = tap
    return t[:, dt:dt + strides[0] * (out[1] - 1) + 1:strides[0],
             dh:dh + strides[1] * (out[2] - 1) + 1:strides[1],
             dw:dw + strides[2] * (out[3] - 1) + 1:strides[2]]


def _first_offsets(out, kernels, strides, pads, device) -> torch.Tensor:
    """(To, Ho, Wo, 1) uint8: the offset where ATen's scan starts, the
    window's first position inside the input."""
    first = [(torch.clamp(torch.arange(n, device=device) * s - p, min=0)
              - (torch.arange(n, device=device) * s - p))
             for n, s, p in zip(out[1:4], strides, pads)]
    _, kh, kw = kernels
    offset = ((first[0][:, None, None] * kh + first[1][None, :, None]) * kw
              + first[2][None, None, :])
    return offset[..., None].to(torch.uint8)


def max_pool_plain(x: torch.Tensor, kernels, strides,
                   pads=(0, 0, 0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, offsets) of a (B, T, H, W, C) max pool: ATen's scan, each window
    position in order from -inf at the first position inside the input,
    taken where ``v > m or isnan(v)``; padding is -inf and never wins."""
    out = out_shape(x.shape, kernels, strides, pads)
    pt, ph, pw = pads
    xp = F.pad(x, (0, 0, pw, pw, ph, ph, pt, pt), value=-math.inf)
    m = x.new_full(out, -math.inf)
    offsets = _first_offsets(out, kernels, strides, pads,
                             x.device).expand(out).clone()
    for tap in _taps(kernels):
        v = _tap_view(xp, tap, strides, out)
        take = (v > m) | v.isnan()
        m = torch.where(take, v, m)
        offsets.masked_fill_(take, tap[0])
    return m, offsets


def max_pool_bwd_plain(dy: torch.Tensor, offsets: torch.Tensor,
                       in_shape: Sequence[int], kernels, strides,
                       pads=(0, 0, 0), y: torch.Tensor | None = None,
                       scale: torch.Tensor | None = None) -> torch.Tensor:
    """dx of :func:`max_pool_plain`: each input position sums, in f32 and in
    the order of its outputs, the dy of the windows whose offset names it,
    rounded once to dy's dtype.  With ``scale`` (the fused stem) that sum g
    goes on through the ReLU and the affine as the composition's backward
    does (``cuda_affine.affine_act_bwd_plain``), gated on the ReLU output
    at the position: the pooled ``y`` of a window that claims it."""
    out = dy.shape
    pt, ph, pw = pads
    B, T, H, W, C = in_shape
    padded = (B, T + 2 * pt, H + 2 * ph, W + 2 * pw, C)
    acc = torch.zeros(padded, dtype=torch.float32, device=dy.device)
    y_at = None if scale is None else torch.zeros(padded, dtype=dy.dtype,
                                                  device=dy.device)
    dyf = dy.float()
    # Window positions from the last: each input position then meets its
    # outputs in (t', h', w') order.
    for tap in reversed(_taps(kernels)):
        hit = offsets == tap[0]
        _tap_view(acc, tap, strides, out).add_(torch.where(hit, dyf, 0.0))
        if y_at is not None:
            _tap_view(y_at, tap, strides, out).copy_(torch.where(
                hit, y, _tap_view(y_at, tap, strides, out)))
    g = acc[:, pt:pt + T, ph:ph + H, pw:pw + W].to(dy.dtype)
    if scale is None:
        return g
    y_at = y_at[:, pt:pt + T, ph:ph + H, pw:pw + W]
    return cuda_affine.affine_act_bwd_plain(g, y_at, scale)[0]


def max_pool_fwd(x: torch.Tensor, kernels, strides, pads, *, save: bool,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None):
    """(y, offsets, or None without ``save``) of the max pool of ``x``, or
    with ``scale`` and ``bias`` of ``relu(affine(x))`` (the stem).  On a CPU
    tensor the plain versions; on a CUDA tensor the kernel, or a ValueError
    for what it does not take."""
    if x.device.type == 'cpu':
        if scale is not None:
            x = cuda_affine.affine_act_plain(x, scale, bias, True)
        y, offsets = max_pool_plain(x, kernels, strides, pads)
        return y, offsets if save else None
    x = x.contiguous()
    out = _check(x, kernels, strides, pads, scale, bias)
    y = torch.empty(out, dtype=x.dtype, device=x.device)
    offsets = (torch.empty(out, dtype=torch.uint8, device=x.device)
               if save else None)
    with torch.cuda.device(x.device):
        cuda_build.launch(_LAUNCHERS[x.dtype], x.data_ptr(), _ptr(scale),
                          _ptr(bias), y.data_ptr(), _ptr(offsets),
                          *_geometry(x.shape, kernels, strides, pads))
    count('kernel.pool.fwd')
    if save:
        count('kernel.pool.fwd_saved')
    return y, offsets


def max_pool_bwd(dy: torch.Tensor, offsets: torch.Tensor,
                 in_shape: Sequence[int], kernels, strides, pads,
                 y: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None) -> torch.Tensor:
    """dx of :func:`max_pool_fwd` (``y`` and ``scale``: the stem's); on a
    CUDA tensor from the kernel, which writes every element once."""
    if dy.device.type == 'cpu':
        return max_pool_bwd_plain(dy, offsets, in_shape, kernels, strides,
                                  pads, y, scale)
    dy = dy.contiguous()
    out = tuple(dy.shape)
    if (dy.dtype not in _BWD_LAUNCHERS
            or out != out_shape(in_shape, kernels, strides, pads)
            or offsets.dtype != torch.uint8 or offsets.shape != dy.shape
            or not offsets.is_contiguous() or offsets.device != dy.device
            or (scale is not None and (y is None or y.shape != dy.shape
                                       or y.dtype != dy.dtype
                                       or not y.is_contiguous()))):
        raise ValueError('max_pool_bwd: dy {} {}, offsets {} {} do not fit '
                         'an input of {}'.format(
                             dy.dtype, out, offsets.dtype,
                             tuple(offsets.shape), tuple(in_shape)))
    if scale is not None:
        _check_vector('scale', scale, in_shape[-1], dy.device)
    dx = torch.empty(tuple(in_shape), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        cuda_build.launch(_BWD_LAUNCHERS[dy.dtype], dy.data_ptr(),
                          offsets.data_ptr(),
                          _ptr(y if scale is not None else None),
                          _ptr(scale), dx.data_ptr(),
                          *_geometry(in_shape, kernels, strides, pads))
    count('kernel.pool.bwd')
    return dx


class MaxPool(torch.autograd.Function):
    """:func:`max_pool_fwd` with its offsets saved and :func:`max_pool_bwd`
    as the gradient of x; the stem's frozen scale and bias get none, as in
    ``cuda_affine.AffineAct``.  Saves with ``save_for_backward``, so a
    non-reentrant checkpoint can drop the offsets and run the region
    again."""

    @staticmethod
    def forward(ctx, x, scale, bias, kernels, strides, pads):
        y, offsets = max_pool_fwd(x, kernels, strides, pads, save=True,
                                  scale=scale, bias=bias)
        ctx.geometry = (tuple(x.shape), kernels, strides, pads)
        stem = scale is not None
        ctx.save_for_backward(offsets, y if stem else None,
                              scale if stem else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        offsets, y, scale = ctx.saved_tensors
        dx = (max_pool_bwd(dy, offsets, *ctx.geometry, y=y, scale=scale)
              if ctx.needs_input_grad[0] else None)
        return dx, None, None, None, None, None


def max_pool(x: torch.Tensor, kernels: Sequence[int], strides: Sequence[int],
             pads: Sequence[int] = (0, 0, 0), *,
             scale: torch.Tensor | None = None,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T, H, W, C) max pool of ``x``, or with the f32 per-channel
    ``scale`` and ``bias`` of ``relu(affine(x))`` (the stem's frozen affine,
    as ``cuda_affine.affine_act``).  The offsets are written, and a
    gradient kept, only where autograd will ask for one: grad mode on and
    ``x`` requiring a gradient."""
    window = tuple(map(int, kernels)), tuple(map(int, strides)), tuple(
        map(int, pads))
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool.apply(x, scale, bias, *window)
    return max_pool_fwd(x, *window, save=False, scale=scale, bias=bias)[0]


def _geometry(shape, kernels, strides, pads):
    """The launchers' (dims, window) int arrays."""
    return ((ctypes.c_int * 5)(*shape),
            (ctypes.c_int * 9)(*kernels, *strides, *pads))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_vector(name, v, C, device):
    if (v is None or v.device != device or v.dtype != torch.float32
            or tuple(v.shape) != (C,) or not v.is_contiguous()):
        raise ValueError('max_pool: {} must be a contiguous float32 ({},) '
                         'tensor on {}'.format(name, C, device))


def _check(x, kernels, strides, pads, scale, bias) -> tuple:
    """Raise ValueError for what the kernel does not take; the output
    shape."""
    if x.dtype not in _LAUNCHERS or x.dim() != 5:
        raise ValueError('max_pool: x must be a (B, T, H, W, C) float32 or '
                         'bfloat16 tensor (got {} {})'.format(
                             x.dtype, tuple(x.shape)))
    if (len(kernels) != 3 or len(strides) != 3 or len(pads) != 3
            or min(kernels) < 1 or min(strides) < 1 or min(pads) < 0
            or any(p > k // 2 for k, p in zip(kernels, pads))
            or math.prod(kernels) > 256):
        raise ValueError('max_pool: window {} / {} / pad {}: at most 256 '
                         'positions, pads at most half the window'.format(
                             kernels, strides, pads))
    out = out_shape(x.shape, kernels, strides, pads)
    if min(out[1:4]) < 1:
        raise ValueError('max_pool: no output from {} under {} / {} / '
                         '{}'.format(tuple(x.shape), kernels, strides, pads))
    if (scale is None) != (bias is None):
        raise ValueError('max_pool: the stem takes both scale and bias')
    if scale is not None:
        for name, v in (('scale', scale), ('bias', bias)):
            _check_vector(name, v, x.shape[-1], x.device)
    return out
