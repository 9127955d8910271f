"""The frozen-BN affine of the unfused blocks with the shortcut and the ReLU
that follow it: a CUDA kernel pair (``csrc/affine_act.cu``), their plain
PyTorch versions, and the autograd Function that joins them.

``y = act(x * scale + bias [+ residual | + (residual * residual_scale +
residual_bias)])`` over channels-last tensors, ``act`` ReLU or the
identity: a bottleneck's 2a and 2b, its 2c with the identity or
``branch1``'s affine shortcut and the final ReLU, and a non-local block's
affine + residual, each as one pass over the activation (on the card the
stem's affine + ReLU runs fused into pool1, ``ops/cuda_pool.py``).

It replaces no TPU kernel: XLA folds the affine, the add and the ReLU into
the convolution's epilogue (``lfb_tpu/ops/affine.py``).  The plain version
is the composition that the port ran before it (:func:`affine_nd`, ``+``,
``F.relu``), and the kernel gives its numbers bit for bit: the same
operations in f32, each rounded to the working type, in the same order.

What bounds it on an H100: bytes.  One read of x (and of the residual) and
one write of y, 16 bytes a thread, against PyTorch's two broadcast passes
for the affine (and two more for a projection shortcut), a pass for the
add and one for the ReLU.

The backward is a kernel too: ``g = threshold_backward(dy, y, 0)`` (dy with
no ReLU), ``dx = g * scale`` and, for an affine shortcut, ``g *
residual_scale``, each rounded to the working type, as autograd computes
them through the composition; an identity shortcut's gradient is g.  The
scales and biases get none: they are frozen, as the reference's
``AffineNdGradient`` gives them none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.affine import affine_nd
from lfb_tpu_torch.utils.profiling import count

_LAUNCHERS = {torch.float32: 'lfb_affine_act_f32',
              torch.bfloat16: 'lfb_affine_act_bf16'}
_BWD_LAUNCHERS = {torch.float32: 'lfb_affine_act_bwd_f32',
                  torch.bfloat16: 'lfb_affine_act_bwd_bf16'}
# The kernels' shortcut codes.
_NONE, _IDENTITY, _AFFINE = 0, 1, 2


def affine_act_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, relu: bool,
                     residual: torch.Tensor | None = None,
                     residual_scale: torch.Tensor | None = None,
                     residual_bias: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """The composition: ``affine_nd``, the shortcut added, ``F.relu``."""
    y = affine_nd(x, scale, bias)
    if residual is not None:
        if residual_scale is not None:
            residual = affine_nd(residual, residual_scale, residual_bias)
        y = y + residual
    return F.relu(y) if relu else y


def affine_act_bwd_plain(dy: torch.Tensor, y: torch.Tensor | None,
                         scale: torch.Tensor,
                         residual_scale: torch.Tensor | None = None):
    """(dx, g, d residual before its affine or None) of
    :func:`affine_act_plain` for the output gradient ``dy``, as autograd
    forms them: ``g`` is relu's ``threshold_backward`` of dy on the output
    ``y`` (dy itself when ``y`` is None: no ReLU), then each multiply's
    backward."""
    g = dy if y is None else torch.ops.aten.threshold_backward(dy, y, 0)
    dx = g * scale.to(g.dtype)
    dr = None if residual_scale is None else g * residual_scale.to(g.dtype)
    return dx, g, dr


def affine_act_fwd(x, scale, bias, relu, residual=None, residual_scale=None,
                   residual_bias=None) -> torch.Tensor:
    """:func:`affine_act_plain` on a CPU tensor; on a CUDA tensor the kernel,
    or a ValueError for what it does not take."""
    if x.device.type == 'cpu':
        return affine_act_plain(x, scale, bias, relu, residual,
                                residual_scale, residual_bias)
    shortcut = (_NONE if residual is None else
                _IDENTITY if residual_scale is None else _AFFINE)
    _check(x, [('scale', scale), ('bias', bias)], residual,
           [('residual_scale', residual_scale),
            ('residual_bias', residual_bias)] if shortcut == _AFFINE else [])
    y = torch.empty_like(x)
    C = x.shape[-1]
    with torch.cuda.device(x.device):
        cuda_build.launch(_LAUNCHERS[x.dtype], x.data_ptr(), _ptr(residual),
                          scale.data_ptr(), bias.data_ptr(),
                          _ptr(residual_scale), _ptr(residual_bias),
                          y.data_ptr(), x.numel() // C, C, shortcut, int(relu))
    count('kernel.affine.fwd')
    return y


def affine_act_bwd(dy, y, scale, residual_scale=None, *, need_dx=True,
                   need_g=True):
    """(dx, g, dr) of :func:`affine_act_bwd_plain`; on a CUDA tensor from the
    kernel, which writes dx only with ``need_dx``, g (with a ReLU) only with
    ``need_g`` and dr only with ``residual_scale`` (None for what it does
    not write; without a ReLU g is dy itself)."""
    if dy.device.type == 'cpu':
        return affine_act_bwd_plain(dy, y, scale, residual_scale)
    dy = dy.contiguous()
    _check(dy, [('scale', scale)], y,
           [('residual_scale', residual_scale)]
           if residual_scale is not None else [], names=('dy', 'y'))
    dx = torch.empty_like(dy) if need_dx else None
    g = torch.empty_like(dy) if need_g and y is not None else None
    dr = torch.empty_like(dy) if residual_scale is not None else None
    C = dy.shape[-1]
    with torch.cuda.device(dy.device):
        cuda_build.launch(_BWD_LAUNCHERS[dy.dtype], dy.data_ptr(), _ptr(y),
                          scale.data_ptr(), _ptr(residual_scale), _ptr(dx),
                          _ptr(g), _ptr(dr), dy.numel() // C, C,
                          int(y is not None))
    count('kernel.affine.bwd')
    return dx, (dy if y is None else g), dr


class AffineAct(torch.autograd.Function):
    """:func:`affine_act_fwd` with :func:`affine_act_bwd` as its gradient:
    x and the residual get one, the scales and biases none.  Saves the
    output (the ReLU's mask) and the scales with ``save_for_backward``, so
    a non-reentrant checkpoint can drop them and run the region again."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, residual_scale, residual_bias,
                relu):
        y = affine_act_fwd(x, scale, bias, relu, residual, residual_scale,
                           residual_bias)
        ctx.affine_shortcut = residual_scale is not None
        ctx.save_for_backward(y if relu else None, scale,
                              residual_scale if ctx.affine_shortcut else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, scale, residual_scale = ctx.saved_tensors
        need_x, _, _, need_r = ctx.needs_input_grad[:4]
        if not (need_x or need_r):
            return (None,) * 7
        dx, g, dr = affine_act_bwd(
            dy, y, scale, residual_scale if need_r else None, need_dx=need_x,
            need_g=need_r and not ctx.affine_shortcut)
        dres = (dr if ctx.affine_shortcut else g) if need_r else None
        return dx if need_x else None, None, None, dres, None, None, None


def affine_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               relu: bool, residual: torch.Tensor | None = None,
               residual_scale: torch.Tensor | None = None,
               residual_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``act(affine(x) [+ residual | + affine(residual)])`` over
    channels-last ``x`` and ``residual`` of one shape and dtype, with f32
    per-channel ``scale`` and ``bias`` (and ``residual_scale``,
    ``residual_bias`` for a projection shortcut); ``act`` is ReLU with
    ``relu``.  A CPU tensor takes the plain versions, a CUDA tensor the
    kernels."""
    return AffineAct.apply(x, scale, bias, residual, residual_scale,
                           residual_bias, relu)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check(x, vectors, other, other_vectors, names=('x', 'residual')):
    """x and ``other`` (None or x's twin) contiguous CUDA tensors of f32 or
    bf16 on one device; each vector a contiguous f32 (C,) tensor there."""
    C = x.shape[-1] if x.dim() else 0
    if x.dtype not in _LAUNCHERS or not x.is_contiguous() or C < 1:
        raise ValueError('affine_act: {} must be a contiguous float32 or '
                         'bfloat16 tensor with channels (got {} {})'.format(
                             names[0], x.dtype, tuple(x.shape)))
    if other is not None and (other.device != x.device
                              or other.dtype != x.dtype
                              or other.shape != x.shape
                              or not other.is_contiguous()):
        raise ValueError('affine_act: {} must be a contiguous {} {} tensor on '
                         '{} (got {} {} on {})'.format(
                             names[1], tuple(x.shape), x.dtype, x.device,
                             tuple(other.shape), other.dtype, other.device))
    for name, v in vectors + other_vectors:
        if (v is None or v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != (C,) or not v.is_contiguous()):
            raise ValueError('affine_act: {} must be a contiguous float32 '
                             '({},) tensor on {}'.format(name, C, x.device))
