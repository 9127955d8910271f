"""RoIAlign 7x7 + 7x7 max-pool of the AVA head: CUDA kernels
(``csrc/roi_align_maxpool.cu``), their plain PyTorch versions, and the
autograd Function that joins them.

Forward: replaces ``lfb_tpu/ops/pallas_roi_align.py:_fwd_call`` (kernel
``_roi_kernel`` via ``_box_select`` / ``_box_bins``).  Backward: replaces
``pallas_roi_align.py:_bwd_call`` (kernel ``_roi_bwd_kernel``): each
(box, channel) gradient goes to the box's FIRST maximal bin in row-major
order, then through the bilinear weights into the (B, H, W, C) map.

What bounds it on an H100: bytes, the map pixels the boxes reach read once
(and in the backward the whole gradient map written once); the arithmetic
is a few hundred f32 operations per box and channel.  The TPU had to express
the gather as a one-hot matmul because it cannot index VMEM per element.
Here one CTA per (batch element, chunk of channels) copies its slice of the
map into shared memory once, finds its own boxes among the rois in proposal
order, and forms every bin from shared memory, so a pixel leaves device
memory once however many boxes and samples reach it.  :func:`channel_chunk`
picks the chunk so the slice fits; a map too large for the smallest chunk
is refused.  All of it is f32 (the TPU needed ``Precision.HIGHEST`` so
near-tie max bins would not flip).  The backward reuses the slice's buffer
for its slice of the gradient, scatters box after box with one writer per
element (no atomics, repeatable bit for bit), and writes the slice out
once, so the gradient map needs no zero fill.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.pooling import max_pool_2d
from lfb_tpu_torch.ops.roi_align import roi_align
from lfb_tpu_torch.utils.profiling import count

MAX_POOLED = 16
# Channels per CTA, in order of preference.  Beside the map slice the 8
# warps' partials for 4 boxes (4 bytes a channel each), and the sample
# tables of 4 boxes, as ``roi_align_maxpool.cu`` lays them out.
CHUNKS = (64, 32, 16, 8)
SMEM_PREFERRED = 64 * 1024
SMEM_MAX = 227 * 1024 - 3 * 1024        # less the kernels' static arrays


def smem_bytes(H: int, W: int, chunk: int, backward: bool,
               pooled: int = 7) -> int:
    """Dynamic shared memory of one CTA: the map slice (and in the backward
    its gradient accumulator), the partials and the tables (``fwd_smem`` /
    ``bwd_smem`` of the source)."""
    tables = 4 * (2 * pooled * (4 * 16 + 4) + 4)
    return chunk * (H * W + (2 if backward else 1) * 4 * 8) * 4 + tables


def channel_chunk(H: int, W: int, C: int, backward: bool,
                  pooled: int = 7) -> int:
    """Channels per CTA: the largest of :data:`CHUNKS` (none twice as wide
    as C) whose slices take at most SMEM_PREFERRED bytes, so several CTAs
    share an SM; else the smallest that fits.  Raises ValueError for a map
    whose slice does not fit at 8 channels."""
    fits = [cc for cc in CHUNKS if (cc == CHUNKS[-1] or cc // 2 < C)
            and smem_bytes(H, W, cc, backward, pooled) <= SMEM_MAX]
    if not fits:
        raise ValueError('roi_align_maxpool: a {} x {} map does not fit in '
                         'shared memory (at most {} bytes, {} needed at {} '
                         'channels)'.format(H, W, SMEM_MAX, smem_bytes(
                             H, W, CHUNKS[-1], backward, pooled), CHUNKS[-1]))
    preferred = [cc for cc in fits if H * W * cc * 4 <= SMEM_PREFERRED]
    return preferred[0] if preferred else fits[-1]


def roi_align_maxpool_plain(features: torch.Tensor, rois: torch.Tensor,
                            pooled: int = 7,
                            spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """RoIAlign (sampling_ratio 0) then the pooled x pooled max -> (N, C)."""
    bins = roi_align(features, rois, pooled_h=pooled, pooled_w=pooled,
                     spatial_scale=spatial_scale, sampling_ratio=0)
    if pooled > 1:
        bins = max_pool_2d(bins, (pooled, pooled), (1, 1))
    return bins.reshape(bins.shape[0], bins.shape[-1])


def roi_align_maxpool_bwd_plain(features: torch.Tensor, rois: torch.Tensor,
                                dout: torch.Tensor, pooled: int = 7,
                                spatial_scale: float = 1.0 / 16.0
                                ) -> torch.Tensor:
    """d features (B, H, W, C) f32 of :func:`roi_align_maxpool_plain` for
    the output gradient ``dout`` (N, C): each (box, channel) gradient goes
    to the first maximal bin in row-major bin order (``torch.argmax`` takes
    the first), then back through RoIAlign's bilinear weights, every box
    adding into its batch element's map."""
    with torch.enable_grad():
        f = features.detach().float().requires_grad_(True)
        bins = roi_align(f, rois, pooled_h=pooled, pooled_w=pooled,
                         spatial_scale=spatial_scale, sampling_ratio=0)
        bins = bins.reshape(bins.shape[0], pooled * pooled, bins.shape[-1])
        first = bins.detach().argmax(dim=1, keepdim=True)       # (N, 1, C)
        g = torch.zeros_like(bins).scatter_(1, first, dout.float()[:, None])
        dfmap, = torch.autograd.grad(bins, f, g)
    return dfmap


def roi_align_maxpool(features: torch.Tensor, rois: torch.Tensor, *,
                      pooled: int = 7,
                      spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """(B, H, W, C) f32 features + (N, 5) f32 rois [batch_idx, x1, y1, x2,
    y2] -> (N, C) f32.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if features.device.type == 'cpu':
        return roi_align_maxpool_plain(features, rois, pooled, spatial_scale)
    _check(features, rois, pooled)
    B, H, W, C = features.shape
    N = rois.shape[0]
    chunk = channel_chunk(H, W, C, backward=False, pooled=pooled)
    out = torch.empty((N, C), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        cuda_build.launch('lfb_roi_align_maxpool', features.data_ptr(),
                          rois.data_ptr(), out.data_ptr(), B, H, W, C, N,
                          pooled, float(spatial_scale), chunk,
                          _vec(features))
    count('kernel.roi_align.fwd')
    return out


def roi_align_maxpool_bwd(features: torch.Tensor, rois: torch.Tensor,
                          dout: torch.Tensor, *, pooled: int = 7,
                          spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """d features (B, H, W, C) f32 for the output gradient ``dout`` (N, C)
    f32.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if features.device.type == 'cpu':
        return roi_align_maxpool_bwd_plain(features, rois, dout, pooled,
                                           spatial_scale)
    _check(features, rois, pooled, dout=dout)
    B, H, W, C = features.shape
    N = rois.shape[0]
    chunk = channel_chunk(H, W, C, backward=True, pooled=pooled)
    dfmap = torch.empty_like(features)      # the kernel writes every element
    with torch.cuda.device(features.device):
        cuda_build.launch('lfb_roi_align_maxpool_bwd', features.data_ptr(),
                          rois.data_ptr(), dout.data_ptr(), dfmap.data_ptr(),
                          B, H, W, C, N, pooled, float(spatial_scale), chunk,
                          _vec(features))
    count('kernel.roi_align.bwd')
    return dfmap


class RoIAlignMaxPool(torch.autograd.Function):
    """Differentiable RoIAlign + max-pool, as lfb_tpu's custom VJP
    (``pallas_roi_align.py:255-272``): the features get a gradient, the rois
    none (they are data, and the reference op defines no coordinate
    gradient)."""

    @staticmethod
    def forward(ctx, features, rois, pooled, spatial_scale):
        if ctx.needs_input_grad[0]:
            ctx.pooled, ctx.spatial_scale = pooled, spatial_scale
            ctx.save_for_backward(features, rois)
        return roi_align_maxpool(features, rois, pooled=pooled,
                                 spatial_scale=spatial_scale)

    @staticmethod
    def backward(ctx, dout):
        features, rois = ctx.saved_tensors
        dfmap = roi_align_maxpool_bwd(features, rois, dout.float().contiguous(),
                                      pooled=ctx.pooled,
                                      spatial_scale=ctx.spatial_scale)
        return dfmap.to(features.dtype), None, None, None


def _vec(features) -> int:
    """1 where the kernels may move the map in 16-byte pieces."""
    return int(features.shape[-1] % 4 == 0 and features.data_ptr() % 16 == 0)


def _check(features, rois, pooled, dout=None) -> None:
    tensors = [('features', features, 4), ('rois', rois, 2)]
    if dout is not None:
        tensors.append(('dout', dout, 2))
    for name, t, ndim in tensors:
        if not t.is_cuda or t.device != features.device:
            raise ValueError('roi_align_maxpool: {} must be on {} (got '
                             '{})'.format(name, features.device, t.device))
        if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
            raise ValueError('roi_align_maxpool: {} must be a contiguous {}-D '
                             'float32 tensor'.format(name, ndim))
    if rois.shape[1] != 5 or rois.shape[0] < 1:
        raise ValueError('roi_align_maxpool: rois must be (N, 5) with N >= 1 '
                         '(got {})'.format(tuple(rois.shape)))
    if dout is not None and tuple(dout.shape) != (rois.shape[0],
                                                  features.shape[-1]):
        raise ValueError('roi_align_maxpool: dout must be (N, C) = {} (got '
                         '{})'.format((rois.shape[0], features.shape[-1]),
                                      tuple(dout.shape)))
    if features.shape[0] > 65535:
        raise ValueError('roi_align_maxpool: at most 65535 batch elements')
    if not 1 <= pooled <= MAX_POOLED or min(features.shape) < 1:
        raise ValueError('roi_align_maxpool: unsupported pooled={} or features '
                         '{}'.format(pooled, tuple(features.shape)))
