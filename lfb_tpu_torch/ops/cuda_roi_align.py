"""RoIAlign 7x7 + 7x7 max-pool of the AVA head: CUDA kernels
(``csrc/roi_align_maxpool.cu``), their plain PyTorch versions, and the
autograd Function that joins them.

Forward: replaces ``lfb_tpu/ops/pallas_roi_align.py:_fwd_call`` (kernel
``_roi_kernel`` via ``_box_select`` / ``_box_bins``).  Backward: replaces
``pallas_roi_align.py:_bwd_call`` (kernel ``_roi_bwd_kernel``): each
(box, channel) gradient goes to the box's FIRST maximal bin in row-major
order, then through the bilinear weights into the (B, H, W, C) map.

What bounds it on an H100: it is a data-dependent bilinear gather (at most
49 bins x 16 samples x 4 corners per box and channel) over a feature map
that sits in L2, so memory latency, not arithmetic, is the limit.  The TPU
had to express the gather as a one-hot matmul because it cannot index VMEM
per element; here each CTA takes one box and 128 channels, computes the
box's sample positions once in shared memory, and lets each thread walk the
bins for its channel with coalesced NHWC reads, keeping a running max.  All
of it is f32 (the TPU needed ``Precision.HIGHEST`` so near-tie max bins
would not flip).  The backward kernel gives each (batch element, 128
channels) to one CTA, which walks that element's boxes in proposal order,
recomputes each box's bin means with the forward's code to find the max
bin, and scatters into its own channels: no atomics, any box order.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.pooling import max_pool_2d
from lfb_tpu_torch.ops.roi_align import roi_align

# Launches of the CUDA kernels since the last reset (the chip smoke reads
# them).
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_POOLED = 16


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
    out = torch.empty((N, C), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        cuda_build.launch('lfb_roi_align_maxpool', features.data_ptr(),
                          rois.data_ptr(), out.data_ptr(), B, H, W, C, N,
                          pooled, float(spatial_scale))
    global LAUNCHES
    LAUNCHES += 1
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
    dfmap = torch.zeros_like(features)
    with torch.cuda.device(features.device):
        cuda_build.launch('lfb_roi_align_maxpool_bwd', features.data_ptr(),
                          rois.data_ptr(), dout.data_ptr(), dfmap.data_ptr(),
                          B, H, W, C, N, pooled, float(spatial_scale))
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
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
    if rois.shape[1] != 5 or not 1 <= rois.shape[0] <= 65535:
        raise ValueError('roi_align_maxpool: rois must be (N, 5) with 1 <= N '
                         '<= 65535 (got {})'.format(tuple(rois.shape)))
    if dout is not None and tuple(dout.shape) != (rois.shape[0],
                                                  features.shape[-1]):
        raise ValueError('roi_align_maxpool: dout must be (N, C) = {} (got '
                         '{})'.format((rois.shape[0], features.shape[-1]),
                                      tuple(dout.shape)))
    if dout is not None and features.shape[0] > 65535:
        raise ValueError('roi_align_maxpool: at most 65535 batch elements')
    if not 1 <= pooled <= MAX_POOLED or min(features.shape) < 1:
        raise ValueError('roi_align_maxpool: unsupported pooled={} or features '
                         '{}'.format(pooled, tuple(features.shape)))
