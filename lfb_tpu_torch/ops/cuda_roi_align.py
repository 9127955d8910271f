"""RoIAlign 7x7 + 7x7 max-pool of the AVA head: CUDA kernel
(``csrc/roi_align_maxpool.cu``) and its plain PyTorch version.

Replaces ``lfb_tpu/ops/pallas_roi_align.py:_fwd_call`` (kernel
``_roi_kernel`` via ``_box_select`` / ``_box_bins``), forward only.

What bounds it on an H100: it is a data-dependent bilinear gather (at most
49 bins x 16 samples x 4 corners per box and channel) over a feature map
that sits in L2, so memory latency, not arithmetic, is the limit.  The TPU
had to express the gather as a one-hot matmul because it cannot index VMEM
per element; here each CTA takes one box and 128 channels, computes the
box's sample positions once in shared memory, and lets each thread walk the
bins for its channel with coalesced NHWC reads, keeping a running max.  All
of it is f32 (the TPU needed ``Precision.HIGHEST`` so near-tie max bins
would not flip).
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import cuda_build
from lfb_tpu_torch.ops.pooling import max_pool_2d
from lfb_tpu_torch.ops.roi_align import roi_align

# Launches of the CUDA kernel since the last reset (the chip smoke reads it).
LAUNCHES = 0

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


def _check(features, rois, pooled) -> None:
    for name, t, ndim in (('features', features, 4), ('rois', rois, 2)):
        if not t.is_cuda or t.device != features.device:
            raise ValueError('roi_align_maxpool: {} must be on {} (got '
                             '{})'.format(name, features.device, t.device))
        if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
            raise ValueError('roi_align_maxpool: {} must be a contiguous {}-D '
                             'float32 tensor'.format(name, ndim))
    if rois.shape[1] != 5 or not 1 <= rois.shape[0] <= 65535:
        raise ValueError('roi_align_maxpool: rois must be (N, 5) with 1 <= N '
                         '<= 65535 (got {})'.format(tuple(rois.shape)))
    if not 1 <= pooled <= MAX_POOLED or min(features.shape) < 1:
        raise ValueError('roi_align_maxpool: unsupported pooled={} or features '
                         '{}'.format(pooled, tuple(features.shape)))
