"""Max pooling over channels-last tensors (port of
``lfb_tpu/ops/pooling.py``).  Padding never wins (PyTorch pads max pooling
with -inf) and output sizes use floor mode, as in Caffe2/cuDNN pooling
(pool1 [1,3,3]/[1,2,2]/pad[0,1,1], reference
``lib/models/resnet_video.py:190-196``).  On a CUDA tensor the 3-D pools
run the channels-last kernel of ``ops/cuda_pool.py``, with the same
numbers."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from lfb_tpu_torch.ops import cuda_pool
from lfb_tpu_torch.ops.cuda_affine import affine_act


def max_pool_3d(x: torch.Tensor, kernels: Sequence[int],
                strides: Sequence[int],
                pads: Sequence[int] = (0, 0, 0)) -> torch.Tensor:
    """(B, T, H, W, C) max pool: ``F.max_pool3d`` on a CPU tensor, the
    kernel (``cuda_pool.max_pool``) on a CUDA tensor."""
    if x.device.type != 'cpu':
        return cuda_pool.max_pool(x, kernels, strides, pads)
    out = F.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(kernels),
                       tuple(strides), tuple(pads))
    return out.permute(0, 2, 3, 4, 1).contiguous()


def affine_relu_max_pool_3d(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, kernels: Sequence[int],
                            strides: Sequence[int],
                            pads: Sequence[int] = (0, 0, 0)) -> torch.Tensor:
    """``max_pool_3d(affine_act(x, scale, bias, relu=True), ...)``, the
    stem's frozen affine, ReLU and pool1: that composition on a CPU tensor,
    one fused kernel on a CUDA tensor (the same numbers)."""
    if x.device.type != 'cpu':
        return cuda_pool.max_pool(x, kernels, strides, pads, scale=scale,
                                  bias=bias)
    return max_pool_3d(affine_act(x, scale, bias, relu=True), kernels,
                       strides, pads)


def max_pool_2d(x: torch.Tensor, kernels: Sequence[int],
                strides: Sequence[int],
                pads: Sequence[int] = (0, 0)) -> torch.Tensor:
    """(B, H, W, C) max pool (the RoI head's 7x7 -> 1x1 reduction,
    reference ``lib/models/head_helper.py:112-115``)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(kernels), tuple(strides),
                       tuple(pads))
    return out.permute(0, 2, 3, 1).contiguous()
