"""Max pooling over channels-last tensors (port of
``lfb_tpu/ops/pooling.py``).  Padding never wins (PyTorch pads max pooling
with -inf) and output sizes use floor mode, as in Caffe2/cuDNN pooling
(pool1 [1,3,3]/[1,2,2]/pad[0,1,1], reference
``lib/models/resnet_video.py:190-196``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def max_pool_3d(x: torch.Tensor, kernels: Sequence[int],
                strides: Sequence[int],
                pads: Sequence[int] = (0, 0, 0)) -> torch.Tensor:
    """(B, T, H, W, C) max pool."""
    out = F.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(kernels),
                       tuple(strides), tuple(pads))
    return out.permute(0, 2, 3, 4, 1).contiguous()


def max_pool_2d(x: torch.Tensor, kernels: Sequence[int],
                strides: Sequence[int],
                pads: Sequence[int] = (0, 0)) -> torch.Tensor:
    """(B, H, W, C) max pool (the RoI head's 7x7 -> 1x1 reduction,
    reference ``lib/models/head_helper.py:112-115``)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(kernels), tuple(strides),
                       tuple(pads))
    return out.permute(0, 2, 3, 1).contiguous()
