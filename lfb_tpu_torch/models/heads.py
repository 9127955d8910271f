"""Output heads (port of ``lfb_tpu/models/heads.py``; reference
``lib/models/head_helper.py``): clip-level global pooling (Charades/EPIC)
and box-level RoIAlign pooling (AVA)."""

from __future__ import annotations

import torch
import torch.nn as nn

from lfb_tpu_torch.models.spec import ModelSpec
from lfb_tpu_torch.ops.cuda_roi_align import roi_align_maxpool


def basic_head(spec: ModelSpec, features: torch.Tensor) -> torch.Tensor:
    """Global average pool -> (B, 2048) f32.  The reference pools with
    kernel [TRAIN.VIDEO_LENGTH/2, S, S] (``head_helper.py:37-40``), which is
    a global mean when the temporal extent matches."""
    T = features.shape[1]
    if T != spec.pool_stride:
        raise ValueError('head temporal extent {} != TRAIN.VIDEO_LENGTH/2 = '
                         '{}'.format(T, spec.pool_stride))
    return features.float().mean(dim=(1, 2, 3))


class RoIHead(nn.Module):
    """Temporal mean (f32) -> RoIAlign(7x7, 1/16, adaptive sampling) -> 7x7
    max -> (N, 2048) (reference ``head_helper.py:61-123``)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec

    def forward(self, features: torch.Tensor,
                proposals: torch.Tensor) -> torch.Tensor:
        """``features`` (B, T, H, W, C) res5 output; ``proposals`` (N, 5)
        rows [batch_idx, x1, y1, x2, y2] in input pixels (zero rows for
        padding pool a corner and are harmless)."""
        fmap = features.float().mean(dim=1)
        return roi_align_maxpool(fmap, proposals.float().contiguous(),
                                 pooled=self.spec.roi_resolution,
                                 spatial_scale=self.spec.roi_spatial_scale)
