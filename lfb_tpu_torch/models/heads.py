"""Output heads (port of ``lfb_tpu/models/heads.py``; reference
``lib/models/head_helper.py``): clip-level global pooling (Charades/EPIC)
and box-level RoIAlign pooling (AVA)."""

from __future__ import annotations

import torch
import torch.nn as nn

from lfb_tpu_torch.models.spec import ModelSpec
from lfb_tpu_torch.ops.cuda_roi_align import RoIAlignMaxPool


def basic_head(spec: ModelSpec, features: torch.Tensor) -> torch.Tensor:
    """Global average pool -> (B, 2048) f32, accumulated in f32 as the
    features are read (no f32 copy of the map).  The reference pools with
    kernel [TRAIN.VIDEO_LENGTH/2, S, S] (``head_helper.py:37-40``), which is
    a global mean when the temporal extent matches."""
    T = features.shape[1]
    if T != spec.pool_stride:
        raise ValueError('head temporal extent {} != TRAIN.VIDEO_LENGTH/2 = '
                         '{}'.format(T, spec.pool_stride))
    return features.mean(dim=(1, 2, 3), dtype=torch.float32)


class TemporalMean(torch.autograd.Function):
    """(B, T, H, W, C) features -> their f32 mean over T, accumulated in f32
    as the features are read (no f32 copy of the map).  The gradient is
    d out / T in the features' dtype, formed on the (B, H, W, C) gradient and
    broadcast over T as a view: the values autograd's mean backward and cast
    give, without writing the (B, T, H, W, C) gradient in f32 and again in
    the features' dtype."""

    @staticmethod
    def forward(ctx, features):
        ctx.t, ctx.dtype = features.shape[1], features.dtype
        return features.mean(dim=1, dtype=torch.float32)

    @staticmethod
    def backward(ctx, dout):
        grad = (dout / ctx.t).to(ctx.dtype).unsqueeze(1)
        return grad.expand(-1, ctx.t, -1, -1, -1)


class RoIHead(nn.Module):
    """Temporal mean (:class:`TemporalMean`, f32) -> RoIAlign(7x7, 1/16,
    adaptive sampling) -> 7x7 max -> (N, 2048) (reference
    ``head_helper.py:61-123``); the same in training, where the features'
    gradient comes from the backward kernel."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec

    def forward(self, features: torch.Tensor,
                proposals: torch.Tensor) -> torch.Tensor:
        """``features`` (B, T, H, W, C) res5 output; ``proposals`` (N, 5)
        rows [batch_idx, x1, y1, x2, y2] in input pixels (zero rows for
        padding pool a corner and are harmless)."""
        fmap = TemporalMean.apply(features)
        return RoIAlignMaxPool.apply(fmap, proposals.float().contiguous(),
                                     self.spec.roi_resolution,
                                     self.spec.roi_spatial_scale)
