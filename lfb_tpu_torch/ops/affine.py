"""Frozen-BN channel affine ``y = x * scale + bias`` (port of
``lfb_tpu/ops/affine.py``; reference ``AffineNd``,
``caffe2_customized_ops/video/affine_nd_op.cu:32-58``).  Inference only, so
the frozen-gradient semantics need no code here."""

from __future__ import annotations

import torch


def affine_nd(x: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Per-channel affine over a channels-last tensor of any rank."""
    return x * scale.to(x.dtype) + bias.to(x.dtype)
