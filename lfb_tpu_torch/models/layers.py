"""Parameter initialization and inference-time norms (port of
``lfb_tpu/models/layers.py``).

Parameters live in one flat ``{name: tensor}`` mapping keyed by the
reference's Caffe2 blob names (``conv1_w``, ``res4_5_branch2a_bn_s``,
``nonlocal_conv3_1_theta_w``, ``pred_w``...), in the Caffe2 layout, which is
PyTorch's own:

  * conv kernels: (Cout, Cin, kT, kH, kW)
  * FC weights:   (Cout, Cin)
  * norm scale/bias/running stats: (C,)
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from lfb_tpu_torch.ops.affine import affine_nd

Params = Dict[str, torch.Tensor]


def msra_init(shape, generator: torch.Generator) -> torch.Tensor:
    """He-normal on fan_in, Caffe2 MSRAFill (reference
    ``model_builder_video.py:184``); fan_in = Cin * kT * kH * kW."""
    std = math.sqrt(2.0 / math.prod(shape[1:]))
    return gaussian_init(shape, std, generator)


def gaussian_init(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device) * std


def init_conv(params: Params, name: str, kt: int, kh: int, kw: int, cin: int,
              cout: int, *, generator: torch.Generator,
              std: float | None = None, zero: bool = False,
              bias: bool = False) -> None:
    """Add conv weight (and optional bias) named ``{name}_w`` / ``{name}_b``."""
    shape = (cout, cin, kt, kh, kw)
    if zero:
        w = torch.zeros(shape, device=generator.device)
    elif std is not None:
        w = gaussian_init(shape, std, generator)
    else:
        w = msra_init(shape, generator)
    params[name + '_w'] = w
    if bias:
        params[name + '_b'] = torch.zeros((cout,), device=generator.device)


def init_norm(params: Params, name: str, dim: int, *, use_affine: bool,
              device: torch.device, gamma_init: float = 1.0) -> None:
    """Add norm params ``{name}_s`` / ``{name}_b`` (+ running stats for true
    BN).  ``name`` already ends in ``_bn``."""
    params[name + '_s'] = torch.full((dim,), gamma_init, device=device)
    params[name + '_b'] = torch.zeros((dim,), device=device)
    if not use_affine:
        params[name + '_rm'] = torch.zeros((dim,), device=device)
        params[name + '_riv'] = torch.ones((dim,), device=device)


def apply_norm(params: Mapping[str, torch.Tensor], name: str, x: torch.Tensor,
               *, use_affine: bool, epsilon: float) -> torch.Tensor:
    """Frozen affine (reference AffineNd) or inference-mode SpatialBN over
    channels-last ``x``."""
    scale = params[name + '_s']
    bias = params[name + '_b']
    if use_affine:
        return affine_nd(x, scale, bias)
    inv = torch.rsqrt(params[name + '_riv'] + epsilon) * scale
    return ((x.float() - params[name + '_rm']) * inv + bias).to(x.dtype)


def layer_norm(x: torch.Tensor, *, epsilon: float = 1e-3) -> torch.Tensor:
    """Affine-free LayerNorm over the channel (last) axis, as Caffe2's
    LayerNorm in FBO-NL (reference ``lib/models/lfb_helper.py:160-167``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
