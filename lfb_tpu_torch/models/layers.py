"""Parameter initialization, norms and dropout (port of
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
from typing import Dict, Mapping, Tuple

import torch

from lfb_tpu_torch.ops.affine import affine_nd
from lfb_tpu_torch.parallel import mesh

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
               *, use_affine: bool, epsilon: float, train: bool = False,
               bn_updates: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
               | None = None) -> torch.Tensor:
    """Frozen affine (reference AffineNd) or SpatialBN over channels-last
    ``x`` (``lfb_tpu/models/layers.py:84-110``).

    In training with true BN the batch's per-channel mean and population
    variance normalize (:class:`BatchNorm`; over every rank of a process
    group), and the (mean, var) pair is recorded under ``name`` in
    ``bn_updates`` for the running-statistic update and precise BN.
    Otherwise the running statistics ``_rm`` / ``_riv`` do."""
    scale = params[name + '_s']
    bias = params[name + '_b']
    if use_affine:
        return affine_nd(x, scale, bias)
    if train:
        y, mean, var = BatchNorm.apply(x, scale, bias, epsilon)
        if bn_updates is not None:
            bn_updates[name] = (mean, var)
        return y
    inv = torch.rsqrt(params[name + '_riv'] + epsilon) * scale
    return ((x.float() - params[name + '_rm']) * inv + bias).to(x.dtype)


class BatchNorm(torch.autograd.Function):
    """SpatialBN with batch statistics over channels-last ``x``: the mean
    and the population variance of each channel, taken in f32 over every
    axis but the last and over every rank (two passes, as ``jnp.var``:
    the mean first, then the mean squared deviation), normalize ``x``,
    and the result is cast back to ``x``'s dtype.  Returns (y, mean, var).

    In a process group the statistics are global, as ``lfb_tpu``'s mesh
    computes them (the reference's are per GPU): the forward all-reduces
    the per-channel sums and counts, and the backward the per-channel sums
    of the incoming gradient g and of g * x_hat, which is that all-reduce's
    own backward.  Each rank's dx is then the whole loss's gradient of its
    shard, and the scale and bias get the rank's own sums, which the
    step's gradient all-reduce adds up.  The backward keeps only ``x`` (in
    its own dtype) and the f32 per-channel mean and inverse std, and
    recomputes x_hat."""

    @staticmethod
    def forward(ctx, x, scale, bias, epsilon):
        c = x.shape[-1]
        xf = x.reshape(-1, c).float()
        sums = mesh.all_sum(torch.cat([xf.sum(0),
                                       xf.new_full((1,), xf.shape[0])]))
        count = sums[c:]
        mean = sums[:c] / count
        centered = xf - mean
        del xf
        var = mesh.all_sum(centered.square().sum(0)) / count
        rstd = torch.rsqrt(var + epsilon)
        y = centered.mul_(rstd * scale).add_(bias).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, scale, count)
        ctx.mark_non_differentiable(mean, var)
        return y.reshape(x.shape), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, rstd, scale, count = ctx.saved_tensors
        c = x.shape[-1]
        g = gy.reshape(-1, c).float()
        xhat = (x.reshape(-1, c).float() - mean).mul_(rstd)
        local = torch.cat([g.sum(0), (g * xhat).sum(0)])
        total = mesh.all_sum(local.clone()) / count
        dx = g.sub(total[:c]).sub_(xhat.mul_(total[c:])).mul_(rstd * scale)
        _, need_scale, need_bias, _ = ctx.needs_input_grad
        return (dx.to(x.dtype).reshape(x.shape),
                local[c:] if need_scale else None,
                local[:c] if need_bias else None, None)


def layer_norm(x: torch.Tensor, *, epsilon: float = 1e-3) -> torch.Tensor:
    """Affine-free LayerNorm over the channel (last) axis, as Caffe2's
    LayerNorm in FBO-NL (reference ``lib/models/lfb_helper.py:160-167``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout, Caffe2 Dropout with is_test=False (as
    ``lfb_tpu.models.layers.dropout``): keep each element with probability
    1 - rate, drawn from ``generator``, and scale the kept ones by
    1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator)
    return torch.where(mask.bool(), x / keep, 0.0).to(x.dtype)
