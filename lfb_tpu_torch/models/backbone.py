"""3D ResNet (R50/R101, C2D/I3D) backbone with interleaved space-time
non-local blocks (port of ``lfb_tpu/models/backbone.py``).

Topology follows the reference (``lib/models/resnet_video.py:133-301`` +
``lib/models/resnet_helper.py``): conv1 (kTx7x7, stride 1x2x2) -> pool1
(1x3x3 / 1x2x2) -> res2 -> pool2 (2x1x1 temporal) -> res3 (+NL) -> res4 (+NL)
-> res5 (stride 1, spatial dilation 2 when DILATIONS_AFTER_CONV5).  res3's NL
blocks run per temporal group of 4 frames in affine mode (reference
``resnet_video.py:246-265``).

The modules hold no weights: each ``forward`` takes the model's flat
parameter mapping ``p`` and reads its blobs by name.  Activations are NDHWC.
``train`` changes nothing in frozen-affine mode (the ported one); true BN
refuses to train (``layers.apply_norm``).  With ``use_pallas_bottleneck``,
inference runs each identity block as one fused kernel
(``ops/cuda_bottleneck.py``).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from lfb_tpu_torch.models.layers import (Params, apply_norm, init_conv,
                                         init_norm)
from lfb_tpu_torch.models.spec import STAGE_DIMS, ModelSpec
from lfb_tpu_torch.ops.attention import scaled_softmax_attention
from lfb_tpu_torch.ops.conv3d import conv1x1, conv3d
from lfb_tpu_torch.ops.cuda_bottleneck import (fold_bottleneck_params,
                                               fused_identity_bottleneck)
from lfb_tpu_torch.ops.cuda_stem import StemConv
from lfb_tpu_torch.ops.pooling import max_pool_3d

P = Mapping[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# Initialization
# --------------------------------------------------------------------------- #

def init_backbone(spec: ModelSpec, generator: torch.Generator) -> Params:
    params: Params = {}
    dev = generator.device
    use_temp, _ = spec.arc
    init_conv(params, 'conv1', 1 + use_temp[0][0] * 2, 7, 7, 3, 64,
              generator=generator)
    init_norm(params, 'res_conv1_bn', 64, use_affine=spec.use_affine,
              device=dev)

    dims_in = 64
    for stage_i, (stage_name, dim_out, inner_mult) in enumerate(
            zip(('res2', 'res3', 'res4', 'res5'), STAGE_DIMS, (1, 2, 4, 8))):
        utc = use_temp[stage_i + 1]
        for idx in range(spec.block_counts[stage_i]):
            prefix = '{}_{}'.format(stage_name, idx)
            di = spec.dim_inner_base * inner_mult
            init_conv(params, prefix + '_branch2a', 1 + utc[idx] * 2, 1, 1,
                      dims_in, di, generator=generator)
            init_norm(params, prefix + '_branch2a_bn', di,
                      use_affine=spec.use_affine, device=dev)
            init_conv(params, prefix + '_branch2b', 1, 3, 3,
                      di // spec.groups, di, generator=generator)
            init_norm(params, prefix + '_branch2b_bn', di,
                      use_affine=spec.use_affine, device=dev)
            init_conv(params, prefix + '_branch2c', 1, 1, 1, di, dim_out,
                      generator=generator)
            init_norm(params, prefix + '_branch2c_bn', dim_out,
                      use_affine=spec.use_affine, device=dev,
                      gamma_init=spec.bn_init_gamma)
            if idx == 0 and dims_in != dim_out:
                init_conv(params, prefix + '_branch1', 1, 1, 1, dims_in,
                          dim_out, generator=generator)
                init_norm(params, prefix + '_branch1_bn', dim_out,
                          use_affine=spec.use_affine, device=dev)
            dims_in = dim_out
            if idx in spec.nl_blocks.get(stage_name, ()):
                _init_nonlocal(params, 'nonlocal_conv{}_{}'.format(
                    stage_i + 2, idx), dims_in, dims_in // 2, spec, generator)
    return params


def _init_nonlocal(params: Params, prefix: str, dim: int, dim_inner: int,
                   spec: ModelSpec, generator: torch.Generator) -> None:
    nl = spec.nl
    has_bias = not nl.no_bias
    for name in ('_theta', '_phi', '_g'):
        init_conv(params, prefix + name, 1, 1, 1, dim, dim_inner,
                  generator=generator, std=nl.conv_init_std, bias=has_bias)
    init_conv(params, prefix + '_out', 1, 1, 1, dim_inner, dim,
              generator=generator, std=nl.conv_init_std,
              zero=nl.use_zero_init_conv, bias=has_bias)
    if nl.use_bn or nl.use_affine:
        init_norm(params, prefix + '_bn', dim, use_affine=nl.use_affine,
                  device=generator.device,
                  gamma_init=nl.bn_init_gamma if nl.use_bn else 1.0)


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

class Bottleneck(nn.Module):
    """kTx1x1 -> 1x3x3 (dilated, strided) -> 1x1x1 bottleneck + shortcut."""

    def __init__(self, spec: ModelSpec, prefix: str, *, dim_in: int,
                 dim_out: int, stride: int, temp_stride: int,
                 use_temp_conv: int, dilation: int):
        super().__init__()
        self.spec = spec
        self.prefix = prefix
        self.stride = stride
        self.temp_stride = temp_stride
        self.use_temp_conv = use_temp_conv
        self.dilation = dilation
        self.has_branch1 = not (dim_in == dim_out and temp_stride == 1
                                and stride == 1)

    def forward(self, p: P, x: torch.Tensor, train: bool) -> torch.Tensor:
        spec, pre = self.spec, self.prefix
        # The fused block (inference, frozen affine, identity shortcut), under
        # lfb_tpu's predicate (``lfb_tpu/models/backbone.py:213-219``) but
        # without its TPU memory envelope: the kernel takes every such block
        # or raises.
        if (spec.use_pallas_bottleneck and not train and spec.use_affine
                and not self.has_branch1 and spec.groups == 1):
            folded = fold_bottleneck_params(p, pre)
            if folded is not None:
                return fused_identity_bottleneck(
                    x, *folded, temporal_pad=self.use_temp_conv,
                    dilation=self.dilation)

        def norm(name, h):
            return apply_norm(p, pre + name, h, use_affine=spec.use_affine,
                              epsilon=spec.bn_epsilon, train=train)

        h = conv3d(x, p[pre + '_branch2a_w'],
                   strides=(self.temp_stride, 1, 1),
                   padding=(self.use_temp_conv, 0, 0))
        h = F.relu(norm('_branch2a_bn', h))
        d = self.dilation
        h = conv3d(h, p[pre + '_branch2b_w'],
                   strides=(1, self.stride, self.stride), padding=(0, d, d),
                   dilation=(1, d, d), groups=spec.groups)
        h = F.relu(norm('_branch2b_bn', h))
        h = norm('_branch2c_bn', conv3d(h, p[pre + '_branch2c_w']))
        if self.has_branch1:
            sc = conv3d(x, p[pre + '_branch1_w'],
                        strides=(self.temp_stride, self.stride, self.stride))
            sc = norm('_branch1_bn', sc)
        else:
            sc = x
        return F.relu(h + sc)


class NonLocal(nn.Module):
    """Space-time NL + residual (reference ``nonlocal_helper.py:29-213``);
    ``grouped`` runs it per temporal group of ``spec.nl_group_size`` frames."""

    def __init__(self, spec: ModelSpec, prefix: str, *, grouped: bool):
        super().__init__()
        self.spec = spec
        self.prefix = prefix
        self.group_num = (spec.pool_stride // spec.nl_group_size if grouped
                          else 1)

    def forward(self, p: P, x: torch.Tensor, train: bool) -> torch.Tensor:
        B, T, H, W, C = x.shape
        g = self.group_num
        if g > 1:
            if T % g:
                raise ValueError('grouped NL: T={} not divisible into {} '
                                 'groups'.format(T, g))
            x_nl = x.reshape(B * g, T // g, H, W, C)
        else:
            x_nl = x
        out = x_nl + self._attend(p, x_nl, train)
        return out.reshape(B, T, H, W, C) if g > 1 else out

    def _attend(self, p: P, x: torch.Tensor, train: bool) -> torch.Tensor:
        nl, pre = self.spec.nl, self.prefix
        B, T, H, W, C = x.shape
        dim_inner = p[pre + '_theta_w'].shape[0]
        theta = conv1x1(x, p[pre + '_theta_w'], p.get(pre + '_theta_b'))
        pooled = max_pool_3d(x, (1, 2, 2), (1, 2, 2)) if nl.use_maxpool else x
        phi = conv1x1(pooled, p[pre + '_phi_w'], p.get(pre + '_phi_b'))
        g = conv1x1(pooled, p[pre + '_g_w'], p.get(pre + '_g_b'))
        att = scaled_softmax_attention(
            theta.reshape(B, T * H * W, dim_inner),
            phi.reshape(B, -1, dim_inner), g.reshape(B, -1, dim_inner),
            scale=dim_inner ** -0.5 if (nl.use_softmax and nl.use_scale)
            else None,
            use_softmax=nl.use_softmax)
        out = conv1x1(att.reshape(B, T, H, W, dim_inner), p[pre + '_out_w'],
                      p.get(pre + '_out_b'))
        if nl.use_bn or nl.use_affine:
            out = apply_norm(p, pre + '_bn', out, use_affine=nl.use_affine,
                             epsilon=nl.bn_epsilon, train=train)
        return out


class Backbone(nn.Module):
    """(B, T, H, W, 3) -> (B, T/2, H/16, W/16, 2048)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        use_temp, temp_strides = spec.arc
        if temp_strides[0][0] != 1:
            raise NotImplementedError('a temporally strided stem is not ported')
        self.temporal_pad = use_temp[0][0]
        dil5 = 2 if spec.dilations_after_conv5 else 1
        stages = []
        dims_in = 64
        for stage_i, (dilation, stride) in enumerate(
                ((1, 1), (1, 2), (1, 2), (dil5, 1))):
            stage_name = 'res{}'.format(stage_i + 2)
            dim_out = STAGE_DIMS[stage_i]
            layers = []
            for idx in range(spec.block_counts[stage_i]):
                layers.append(Bottleneck(
                    spec, '{}_{}'.format(stage_name, idx), dim_in=dims_in,
                    dim_out=dim_out, stride=stride if idx == 0 else 1,
                    temp_stride=temp_strides[stage_i + 1][idx],
                    use_temp_conv=use_temp[stage_i + 1][idx],
                    dilation=dilation))
                dims_in = dim_out
                if idx in spec.nl_blocks.get(stage_name, ()):
                    layers.append(NonLocal(
                        spec, 'nonlocal_conv{}_{}'.format(stage_i + 2, idx),
                        grouped=spec.use_affine and stage_name == 'res3'))
            stages.append(nn.ModuleList(layers))
        self.stages = nn.ModuleList(stages)

    def forward(self, p: P, x: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        spec = self.spec
        h = StemConv.apply(x, p['conv1_w'], self.temporal_pad)
        h = apply_norm(p, 'res_conv1_bn', h, use_affine=spec.use_affine,
                       epsilon=spec.bn_epsilon, train=train)
        h = max_pool_3d(F.relu(h), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for stage_i, stage in enumerate(self.stages):
            if stage_i == 1:
                h = max_pool_3d(h, (2, 1, 1), (2, 1, 1))   # pool2: T/2
            for layer in stage:
                h = layer(p, h, train)
        return h.detach() if spec.freeze_backbone else h
