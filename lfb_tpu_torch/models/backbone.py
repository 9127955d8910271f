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
``train`` changes nothing in frozen-affine mode; with true BN it normalizes
with batch statistics and records them in ``bn_updates``
(``layers.apply_norm``).  In frozen-affine mode each norm runs with what
follows it (the ReLU; in 2c the shortcut, itself normed in a projection
block, and the ReLU; in a non-local block the residual) as one pass
(``layers.norm_act``, ``ops/cuda_affine.py``).  With ``use_pallas_bottleneck``,
inference runs each identity block as one fused kernel
(``ops/cuda_bottleneck.py``).

Rematerialization (``spec.remat``, ``lfb_tpu/models/backbone.py:143-192``):
in training with the frozen affine, 'stage' runs each res-stage, 'res2'
res2 alone and 'block' each bottleneck block (not the non-local block after
it) under
``torch.utils.checkpoint``, which keeps only the region's input and runs
the region again in the backward.  The stem and pool1 stay outside.  The
checkpoint is the non-reentrant one: the regions read their parameters
from ``p``, not from their inputs, and only that form carries gradients to
such tensors.  Nothing in the backbone draws random numbers (the bank
windows and the dropout masks are drawn outside it), so the recompute needs
no RNG state.  Training with true BN (``spec.use_affine`` False) turns
remat off, as ``lfb_tpu`` does: its batch statistics leave the regions
through ``bn_updates``.  With ``MODEL.USE_AFFINE`` True and true-BN
non-local blocks remat stays on, and the recompute derives the same batch
statistics again.

Under a profiler the stem and each stage are spans (``lfb.model.stem``,
``lfb.model.res2`` .. ``res5``; a region's first run stays under its
stage's) and each recompute in the backward is ``lfb.model.recompute``,
counted in ``remat.regions`` (:mod:`lfb_tpu_torch.utils.profiling`).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from lfb_tpu_torch.models.layers import (Params, init_conv, init_norm,
                                         norm_act)
from lfb_tpu_torch.models.spec import STAGE_DIMS, ModelSpec
from lfb_tpu_torch.ops.attention import scaled_softmax_attention
from lfb_tpu_torch.ops.conv3d import conv1x1, conv3d
from lfb_tpu_torch.ops.cuda_bottleneck import (fold_bottleneck_params,
                                               fused_identity_bottleneck)
from lfb_tpu_torch.ops.cuda_stem import StemConv
from lfb_tpu_torch.ops.pooling import max_pool_3d
from lfb_tpu_torch.utils.profiling import count, span

P = Mapping[str, torch.Tensor]
_STAGE_SPANS = ('lfb.model.res2', 'lfb.model.res3', 'lfb.model.res4',
                'lfb.model.res5')


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

    def forward(self, p: P, x: torch.Tensor, train: bool,
                bn_updates: dict | None = None) -> torch.Tensor:
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

        def norm_relu(name, h, **shortcut):
            return norm_act(p, pre + name, h, use_affine=spec.use_affine,
                            epsilon=spec.bn_epsilon, train=train,
                            bn_updates=bn_updates, relu=True, **shortcut)

        h = conv3d(x, p[pre + '_branch2a_w'],
                   strides=(self.temp_stride, 1, 1),
                   padding=(self.use_temp_conv, 0, 0))
        h = norm_relu('_branch2a_bn', h)
        d = self.dilation
        h = conv3d(h, p[pre + '_branch2b_w'],
                   strides=(1, self.stride, self.stride), padding=(0, d, d),
                   dilation=(1, d, d), groups=spec.groups)
        h = norm_relu('_branch2b_bn', h)
        h = conv3d(h, p[pre + '_branch2c_w'])
        if self.has_branch1:
            sc = conv3d(x, p[pre + '_branch1_w'],
                        strides=(self.temp_stride, self.stride, self.stride))
            return norm_relu('_branch2c_bn', h, residual=sc,
                             residual_name=pre + '_branch1_bn')
        return norm_relu('_branch2c_bn', h, residual=x)


class NonLocal(nn.Module):
    """Space-time NL + residual (reference ``nonlocal_helper.py:29-213``);
    ``grouped`` runs it per temporal group of ``spec.nl_group_size`` frames."""

    def __init__(self, spec: ModelSpec, prefix: str, *, grouped: bool):
        super().__init__()
        self.spec = spec
        self.prefix = prefix
        self.group_num = (spec.pool_stride // spec.nl_group_size if grouped
                          else 1)

    def forward(self, p: P, x: torch.Tensor, train: bool,
                bn_updates: dict | None = None) -> torch.Tensor:
        B, T, H, W, C = x.shape
        g = self.group_num
        if g > 1:
            if T % g:
                raise ValueError('grouped NL: T={} not divisible into {} '
                                 'groups'.format(T, g))
            x_nl = x.reshape(B * g, T // g, H, W, C)
        else:
            x_nl = x
        out = self._attend(p, x_nl)
        nl = self.spec.nl
        if nl.use_bn or nl.use_affine:
            out = norm_act(p, self.prefix + '_bn', out,
                           use_affine=nl.use_affine, epsilon=nl.bn_epsilon,
                           train=train, bn_updates=bn_updates, residual=x_nl)
        else:
            out = x_nl + out
        return out.reshape(B, T, H, W, C) if g > 1 else out

    def _attend(self, p: P, x: torch.Tensor) -> torch.Tensor:
        """The attention branch up to its output conv (the norm and the
        residual follow in :meth:`forward`)."""
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
        return conv1x1(att.reshape(B, T, H, W, dim_inner), p[pre + '_out_w'],
                       p.get(pre + '_out_b'))


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

    def forward(self, p: P, x: torch.Tensor, train: bool = False,
                bn_updates: dict | None = None) -> torch.Tensor:
        """``bn_updates``: where true-BN layers record their batch
        statistics in training (``layers.apply_norm``)."""
        spec = self.spec
        with span('lfb.model.stem'):
            h = StemConv.apply(x, p['conv1_w'], self.temporal_pad)
            h = norm_act(p, 'res_conv1_bn', h, use_affine=spec.use_affine,
                         epsilon=spec.bn_epsilon, train=train,
                         bn_updates=bn_updates, relu=True,
                         pool=((1, 3, 3), (1, 2, 2), (0, 1, 1)))
        # As ``lfb_tpu/models/backbone.py:143-148``: no remat in true-BN
        # training, whose statistics flow out through ``bn_updates``.
        remat = spec.remat if train and spec.use_affine else ''
        for stage_i, stage in enumerate(self.stages):
            with span(_STAGE_SPANS[stage_i]):
                if stage_i == 1:
                    h = max_pool_3d(h, (2, 1, 1), (2, 1, 1))   # pool2: T/2
                if remat == 'stage' or (remat == 'res2' and stage_i == 0):
                    h = _recomputed(self._stage, p, stage, h, train, False)
                else:
                    h = self._stage(p, stage, h, train, remat == 'block',
                                    bn_updates)
        return h.detach() if spec.freeze_backbone else h

    @staticmethod
    def _stage(p: P, stage: nn.ModuleList, h: torch.Tensor, train: bool,
               remat_block: bool, bn_updates: dict | None = None
               ) -> torch.Tensor:
        for layer in stage:
            if remat_block and isinstance(layer, Bottleneck):
                h = _recomputed(layer, p, h, train)
            else:
                h = layer(p, h, train, bn_updates)
        return h


def _recomputed(fn, *args):
    """``fn(*args)``, run again in the backward instead of keeping what its
    backward needs; each run after the first is ``lfb.model.recompute``."""
    ran = []

    def region(*region_args):
        if not ran:
            ran.append(True)
            return fn(*region_args)
        count('remat.regions')
        with span('lfb.model.recompute'):
            return fn(*region_args)

    return checkpoint(region, *args, use_reentrant=False,
                      preserve_rng_state=False)
