"""Feature Bank Operators (port of ``lfb_tpu/models/fbo.py``; reference
``lib/models/lfb_helper.py``): avg-pool, max-pool, and FBO-NL cross
attention of the clip (or box) feature over its bank window, with the
reference's three dropout sites when training.

Zero-padded bank rows take part in the softmax, exactly like the reference
(``lib/datasets/ava.py:300-323`` pads with zeros and applies no mask).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from lfb_tpu_torch.models.layers import Params, dropout, init_conv, layer_norm
from lfb_tpu_torch.models.spec import ModelSpec
from lfb_tpu_torch.ops.attention import scaled_softmax_attention
from lfb_tpu_torch.ops.conv3d import conv1x1

P = Mapping[str, torch.Tensor]


def fbo_input_name(spec: ModelSpec) -> str:
    """The Caffe2 blob the FBO input-reduce conv is named after
    (``lfb_helper.py:295-317``; see ``lfb_tpu.models.fbo.fbo_input_name``)."""
    return 'box_pooled' if spec.head_type == 'roi' else 'res5_2_branch2c_bn_pooled'


def init_fbo(spec: ModelSpec, generator: torch.Generator) -> Params:
    params: Params = {}
    f = spec.fbo
    if not f.enabled or spec.lfb_infer_only or f.fbo_type in ('avg', 'max'):
        return params
    clip_dim = 2048
    has_bias = not spec.nl.no_bias
    if f.input_reduce_dim:
        init_conv(params, fbo_input_name(spec) + '_fbonl_reduc', 1, 1, 1,
                  clip_dim, f.latent_dim, generator=generator,
                  std=spec.fc_init_std, bias=has_bias)
        theta_dim = f.latent_dim
    else:
        theta_dim = clip_dim
    init_conv(params, 'lfb_1x1', 1, 1, 1, f.lfb_dim, f.latent_dim,
              generator=generator, std=spec.fc_init_std, bias=has_bias)
    for i in range(f.num_layers):
        prefix = 'lfb_nl{}'.format(i)
        init_conv(params, prefix + '_theta', 1, 1, 1, theta_dim, f.latent_dim,
                  generator=generator, std=spec.nl.conv_init_std,
                  bias=has_bias)
        for name in ('_phi', '_g'):
            init_conv(params, prefix + name, 1, 1, 1, f.latent_dim,
                      f.latent_dim, generator=generator,
                      std=spec.nl.conv_init_std, bias=has_bias)
        # Zero-initialized output projection (init_params2,
        # ``lfb_helper.py:36-40``): each NL layer starts as identity.
        init_conv(params, prefix + '_out', 1, 1, 1, f.latent_dim, theta_dim,
                  generator=generator, zero=True, bias=has_bias)
    return params


class FBONL(nn.Module):
    """The FBO-NL stack: (N, 2048) clip features x (N, W, lfb_dim) bank
    windows -> (N, latent_dim).  In training, dropout (FBO_NL.DROPOUT_RATE,
    drawn from ``generator``) hits the reduced input, the projected bank and
    each layer's output before the residual, where ``lfb_tpu`` puts it
    (``lfb_tpu/models/fbo.py:101-107,148-150``)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec

    def forward(self, p: P, clip_feat: torch.Tensor, lfb: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        spec, f = self.spec, self.spec.fbo
        x = clip_feat                                     # prepare_nl_input
        if f.input_reduce_dim:
            name = fbo_input_name(spec) + '_fbonl_reduc'
            x = conv1x1(x, p[name + '_w'], p.get(name + '_b'))
        if f.input_dropout_on and train:
            x = dropout(x, f.dropout_rate, generator)
        bank = conv1x1(lfb, p['lfb_1x1_w'], p.get('lfb_1x1_b'))  # prepare_lfb
        if f.lfb_dropout_on and train:
            bank = dropout(bank, f.dropout_rate, generator)
        for i in range(f.num_layers):
            x = _nl_core(spec, p, 'lfb_nl{}'.format(i), x, bank, train,
                         generator)
        return x


def _nl_core(spec: ModelSpec, p: P, prefix: str, a: torch.Tensor,
             bank: torch.Tensor, train: bool,
             generator: torch.Generator | None) -> torch.Tensor:
    """One FBO-NL layer (reference ``NLCore`` + residual/activation from
    ``NLLayers``, ``lfb_helper.py:170-292``), pre-act or post-act."""
    f = spec.fbo

    def conv(name, x):
        return conv1x1(x, p[prefix + name + '_w'], p.get(prefix + name + '_b'))

    theta = conv('_theta', a)[:, None, :].contiguous()   # (N, 1, L)
    t = scaled_softmax_attention(
        theta, conv('_phi', bank), conv('_g', bank),
        scale=f.latent_dim ** -0.5 if f.scale else None)[:, 0, :]
    if f.pre_act:
        if f.pre_act_ln:
            t = layer_norm(t)
        t = F.relu(t)
    out = conv('_out', t)
    if not f.pre_act:
        out = layer_norm(out)
    # NLCore's dropout is gated on LFB_DROPOUT_ON (``lfb_helper.py:258-261``).
    if f.lfb_dropout_on and train:
        out = dropout(out, f.dropout_rate, generator)
    out = out + a
    if not f.pre_act:
        out = F.relu(out)
    return out


def fbo_forward(spec: ModelSpec, p: P, clip_feat: torch.Tensor,
                lfb: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply the configured FBO: (N, out_dim) bank summary to concatenate
    with the clip features (latent_dim for 'nl', lfb_dim for 'avg'/'max')."""
    if spec.fbo.fbo_type == 'avg':
        return lfb.mean(dim=1)
    if spec.fbo.fbo_type == 'max':
        return lfb.amax(dim=1)
    if spec.fbo.fbo_type != 'nl':
        raise ValueError('unknown LFB.FBO_TYPE {!r}'.format(spec.fbo.fbo_type))
    return FBONL(spec)(p, clip_feat, lfb, train, generator)
