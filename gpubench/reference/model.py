"""The plain reference of the benchmark's LFB models, in float32.

A frozen copy of the Long-Term Feature Bank models as the LFB paper's code
defines them (Wu et al., CVPR 2019; ``lib/models/resnet_video.py``,
``resnet_helper.py``, ``nonlocal_helper.py``, ``head_helper.py``,
``lfb_helper.py``): the I3D ResNet with space-time non-local blocks and a
frozen per-channel affine in place of each BN, the AVA head (temporal mean,
RoIAlign 7x7 with the legacy Caffe2 sampling, 7x7 max) or the clip head
(global mean), the FBO-NL over a bank window and the classifier (the
loss is the dataset's, :mod:`gpubench.reference.datasets`).  Plain
PyTorch over NCDHW tensors: no kernel, no cache, no batching trick.  It
reads its architecture from the configuration file's ``model`` block (the
released config's keys) and nothing of the program under test.

``quant`` rounds the operands of every product (convolutions, attention,
the classifier) and, through ``quant.out``, the gradients arriving at
their outputs, when set: :mod:`gpubench.reference.precision` uses it for
the lower-precision control.  With ``quant`` None the reference is plain
float32; the caller turns TF32 off.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK_COUNTS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_DIMS = (256, 512, 1024, 2048)
STAGES = ('res2', 'res3', 'res4', 'res5')

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Arch:
    """The architecture of one phase, from a configuration's ``model``
    block (dotted keys of the released config, with their values)."""

    def __init__(self, model: Mapping, split: str, infer_only: bool = False):
        m = dict(model)
        self.dataset = m['DATASET']
        self.depth = m['MODEL.DEPTH']
        self.arc = m['MODEL.VIDEO_ARC_CHOICE']
        self.num_classes = m['MODEL.NUM_CLASSES']
        self.dilate5 = m['MODEL.DILATIONS_AFTER_CONV5']
        self.freeze_backbone = m['MODEL.FREEZE_BACKBONE']
        self.inner = m['RESNETS.NUM_GROUPS'] * m['RESNETS.WIDTH_PER_GROUP']
        self.nl_res3 = m['NONLOCAL.CONV3_NONLOCAL']
        self.nl_res4 = m['NONLOCAL.CONV4_NONLOCAL']
        self.nl_layer_mod = m['NONLOCAL.LAYER_MOD']
        self.window = m['LFB.WINDOW_SIZE']
        self.lfb_dim = m['LFB.LFB_DIM']
        self.fbo_layers = m['FBO_NL.NUM_LAYERS']
        self.pre_act = m['FBO_NL.PRE_ACT']
        self.latent = m['FBO_NL.LATENT_DIM']
        self.fbo_dropout = m['FBO_NL.DROPOUT_RATE']
        self.dropout = m['TRAIN.DROPOUT_RATE']
        self.roi = m['ROI.XFORM_RESOLUTION']
        self.roi_scale = 1.0 / m['ROI.SCALE_FACTOR']
        self.mean = tuple(m['DATA_MEAN'][::-1])      # BGR-ordered -> RGB
        self.std = tuple(m['DATA_STD'][::-1])
        self.feats_per_sec = m.get('AVA.LFB_MAX_NUM_FEAT_PER_STEP', 1)
        key = 'TRAIN' if split == 'train' else 'TEST'
        self.crop = m[key + '.CROP_SIZE']
        self.frames = m[key + '.VIDEO_LENGTH']
        self.clips = m[key + '.BATCH_SIZE']
        # The head pools over TRAIN.VIDEO_LENGTH / 2 frames in every split.
        self.head_frames = m['TRAIN.VIDEO_LENGTH'] // 2
        self.infer_only = infer_only
        self.train = split == 'train' and not infer_only
        if self.arc not in (2, 4) or self.depth not in BLOCK_COUNTS:
            raise ValueError('reference: I3D ResNet-50 / 101 only, not arc '
                             '{} depth {}'.format(self.arc, self.depth))

    @property
    def roi_head(self) -> bool:
        return self.dataset == 'ava'

    @property
    def rows_in_window(self) -> int:
        """Bank rows in one example's window."""
        if self.dataset == 'ava':
            return self.window * self.feats_per_sec
        return self.window

    def temporal_kernels(self) -> List[List[int]]:
        """Each block's branch2a temporal kernel, by stage (I3D: 3 on the
        blocks the paper inflates, 1 elsewhere)."""
        n = BLOCK_COUNTS[self.depth]
        res4 = ([1, 0, 1, 0, 1, 0] if self.arc == 2
                else [1 - i % 2 for i in range(n[2])])
        radius = [[1, 1, 1], [1, 0, 1, 0], res4, [0, 1, 0]]
        return [[1 + 2 * r for r in stage] for stage in radius]

    def nonlocal_after(self, stage: str) -> Tuple[int, ...]:
        """Blocks of ``stage`` followed by a non-local block."""
        n = BLOCK_COUNTS[self.depth]
        if stage == 'res3' and self.nl_res3:
            every = 2 if self.depth == 101 else self.nl_layer_mod
            return tuple(i for i in range(n[1]) if i % every == every - 1)
        if stage == 'res4' and self.nl_res4:
            every = (self.nl_layer_mod * 4 - 1 if self.depth == 101
                     else self.nl_layer_mod)
            return tuple(i for i in range(n[2]) if i % every == every - 1)
        return ()

    def fbo_input(self) -> str:
        return 'box_pooled' if self.roi_head else 'res5_2_branch2c_bn_pooled'


def param_specs(arch: Arch) -> List[Tuple[str, tuple, str]]:
    """(Caffe2 blob name, shape, role) of every parameter the phase reads,
    in a fixed order.  The roles say how :mod:`gpubench.weights` draws
    them: 'conv' (He fan-in), 'proj' (1 / fan-in), 'proj_out' (0.2 of it),
    'classifier', 'scale', 'scale_out' (a residual branch's last scale),
    'bias'."""
    specs = [('conv1_w', (64, 3, 5, 7, 7), 'conv'),
             ('res_conv1_bn_s', (64,), 'scale'),
             ('res_conv1_bn_b', (64,), 'bias')]
    dim_in = 64
    kts = arch.temporal_kernels()
    for s, (stage, dim_out) in enumerate(zip(STAGES, STAGE_DIMS)):
        di = arch.inner * 2 ** s
        for i in range(BLOCK_COUNTS[arch.depth][s]):
            pre = '{}_{}'.format(stage, i)
            for branch, shape in (
                    ('2a', (di, dim_in, kts[s][i], 1, 1)),
                    ('2b', (di, di, 1, 3, 3)),
                    ('2c', (dim_out, di, 1, 1, 1))):
                specs.append((pre + '_branch' + branch + '_w', shape, 'conv'))
                specs.append((pre + '_branch' + branch + '_bn_s', shape[:1],
                              'scale_out' if branch == '2c' else 'scale'))
                specs.append((pre + '_branch' + branch + '_bn_b', shape[:1],
                              'bias'))
            if i == 0 and dim_in != dim_out:
                specs += [(pre + '_branch1_w', (dim_out, dim_in, 1, 1, 1),
                           'conv'),
                          (pre + '_branch1_bn_s', (dim_out,), 'scale'),
                          (pre + '_branch1_bn_b', (dim_out,), 'bias')]
            dim_in = dim_out
            if i in arch.nonlocal_after(stage):
                nl = 'nonlocal_conv{}_{}'.format(s + 2, i)
                half = dim_out // 2
                for name in ('_theta', '_phi', '_g'):
                    specs += [(nl + name + '_w', (half, dim_out, 1, 1, 1),
                               'proj'), (nl + name + '_b', (half,), 'bias')]
                specs += [(nl + '_out_w', (dim_out, half, 1, 1, 1),
                           'proj_out'), (nl + '_out_b', (dim_out,), 'bias'),
                          (nl + '_bn_s', (dim_out,), 'scale'),
                          (nl + '_bn_b', (dim_out,), 'bias')]
    if arch.infer_only:
        return specs
    lat = arch.latent
    red = arch.fbo_input() + '_fbonl_reduc'
    specs += [(red + '_w', (lat, 2048, 1, 1, 1), 'proj'),
              (red + '_b', (lat,), 'bias'),
              ('lfb_1x1_w', (lat, arch.lfb_dim, 1, 1, 1), 'proj'),
              ('lfb_1x1_b', (lat,), 'bias')]
    for i in range(arch.fbo_layers):
        for name in ('_theta', '_phi', '_g', '_out'):
            specs += [('lfb_nl{}{}_w'.format(i, name), (lat, lat, 1, 1, 1),
                       'proj'), ('lfb_nl{}{}_b'.format(i, name), (lat,),
                                 'bias')]
    specs += [('pred_w', (arch.num_classes, 2048 + lat), 'classifier'),
              ('pred_b', (arch.num_classes,), 'bias')]
    return specs


def trainable_names(arch: Arch, names) -> List[str]:
    """The parameters a train step updates: not the frozen affines (the
    reference's AffineNd has no parameter gradient), and with a frozen
    backbone only the FBO and the classifier."""
    head = ('pred_', 'lfb_nl', 'lfb_1x1')
    out = []
    for name in names:
        if name.endswith('_bn_s') or name.endswith('_bn_b'):
            continue
        if arch.freeze_backbone and not (name.startswith(head)
                                         or '_fbonl_reduc' in name):
            continue
        out.append(name)
    return out


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _o(quant: Quant, y: torch.Tensor) -> torch.Tensor:
    """A product's output, through ``quant.out`` where the control rounds
    the gradient arriving there."""
    return y if quant is None else quant.out(y)


def conv(x, w, quant: Quant, *, stride=(1, 1, 1),
         padding=(0, 0, 0), dilation=(1, 1, 1), bias=None):
    y = _o(quant, F.conv3d(_q(quant, x), _q(quant, w), None,
                           stride, padding, dilation))
    return y if bias is None else y + bias.view(1, -1, 1, 1, 1)


def affine(x, p, name):
    """The frozen BN: y = x * scale + bias, per channel."""
    return (x * p[name + '_s'].view(1, -1, 1, 1, 1)
            + p[name + '_b'].view(1, -1, 1, 1, 1))


def linear(x, w, b, quant: Quant):
    """A 1x1x1 convolution over the last axis of ``x``."""
    w = w.reshape(w.shape[0], w.shape[1])
    y = _o(quant, torch.matmul(_q(quant, x), _q(quant, w).t()))
    return y if b is None else y + b


def attention(q, k, v, scale, quant: Quant):
    """softmax(q k^T * scale) v over (B, N, C) tensors."""
    logits = _o(quant, torch.matmul(_q(quant, q),
                                    _q(quant, k).transpose(1, 2)))
    prob = torch.softmax(logits * scale, dim=-1)
    return _o(quant, torch.matmul(_q(quant, prob), _q(quant, v)))


def bottleneck(p, x, pre, *, kt, stride, dilation, quant: Quant):
    h = conv(x, p[pre + '_branch2a_w'], quant,
             padding=(kt // 2, 0, 0))
    h = F.relu(affine(h, p, pre + '_branch2a_bn'))
    h = conv(h, p[pre + '_branch2b_w'], quant,
             stride=(1, stride, stride), padding=(0, dilation, dilation),
             dilation=(1, dilation, dilation))
    h = F.relu(affine(h, p, pre + '_branch2b_bn'))
    h = affine(conv(h, p[pre + '_branch2c_w'], quant), p,
               pre + '_branch2c_bn')
    if pre + '_branch1_w' in p:
        sc = affine(conv(x, p[pre + '_branch1_w'], quant,
                         stride=(1, stride, stride)), p, pre + '_branch1_bn')
    else:
        sc = x
    return F.relu(h + sc)


def nonlocal_block(p, x, pre, groups: int, quant: Quant):
    """Space-time non-local block with its residual; ``groups`` > 1 runs it
    on each run of T / groups consecutive frames alone."""
    B, C, T, H, W = x.shape
    if groups > 1:
        x = (x.reshape(B, C, groups, T // groups, H, W).transpose(1, 2)
             .reshape(B * groups, C, T // groups, H, W))
    b, _, t, h, w = x.shape
    half = C // 2

    def proj(inp, name):
        y = conv(inp, p[pre + name + '_w'], quant,
                 bias=p[pre + name + '_b'])
        return y.reshape(b, y.shape[1], -1).transpose(1, 2)

    pooled = F.max_pool3d(x, (1, 2, 2), (1, 2, 2))
    att = attention(proj(x, '_theta'), proj(pooled, '_phi'),
                    proj(pooled, '_g'), half ** -0.5, quant)
    att = att.transpose(1, 2).reshape(b, half, t, h, w)
    out = conv(att, p[pre + '_out_w'], quant,
               bias=p[pre + '_out_b'])
    y = x + affine(out, p, pre + '_bn')
    if groups > 1:
        y = (y.reshape(B, groups, C, T // groups, H, W).transpose(1, 2)
             .reshape(B, C, T, H, W))
    return y


def backbone(p, data, arch: Arch, quant: Quant = None):
    """uint8 (B, T, H, W, 3) frames -> res5 (B, 2048, T/2, H/16, W/16)."""
    mean = torch.tensor(arch.mean, device=data.device)
    std = torch.tensor(arch.std, device=data.device)
    x = ((data.float() / 255.0 - mean) / std).permute(0, 4, 1, 2, 3)
    kt = p['conv1_w'].shape[2]
    h = conv(x, p['conv1_w'], quant, stride=(1, 2, 2),
             padding=(kt // 2, 3, 3))
    h = F.relu(affine(h, p, 'res_conv1_bn'))
    h = F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    kts = arch.temporal_kernels()
    for s, stage in enumerate(STAGES):
        if s == 1:
            h = F.max_pool3d(h, (2, 1, 1), (2, 1, 1))
        stride = 2 if s in (1, 2) else 1
        dilation = 2 if s == 3 and arch.dilate5 else 1
        for i in range(BLOCK_COUNTS[arch.depth][s]):
            pre = '{}_{}'.format(stage, i)
            h = bottleneck(p, h, pre, kt=kts[s][i],
                           stride=stride if i == 0 else 1,
                           dilation=dilation, quant=quant)
            if i in arch.nonlocal_after(stage):
                groups = arch.head_frames // 4 if stage == 'res3' else 1
                h = nonlocal_block(p, h, 'nonlocal_conv{}_{}'.format(s + 2, i),
                                   groups, quant)
    return h


def roi_align_max(fmap, rois, arch: Arch):
    """RoIAlign (legacy Caffe2: no half-pixel offset, sizes at least 1, an
    adaptive ceil(size / 7) grid of bilinear samples a bin, samples outside
    [-1, size] zero) then the max over the 7 x 7 bins.  ``fmap`` (B, C, H,
    W) f32, ``rois`` (N, 5) [clip, x1, y1, x2, y2] in input pixels; a clip
    index outside [0, B) reads the nearest clip.  -> (N, C)."""
    B, C, H, W = fmap.shape
    P, s = arch.roi, arch.roi_scale
    # Boxes lie inside the crop, so no bin is wider than crop * s / P.
    G = max(1, math.ceil(arch.crop * s / P))
    dev = fmap.device
    clip = rois[:, 0].long().clamp(0, B - 1)
    x1, y1, x2, y2 = (rois[:, i] * s for i in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    gw = torch.ceil(rw / P).clamp(1, G)
    gh = torch.ceil(rh / P).clamp(1, G)
    bins = torch.arange(P, device=dev, dtype=torch.float32)
    sub = torch.arange(G, device=dev, dtype=torch.float32)

    def axis(start, size, grid, limit):
        # (N, P, G) sample coordinates, their corners and weights.
        v = (start[:, None, None] + bins[None, :, None] * (size / P)[:, None,
                                                                      None]
             + (sub[None, None, :] + 0.5) * (size / P / grid)[:, None, None])
        out = (v < -1.0) | (v > limit)
        v = v.clamp(min=0.0)
        lo = v.floor()
        top = lo >= limit - 1
        lo = torch.where(top, torch.full_like(lo, limit - 1), lo)
        v = torch.where(top, lo, v)
        hi = torch.where(top, lo, lo + 1)
        used = (sub[None, None, :] < grid[:, None, None]) & ~out
        frac = v - lo
        return lo.long(), hi.long(), frac, used

    ylo, yhi, fy, uy = axis(y1, rh, gh, H)
    xlo, xhi, fx, ux = axis(x1, rw, gw, W)
    f = fmap.permute(0, 2, 3, 1)                      # (B, H, W, C)
    n = clip[:, None, None, None, None]
    Y = lambda t: t[:, :, :, None, None]              # noqa: E731
    X = lambda t: t[:, None, None, :, :]              # noqa: E731
    val = (f[n, Y(ylo), X(xlo)] * (Y(1 - fy) * X(1 - fx))[..., None]
           + f[n, Y(ylo), X(xhi)] * (Y(1 - fy) * X(fx))[..., None]
           + f[n, Y(yhi), X(xlo)] * (Y(fy) * X(1 - fx))[..., None]
           + f[n, Y(yhi), X(xhi)] * (Y(fy) * X(fx))[..., None])
    val = val * (Y(uy) & X(ux))[..., None]
    pooled = val.sum(dim=(2, 4)) / (gh * gw)[:, None, None, None]
    return pooled.amax(dim=(1, 2))


def layer_norm(x, eps=1e-3):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def dropout(x, mask, rate):
    """Inverted dropout with a drawn keep ``mask`` (None: no dropout)."""
    return x if mask is None else torch.where(mask.bool(), x / (1 - rate), 0.0)


def fbo_nl(p, feat, window, arch: Arch, masks, quant: Quant):
    """FBO-NL: (N, 2048) clip or box features over their (N, W, D) bank
    windows -> (N, latent).  ``masks`` holds the dropout keep masks in
    training ('input', 'bank', 'layer0'...), None at inference."""
    masks = masks or {}
    lat = arch.latent
    red = arch.fbo_input() + '_fbonl_reduc'
    x = linear(feat, p[red + '_w'], p[red + '_b'], quant)
    x = dropout(x, masks.get('input'), arch.fbo_dropout)
    bank = linear(window, p['lfb_1x1_w'], p['lfb_1x1_b'], quant)
    bank = dropout(bank, masks.get('bank'), arch.fbo_dropout)
    for i in range(arch.fbo_layers):
        pre = 'lfb_nl{}'.format(i)

        def proj(inp, name):
            return linear(inp, p[pre + name + '_w'], p[pre + name + '_b'],
                          quant)

        t = attention(proj(x, '_theta')[:, None, :], proj(bank, '_phi'),
                      proj(bank, '_g'), lat ** -0.5, quant)[:, 0]
        if arch.pre_act:
            t = F.relu(layer_norm(t))
        out = proj(t, '_out')
        if not arch.pre_act:
            out = layer_norm(out)
        out = dropout(out, masks.get('layer{}'.format(i)), arch.fbo_dropout)
        x = out + x
        if not arch.pre_act:
            x = F.relu(x)
    return x


def head_features(p, data, rois, arch: Arch, quant: Quant = None):
    """Phase A's output: box features (AVA: (N, 2048) for ``rois``) or
    clip features (B, 2048)."""
    res5 = backbone(p, data, arch, quant)
    if arch.roi_head:
        return roi_align_max(res5.mean(dim=2), rois, arch)
    if res5.shape[2] != arch.head_frames:
        raise ValueError('clip head: {} frames, the config pools {}'.format(
            res5.shape[2], arch.head_frames))
    return res5.mean(dim=(2, 3, 4))


def classify(p, feat, window, arch: Arch, masks=None, quant: Quant = None):
    """Phase B past the backbone: the FBO, the head dropout and the
    classifier -> logits."""
    h = torch.cat([feat, fbo_nl(p, feat, window, arch, masks, quant)], dim=-1)
    h = dropout(h, (masks or {}).get('head'), arch.dropout)
    return linear(h, p['pred_w'], p['pred_b'], quant)


def dropout_shapes(arch: Arch, rows: int) -> Dict[str, tuple]:
    """The keep masks a train step draws, in the order it draws them, for
    ``rows`` FBO rows."""
    shapes = {'input': (rows, arch.latent),
              'bank': (rows, arch.rows_in_window, arch.latent)}
    for i in range(arch.fbo_layers):
        shapes['layer{}'.format(i)] = (rows, arch.latent)
    shapes['head'] = (rows, 2048 + arch.latent)
    return shapes


def draw_masks(arch: Arch, rows: int, generator: torch.Generator):
    """The dropout keep masks, drawn from ``generator`` in the train
    step's order (Bernoulli(1 - rate) into f32)."""
    masks = {}
    for name, shape in dropout_shapes(arch, rows).items():
        rate = arch.dropout if name == 'head' else arch.fbo_dropout
        masks[name] = torch.empty(shape, device=generator.device).bernoulli_(
            1.0 - rate, generator=generator)
    return masks
