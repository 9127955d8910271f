"""Blob-name/shape manifest of a released Caffe2 checkpoint (the port's own
copy of ``lfb_tpu/train/c2_manifest.py``, held to it by
``tests/test_torch_parity_eval.py``).

``released_blob_manifest(cfg)`` enumerates every learnable blob -- name and
Caffe2-layout shape -- that a reference ``model_final.pkl`` trained with
``cfg`` contains.  It is a direct transcription of the reference *builder's*
naming and shape rules (cited per rule below), written independently of the
model code, so :mod:`lfb_tpu_torch.tools.parity_eval` can fabricate
checkpoints shaped exactly like released ones and a test can certify that
the checkpoint layer (:mod:`lfb_tpu_torch.train.checkpoints`) maps every
released blob in both directions.

Naming rules transcribed from the reference:

  * conv weight = ``{out_blob}_w``; conv bias = ``{out_blob}_b`` only when
    ``no_bias=0`` (Caffe2 ``CNNModelHelper.ConvNd``).  Backbone convs pass
    ``no_bias=1`` (``model_builder_video.py:176-222``,
    ``resnet_video.py:169-179``); non-local and FBO convs pass
    ``no_bias=cfg.NONLOCAL.NO_BIAS`` (default 0 -> biases exist,
    ``nonlocal_helper.py:36-78``, ``lfb_helper.py:30-41``).
  * BN blobs = ``{prefix}_bn_{s,b,rm,riv}`` (``SpatialBN``); affine blobs =
    ``{prefix}_bn_{s,b}`` only (``AffineNd``, ``model_builder_video.py:223-250``).
  * stem: ``conv1`` + ``res_conv1_bn`` (``resnet_video.py:169-186``).
  * stage blocks ``res{s}_{i}`` with branches ``_branch2{a,b,c}`` and
    (first block only) shortcut ``_branch1`` (``resnet_helper.py:35-119``);
    temporal kernel of branch2a = ``1 + 2*use_temp_convs[s][i]`` from
    ``obtain_arc`` (``resnet_video.py:39-130``).
  * non-local blocks ``nonlocal_conv{s}_{i}_{theta,phi,g,out}`` + ``_bn``
    at block indices ``i % mod == mod - 1`` (``resnet_helper.py:143-155``);
    res3 mod = LAYER_MOD (2 for R101), res4 mod = LAYER_MOD (R50) or
    LAYER_MOD*4-1 = 7 (R101) (``resnet_video.py:254-292``); inner dim =
    stage_dim / 2 (``resnet_helper.py:153``).  The ``_out`` norm is BN or
    affine per ``NONLOCAL.USE_AFFINE`` (``nonlocal_helper.py:147-158``).
  * Caffe2 ``LayerNorm`` is the raw 3-output op -- no learnable blobs
    (``lfb_helper.py:163-166,254-257``).
  * FBO-NL: input reduce conv named after its *input blob*
    (``blob + '_fbonl_reduc'``, ``lfb_helper.py:302-310``): ``box_pooled``
    for the RoI head, ``res5_2_branch2c_bn_pooled`` for the basic head
    (``head_helper.py:37,120``; with ALLOW_INPLACE_SUM/RELU the backbone's
    final blob keeps the ``res5_2_branch2c_bn`` name,
    ``resnet_helper.py:112-119``); bank reduce ``lfb_1x1``
    (``lfb_helper.py:322-331``); stacked layers ``lfb_nl{i}_{theta,phi,g,out}``
    (``lfb_helper.py:267-292``, prefix ``'lfb'`` from ``lfb_helper.py:101``).
  * classifier ``pred_w`` (num_classes, head_dim) / ``pred_b``
    (``resnet_video.py:326-331``); head_dim = 2048 plus LATENT_DIM (FBO-NL)
    or LFB_DIM (FBO avg/max) when LFB.ENABLED (``head_helper.py:42-58``).

Caffe2 shape conventions: conv (Cout, Cin, kT, kH, kW); FC (Cout, Cin);
1-D per-channel vectors for scale/bias/stats.
"""

from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]

# Blocks per stage (``resnet_video.py:33-36``).
BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# ``obtain_arc`` temporal-kernel table (``resnet_video.py:39-130``):
# use_temp_convs per stage; entry 0 is conv1 (value 2 -> kT = 5).
ARC_USE_TEMP = {
    1: ([0], [0, 0, 0], [0, 0, 0, 0], [0] * 6, [0, 0, 0]),           # C2D R50
    2: ([2], [1, 1, 1], [1, 0, 1, 0], [1, 0, 1, 0, 1, 0], [0, 1, 0]),  # I3D R50
    3: ([0], [0, 0, 0], [0, 0, 0, 0], [0] * 23, [0, 0, 0]),          # C2D R101
    4: ([2], [1, 1, 1], [1, 0, 1, 0],
        [1 if i % 2 == 0 else 0 for i in range(23)], [0, 1, 0]),     # I3D R101
}


def released_blob_manifest(cfg) -> Dict[str, Shape]:
    """Name -> Caffe2 shape of every learnable blob in a released
    ``model_final.pkl`` trained with ``cfg``."""
    blobs: Dict[str, Shape] = {}
    use_affine = cfg.MODEL.USE_AFFINE
    nl_affine = cfg.NONLOCAL.USE_AFFINE
    nl_bias = not cfg.NONLOCAL.NO_BIAS

    def norm(prefix: str, dim: int, affine: bool) -> None:
        blobs[prefix + '_bn_s'] = (dim,)
        blobs[prefix + '_bn_b'] = (dim,)
        if not affine:                      # SpatialBN keeps running stats
            blobs[prefix + '_bn_rm'] = (dim,)
            blobs[prefix + '_bn_riv'] = (dim,)

    use_temp = ARC_USE_TEMP[cfg.MODEL.VIDEO_ARC_CHOICE]
    kt1 = 1 + 2 * use_temp[0][0]
    blobs['conv1_w'] = (64, 3, kt1, 7, 7)
    norm('res_conv1', 64, use_affine)

    n_blocks = BLOCKS[cfg.MODEL.DEPTH]
    dim_in = 64
    for s, num in enumerate(n_blocks, start=2):
        inner = 64 * 2 ** (s - 2)
        dim_out = inner * 4
        stage_temp = use_temp[s - 1]
        # NL interleave mod per stage (``resnet_video.py:254-292``).
        mod = 1000
        if s == 3 and cfg.NONLOCAL.CONV3_NONLOCAL:
            mod = 2 if cfg.MODEL.DEPTH == 101 else cfg.NONLOCAL.LAYER_MOD
        if s == 4 and cfg.NONLOCAL.CONV4_NONLOCAL:
            mod = (cfg.NONLOCAL.LAYER_MOD * 4 - 1
                   if cfg.MODEL.DEPTH == 101 else cfg.NONLOCAL.LAYER_MOD)
        for i in range(num):
            p = 'res{}_{}'.format(s, i)
            kt = 1 + 2 * stage_temp[i]
            blobs[p + '_branch2a_w'] = (inner, dim_in, kt, 1, 1)
            norm(p + '_branch2a', inner, use_affine)
            blobs[p + '_branch2b_w'] = (inner, inner, 1, 3, 3)
            norm(p + '_branch2b', inner, use_affine)
            blobs[p + '_branch2c_w'] = (dim_out, inner, 1, 1, 1)
            norm(p + '_branch2c', dim_out, use_affine)
            if dim_in != dim_out:           # shortcut B, first block only
                blobs[p + '_branch1_w'] = (dim_out, dim_in, 1, 1, 1)
                norm(p + '_branch1', dim_out, use_affine)
            dim_in = dim_out
            if i % mod == mod - 1:
                nl = 'nonlocal_conv{}_{}'.format(s, i)
                half = dim_out // 2
                for part in ('theta', 'phi', 'g'):
                    blobs['{}_{}_w'.format(nl, part)] = (half, dim_out, 1, 1, 1)
                    if nl_bias:
                        blobs['{}_{}_b'.format(nl, part)] = (half,)
                blobs[nl + '_out_w'] = (dim_out, half, 1, 1, 1)
                if nl_bias:
                    blobs[nl + '_out_b'] = (dim_out,)
                # NL out-norm: SpatialBN if USE_BN, AffineNd if USE_AFFINE,
                # none if neither (``nonlocal_helper.py:146-158``; released
                # configs set USE_BN False + USE_AFFINE True).
                if cfg.NONLOCAL.USE_BN:
                    norm(nl, dim_out, affine=False)
                elif nl_affine:
                    norm(nl, dim_out, affine=True)

    head_dim = dim_in                       # 2048
    if cfg.LFB.ENABLED:
        if cfg.LFB.FBO_TYPE == 'nl':
            latent = cfg.FBO_NL.LATENT_DIM
            if cfg.FBO_NL.INPUT_REDUCE_DIM:
                in_blob = ('box_pooled' if cfg.DATASET == 'ava'
                           else 'res5_2_branch2c_bn_pooled')
                blobs[in_blob + '_fbonl_reduc_w'] = (latent, dim_in, 1, 1, 1)
                if nl_bias:
                    blobs[in_blob + '_fbonl_reduc_b'] = (latent,)
                dim1 = latent
            else:
                dim1 = dim_in
            blobs['lfb_1x1_w'] = (latent, cfg.LFB.LFB_DIM, 1, 1, 1)
            if nl_bias:
                blobs['lfb_1x1_b'] = (latent,)
            for i in range(cfg.FBO_NL.NUM_LAYERS):
                p = 'lfb_nl{}'.format(i)
                blobs[p + '_theta_w'] = (latent, dim1, 1, 1, 1)
                blobs[p + '_phi_w'] = (latent, latent, 1, 1, 1)
                blobs[p + '_g_w'] = (latent, latent, 1, 1, 1)
                blobs[p + '_out_w'] = (dim1, latent, 1, 1, 1)
                if nl_bias:
                    for part in ('theta', 'phi', 'g'):
                        blobs['{}_{}_b'.format(p, part)] = (latent,)
                    blobs[p + '_out_b'] = (dim1,)
            head_dim += dim1
        else:                               # avg / max pooling FBO
            head_dim += cfg.LFB.LFB_DIM

    blobs['pred_w'] = (cfg.MODEL.NUM_CLASSES, head_dim)
    blobs['pred_b'] = (cfg.MODEL.NUM_CLASSES,)
    return blobs
