"""Static model specification (port of ``lfb_tpu/models/spec.py``).

The body of the JAX package's spec is jax-free, but importing it loads jax
through ``lfb_tpu/models/__init__``, so the port keeps its own copy.  The
architecture tables follow reference ``lib/models/resnet_video.py:33-130``:
``use_temp_convs`` entries give the temporal kernel radius of each block's
first 1x1 conv (0 -> kT=1, 1 -> kT=3, 2 -> kT=5).

The TPU-only fields (the Pallas switches, shard_map axis) are gone: on the
port a CUDA tensor always goes through the hand-written kernels and a CPU
tensor through their plain PyTorch versions.  One switch stays,
``use_pallas_bottleneck`` (``TPU.PALLAS_BOTTLENECK``): it picks the fused
identity bottleneck, a different program for the same block rather than a
kernel of an op that always runs.  ``remat`` (``TPU.REMAT``) picks what a
training forward recomputes in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

BLOCK_COUNTS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# Feature dims of res2..res5 outputs (bottleneck x4 expansion).
STAGE_DIMS = (256, 512, 1024, 2048)

# TPU.REMAT's values (``lfb_tpu/core/config.py``).
REMAT_MODES = ('', 'stage', 'res2', 'block')


def arc_tables(arc_choice: int, depth: int):
    """Temporal-conv pattern per stage: (conv1, res2, res3, res4, res5)."""
    n1, n2, n3, n4 = BLOCK_COUNTS[depth]
    if arc_choice in (1, 3):          # C2D
        use_temp = ([0], [0] * n1, [0] * n2, [0] * n3, [0] * n4)
    elif arc_choice == 2:             # I3D R50
        use_temp = ([2], [1, 1, 1], [1, 0, 1, 0], [1, 0, 1, 0, 1, 0], [0, 1, 0])
    elif arc_choice == 4:             # I3D R101
        use_temp = ([2], [1, 1, 1], [1, 0, 1, 0],
                    [1 if i % 2 == 0 else 0 for i in range(n3)], [0, 1, 0])
    else:
        raise ValueError('Unknown VIDEO_ARC_CHOICE {}'.format(arc_choice))
    temp_strides = tuple([1] * len(stage) for stage in use_temp)
    return tuple(tuple(s) for s in use_temp), tuple(tuple(s) for s in temp_strides)


def nonlocal_placement(depth: int, layer_mod: int, conv3_nl: bool,
                       conv4_nl: bool) -> Mapping[str, Tuple[int, ...]]:
    """Block indices after which an NL block is inserted, per stage
    (reference ``resnet_video.py:213-289`` + ``resnet_helper.py:150-153``)."""
    n1, n2, n3, n4 = BLOCK_COUNTS[depth]
    mod3 = 2 if depth == 101 else layer_mod
    if not conv3_nl:
        mod3 = 10 ** 9
    mod4 = layer_mod * 4 - 1 if depth == 101 else layer_mod
    if not conv4_nl:
        mod4 = 10 ** 9
    res3 = tuple(i for i in range(n2) if i % mod3 == mod3 - 1)
    res4 = tuple(i for i in range(n3) if i % mod4 == mod4 - 1)
    return {'res3': res3, 'res4': res4}


@dataclasses.dataclass(frozen=True)
class NonlocalSpec:
    conv_init_std: float = 0.01
    no_bias: bool = False
    use_maxpool: bool = True
    use_softmax: bool = True
    use_zero_init_conv: bool = False
    use_bn: bool = True
    use_scale: bool = True
    use_affine: bool = False
    bn_epsilon: float = 1.0000001e-5
    bn_init_gamma: float = 0.0


@dataclasses.dataclass(frozen=True)
class FBOSpec:
    enabled: bool = False
    fbo_type: str = 'nl'            # 'avg' | 'max' | 'nl'
    lfb_dim: int = 2048
    window_size: int = 100          # features (or secs*feats/sec for AVA)
    num_lfb_feat: int = 100         # actual bank-window row count per example
    num_layers: int = 2
    pre_act: bool = True
    pre_act_ln: bool = True
    scale: bool = True
    latent_dim: int = 512
    input_reduce_dim: bool = True
    dropout_rate: float = 0.2
    input_dropout_on: bool = True
    lfb_dropout_on: bool = True


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    depth: int = 50
    arc_choice: int = 2
    num_classes: int = 80
    dataset: str = 'ava'            # 'ava' | 'charades' | 'epic'
    multi_label: bool = True
    use_affine: bool = True
    bn_epsilon: float = 1.0000001e-5
    bn_momentum: float = 0.9
    bn_init_gamma: float = 0.0
    fc_init_std: float = 0.01
    dim_inner_base: int = 64        # NUM_GROUPS * WIDTH_PER_GROUP
    groups: int = 1
    dilations_after_conv5: bool = True
    freeze_backbone: bool = False
    video_length: int = 32          # frames per clip (this split)
    train_video_length: int = 32    # cfg.TRAIN.VIDEO_LENGTH (head pooling uses it)
    crop_size: int = 224
    dropout_rate: float = 0.3
    nl: NonlocalSpec = NonlocalSpec()
    nl_blocks: Mapping[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=lambda: {'res3': (1, 3), 'res4': (1, 3, 5)})
    nl_group_size: int = 4          # grouped-temporal NL in res3 (affine mode)
    fbo: FBOSpec = FBOSpec()
    lfb_infer_only: bool = False
    roi_resolution: int = 7
    roi_spatial_scale: float = 1.0 / 16.0
    compute_dtype: str = 'bfloat16'
    # Inference runs each identity block as one fused kernel
    # (``ops/cuda_bottleneck.py``); training keeps the unfused path.
    use_pallas_bottleneck: bool = False
    # Rematerialization in training: '' (none), 'stage' (each res-stage),
    # 'res2' (res2 only) or 'block' (each bottleneck block).
    remat: str = 'stage'
    # Per-channel normalization constants in the MODEL's channel order
    # (RGB unless USE_BGR), applied on device when 'data' arrives uint8.
    data_mean: Tuple[float, ...] = (0.45, 0.45, 0.45)
    data_std: Tuple[float, ...] = (0.225, 0.225, 0.225)

    @property
    def block_counts(self) -> Tuple[int, int, int, int]:
        return BLOCK_COUNTS[self.depth]

    @property
    def arc(self):
        return arc_tables(self.arc_choice, self.depth)

    @property
    def pool_stride(self) -> int:
        # Temporal extent entering the head (reference uses
        # TRAIN.VIDEO_LENGTH/2 regardless of split, ``resnet_video.py:63-114``).
        return self.train_video_length // 2

    @property
    def head_type(self) -> str:
        return 'roi' if self.dataset == 'ava' else 'basic'

    @property
    def out_spatial_dim(self) -> int:
        return self.crop_size // 16

    @property
    def head_dim(self) -> int:
        dim = STAGE_DIMS[-1]
        if self.fbo.enabled and not self.lfb_infer_only:
            dim += (self.fbo.latent_dim if self.fbo.fbo_type == 'nl'
                    else self.fbo.lfb_dim)
        return dim


def build_spec(cfg, split: str, lfb_infer_only: bool = False) -> ModelSpec:
    """Derive an immutable ModelSpec from a finalized Config for one phase
    (the train split, unless ``lfb_infer_only``, is the training phase)."""
    is_train = split == 'train' and not lfb_infer_only
    if cfg.TPU.REMAT not in REMAT_MODES:
        raise ValueError('TPU.REMAT {!r}: not one of {}'.format(
            cfg.TPU.REMAT, REMAT_MODES))
    video_length = (cfg.TRAIN.VIDEO_LENGTH if split == 'train'
                    else cfg.TEST.VIDEO_LENGTH)

    nl = NonlocalSpec(
        conv_init_std=cfg.NONLOCAL.CONV_INIT_STD,
        no_bias=bool(cfg.NONLOCAL.NO_BIAS),
        use_maxpool=cfg.NONLOCAL.USE_MAXPOOL,
        use_softmax=cfg.NONLOCAL.USE_SOFTMAX,
        use_zero_init_conv=cfg.NONLOCAL.USE_ZERO_INIT_CONV,
        use_bn=cfg.NONLOCAL.USE_BN,
        use_scale=cfg.NONLOCAL.USE_SCALE,
        use_affine=cfg.NONLOCAL.USE_AFFINE,
        bn_epsilon=cfg.NONLOCAL.BN_EPSILON,
        bn_init_gamma=cfg.NONLOCAL.BN_INIT_GAMMA,
    )

    if cfg.DATASET == 'ava':
        num_lfb_feat = cfg.LFB.WINDOW_SIZE * cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP
    else:
        num_lfb_feat = cfg.LFB.WINDOW_SIZE

    fbo = FBOSpec(
        enabled=cfg.LFB.ENABLED,
        fbo_type=cfg.LFB.FBO_TYPE,
        lfb_dim=cfg.LFB.LFB_DIM,
        window_size=cfg.LFB.WINDOW_SIZE,
        num_lfb_feat=num_lfb_feat,
        num_layers=cfg.FBO_NL.NUM_LAYERS,
        pre_act=cfg.FBO_NL.PRE_ACT,
        pre_act_ln=cfg.FBO_NL.PRE_ACT_LN,
        scale=cfg.FBO_NL.SCALE,
        latent_dim=cfg.FBO_NL.LATENT_DIM,
        input_reduce_dim=cfg.FBO_NL.INPUT_REDUCE_DIM,
        dropout_rate=cfg.FBO_NL.DROPOUT_RATE,
        input_dropout_on=cfg.FBO_NL.INPUT_DROPOUT_ON,
        lfb_dropout_on=cfg.FBO_NL.LFB_DROPOUT_ON,
    )

    return ModelSpec(
        depth=cfg.MODEL.DEPTH,
        arc_choice=cfg.MODEL.VIDEO_ARC_CHOICE,
        num_classes=cfg.MODEL.NUM_CLASSES,
        dataset=cfg.DATASET,
        multi_label=cfg.MODEL.MULTI_LABEL,
        use_affine=cfg.MODEL.USE_AFFINE,
        bn_epsilon=cfg.MODEL.BN_EPSILON,
        bn_momentum=cfg.MODEL.BN_MOMENTUM,
        bn_init_gamma=cfg.MODEL.BN_INIT_GAMMA,
        fc_init_std=cfg.MODEL.FC_INIT_STD,
        dim_inner_base=cfg.RESNETS.NUM_GROUPS * cfg.RESNETS.WIDTH_PER_GROUP,
        groups=cfg.RESNETS.NUM_GROUPS,
        dilations_after_conv5=cfg.MODEL.DILATIONS_AFTER_CONV5,
        freeze_backbone=cfg.MODEL.FREEZE_BACKBONE,
        video_length=video_length,
        train_video_length=cfg.TRAIN.VIDEO_LENGTH,
        crop_size=cfg.TRAIN.CROP_SIZE if is_train else cfg.TEST.CROP_SIZE,
        dropout_rate=cfg.TRAIN.DROPOUT_RATE,
        nl=nl,
        nl_blocks=nonlocal_placement(
            cfg.MODEL.DEPTH, cfg.NONLOCAL.LAYER_MOD,
            cfg.NONLOCAL.CONV3_NONLOCAL, cfg.NONLOCAL.CONV4_NONLOCAL),
        fbo=fbo,
        lfb_infer_only=lfb_infer_only,
        roi_resolution=cfg.ROI.XFORM_RESOLUTION,
        roi_spatial_scale=1.0 / cfg.ROI.SCALE_FACTOR,
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        use_pallas_bottleneck=bool(cfg.TPU.PALLAS_BOTTLENECK),
        remat=cfg.TPU.REMAT,
        # cfg.DATA_MEAN/STD are BGR-ordered (reference convention); flip to
        # the model's channel order when the loader emits RGB.
        data_mean=tuple(cfg.DATA_MEAN if cfg.MODEL.USE_BGR
                        else cfg.DATA_MEAN[::-1]),
        data_std=tuple(cfg.DATA_STD if cfg.MODEL.USE_BGR
                       else cfg.DATA_STD[::-1]),
    )
