"""The configurations the port runs.

* ``ava_r101_lfb_nl_3l`` (:func:`flagship_cfg`): R101-I3D-NL backbone, AVA
  RoI head and a 3-layer FBO-NL over a 60 s x 5-feature (300-row) bank
  window.  The overrides are those of ``__graft_entry__.py:_flagship_cfg``
  plus every other key of the released ``configs/ava_r101_lfb_nl_3l.yaml``
  that the port reads (the training dropout, the residual branches' zero
  gamma and the solver).
* ``charades_r101_lfb_nl`` (:func:`charades_cfg`): the same backbone without
  res5 dilation, a clip-level head over 157 sigmoid classes and a 2-layer
  post-act FBO-NL over 20 rows of a frame-level bank (2 clips a second of
  24 fps video), every key of ``configs/charades_r101_lfb_nl.yaml`` that the
  port reads.
* ``epic_verb_r50_lfb_nl`` / ``epic_noun_r50_lfb_nl`` (:func:`epic_verb_cfg`,
  :func:`epic_noun_cfg`): R50-I3D-NL without res5 dilation, a clip-level
  softmax head (125 verbs, 352 nouns) and a 2-layer pre-act FBO-NL over 40
  rows of a bank the model extracts (one clip a second) or 120 rows of a
  detector bank (10 boxes a second) that is loaded.  These two are read
  from the released YAMLs of ``configs/`` by :func:`load_config`.

The flagship and Charades configs are built from dicts, the two EPIC ones
from their YAML files; ``tests/test_torch_config.py`` holds the first two
to their YAML files too.  ``TPU.REMAT`` is off: rematerialization is not
ported, and the flagship step at B = 8 fits one card without it (as
``bench.py`` runs it).  ``TPU.PALLAS_BOTTLENECK`` stays at its default
(off); callers set it.
"""

from __future__ import annotations

import copy
import os

from lfb_tpu_torch.core.config import (Config, default_config, finalize,
                                       load_config)

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')

# The port's own settings on top of a released YAML.
PORT_SETTINGS = {'TPU.REMAT': ''}

FLAGSHIP_OVERRIDES = {
    'DATASET': 'ava',
    'MODEL.MODEL_NAME': 'resnet_video',
    'MODEL.NUM_CLASSES': 80,
    'MODEL.DEPTH': 101,
    'MODEL.VIDEO_ARC_CHOICE': 4,
    'MODEL.MULTI_LABEL': True,
    'MODEL.USE_AFFINE': True,
    'MODEL.BN_INIT_GAMMA': 0.0,
    'NONLOCAL.USE_BN': False,
    'NONLOCAL.USE_AFFINE': True,
    'NONLOCAL.USE_ZERO_INIT_CONV': True,
    'LFB.ENABLED': True,
    'LFB.FBO_TYPE': 'nl',
    'FBO_NL.NUM_LAYERS': 3,
    'LFB.WINDOW_SIZE': 60,
    'TRAIN.DROPOUT_RATE': 0.3,
    'SOLVER.BASE_LR': 0.04,
    'SOLVER.LR_POLICY': 'steps_with_relative_lrs',
    'SOLVER.LRS': [1, 0.1, 0.01, 0.001],
    'SOLVER.STEP_SIZES': [100000, 20000, 20000],
    'SOLVER.MAX_ITER': 140000,
    'SOLVER.MOMENTUM': 0.9,
    'SOLVER.NESTEROV': True,
    'SOLVER.WEIGHT_DECAY': 1e-6,
    'SOLVER.WEIGHT_DECAY_BN': 0.0,
    'SOLVER.SCALE_MOMENTUM': True,
    'SOLVER.WARMUP.WARMUP_ON': True,
    'SOLVER.WARMUP.WARMUP_START_LR': 0.01,
    'SOLVER.WARMUP.WARMUP_END_ITER': 2000,
    'TPU.REMAT': '',
}


CHARADES_OVERRIDES = {
    'DATASET': 'charades',
    'CHARADES.LFB_CLIPS_PER_SECOND': 2,
    'MODEL.MODEL_NAME': 'resnet_video',
    'MODEL.NUM_CLASSES': 157,
    'MODEL.DEPTH': 101,
    'MODEL.VIDEO_ARC_CHOICE': 4,
    'MODEL.MULTI_LABEL': True,
    'MODEL.USE_AFFINE': True,
    'MODEL.BN_EPSILON': 1.0000001e-05,
    'MODEL.BN_INIT_GAMMA': 0.0,
    'MODEL.BN_MOMENTUM': 0.9,
    'MODEL.DILATIONS_AFTER_CONV5': False,
    'MODEL.FREEZE_BACKBONE': True,
    'NONLOCAL.CONV3_NONLOCAL': True,
    'NONLOCAL.CONV4_NONLOCAL': True,
    'NONLOCAL.USE_AFFINE': True,
    'NONLOCAL.USE_BN': False,
    'NONLOCAL.USE_SCALE': True,
    'NONLOCAL.USE_ZERO_INIT_CONV': True,
    'RESNETS.NUM_GROUPS': 1,
    'RESNETS.WIDTH_PER_GROUP': 64,
    'LFB.ENABLED': True,
    'LFB.FBO_TYPE': 'nl',
    'LFB.WINDOW_SIZE': 20,
    'FBO_NL.PRE_ACT': False,
    'TEST.BATCH_SIZE': 16,
    'TEST.CROP_SIZE': 256,
    'TEST.DATASET_SIZE': 1814,
    'TEST.DATA_TYPE': 'val',
    'TEST.SAMPLE_RATE': 4,
    'TEST.SCALE': 256,
    'TEST.VIDEO_LENGTH': 32,
    'TRAIN.BATCH_SIZE': 16,
    'TRAIN.CROP_SIZE': 224,
    'TRAIN.DATASET_SIZE': 7811,
    'TRAIN.DROPOUT_RATE': 0.3,
    'TRAIN.SAMPLE_RATE': 4,
    'TRAIN.VIDEO_LENGTH': 32,
    'SOLVER.BASE_LR': 0.02,
    'SOLVER.LR_POLICY': 'steps_with_relative_lrs',
    'SOLVER.LRS': [1, 0.1],
    'SOLVER.STEP_SIZES': [10000, 2000],
    'SOLVER.MAX_ITER': 12000,
    'SOLVER.MOMENTUM': 0.9,
    'SOLVER.NESTEROV': True,
    'SOLVER.WEIGHT_DECAY': 1.25e-05,
    'SOLVER.WEIGHT_DECAY_BN': 0.0,
    'SOLVER.SCALE_MOMENTUM': True,
    'TPU.REMAT': '',
}


def _finalized(base: dict, overrides: dict | None) -> Config:
    cfg = default_config()
    for key, value in {**base, **(overrides or {})}.items():
        node = cfg
        *parents, leaf = key.split('.')
        for part in parents:
            node = node[part]
        if leaf not in node:
            raise KeyError('Invalid config key: {}'.format(key))
        node[leaf] = copy.deepcopy(value)
    return finalize(cfg)


def flagship_cfg(overrides: dict | None = None) -> Config:
    """The finalized flagship config; ``overrides`` ({dotted.key: value})
    apply after the flagship's own, before finalization."""
    return _finalized(FLAGSHIP_OVERRIDES, overrides)


def charades_cfg(overrides: dict | None = None) -> Config:
    """The finalized Charades R101 LFB-NL config, as :func:`flagship_cfg`."""
    return _finalized(CHARADES_OVERRIDES, overrides)


def _released_cfg(name: str, overrides: dict | None = None) -> Config:
    """``load_config`` of ``configs/{name}.yaml`` with
    :data:`PORT_SETTINGS` and ``overrides`` ({dotted.key: value}) as CLI
    overrides, so each is type-checked against the key's default."""
    opts = []
    for key, value in {**PORT_SETTINGS, **(overrides or {})}.items():
        opts += [key, repr(value)]
    return load_config(os.path.join(CONFIG_DIR, name + '.yaml'), opts)


def epic_verb_cfg(overrides: dict | None = None) -> Config:
    """The finalized EPIC-Kitchens verb R50 LFB-NL config."""
    return _released_cfg('epic_verb_r50_lfb_nl', overrides)


def epic_noun_cfg(overrides: dict | None = None) -> Config:
    """The finalized EPIC-Kitchens noun R50 LFB-NL config."""
    return _released_cfg('epic_noun_r50_lfb_nl', overrides)
