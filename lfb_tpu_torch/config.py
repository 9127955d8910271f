"""The flagship configuration, built without YAML.

``ava_r101_lfb_nl_3l``: R101-I3D-NL backbone, AVA RoI head and a 3-layer
FBO-NL over a 60 s x 5-feature (300-row) bank window.  The overrides are
those of ``__graft_entry__.py:_flagship_cfg`` plus every other key of the
released ``configs/ava_r101_lfb_nl_3l.yaml`` that the port reads (the
training dropout, the residual branches' zero gamma and the solver); the
machines the port runs on need not have ``pyyaml``, so nothing here reads a
YAML file.  ``TPU.REMAT`` is off: rematerialization is not ported, and the
flagship step at B = 8 fits one card without it (as ``bench.py`` runs it).
"""

from __future__ import annotations

import copy

from lfb_tpu.core.config import Config, default_config, finalize

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


def flagship_cfg(overrides: dict | None = None) -> Config:
    """The finalized flagship config; ``overrides`` ({dotted.key: value})
    apply after the flagship's own, before finalization."""
    cfg = default_config()
    for key, value in {**FLAGSHIP_OVERRIDES, **(overrides or {})}.items():
        node = cfg
        *parents, leaf = key.split('.')
        for part in parents:
            node = node[part]
        if leaf not in node:
            raise KeyError('Invalid config key: {}'.format(key))
        node[leaf] = copy.deepcopy(value)
    return finalize(cfg)
