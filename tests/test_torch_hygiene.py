"""Import hygiene of the port, in fresh interpreters.

* Importing every module of ``lfb_tpu_torch`` and ``chip_smoke``, running a
  tiny device-bank eval step, a tiny train step (dropout on, bank windows
  from the device bank) and a tiny Charades eval step (fused bottleneck,
  frame-level bank), loading the EPIC configs from their YAML files and a
  checkpoint through the port's checkpoint layer loads no module of the JAX
  package ``lfb_tpu`` (the port keeps its own copies of what it took from
  it), and none of ``jax``, ``cv2``, ``yaml`` or ``sklearn``.  The GPU
  machines the port runs on have no JAX install to rely on and no
  scikit-learn; they have OpenCV and PyYAML, but the port reads its YAML
  itself and imports OpenCV only
  where it decodes and resizes frames (``data/transforms.py``) or reads a
  frame's size (``eval/multicrop.py``), at first use.
* ``python -m lfb_tpu_torch.tools.test_net``'s ``main`` with ``--device
  cpu`` on a tiny AVA split on disk (bank sweep, test sweep, detections
  CSV, frame-mAP) loads ``cv2`` and none of ``jax``, ``yaml``, ``sklearn``
  or ``lfb_tpu``.
"""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORBIDDEN = ('jax', 'cv2', 'yaml', 'sklearn', 'lfb_tpu')

SCRIPT = r'''
import importlib, json, pkgutil, sys
FORBIDDEN = %r
import numpy as np
import torch
import lfb_tpu_torch

names = sorted(m.name for m in pkgutil.walk_packages(
    lfb_tpu_torch.__path__, 'lfb_tpu_torch.'))
for name in names:
    importlib.import_module(name)
import chip_smoke

from lfb_tpu_torch.bank.device_bank import AvaDeviceBank
from lfb_tpu_torch.config import flagship_cfg
from lfb_tpu_torch.models.model import init_params
from lfb_tpu_torch.models.spec import build_spec
from lfb_tpu_torch.train import optimizer
from lfb_tpu_torch.train.steps import make_eval_step, make_train_step, split_params

cfg = flagship_cfg({'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
                    'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
                    'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32,
                    'LFB.WINDOW_SIZE': 2, 'TPU.COMPUTE_DTYPE': 'float32',
                    'NUM_GPUS': 1})
spec = build_spec(cfg, 'test')
params = init_params(spec, torch.Generator().manual_seed(0))
bank = AvaDeviceBank.build({0: {902: [np.ones(2048, np.float32)]}},
                           window_size=2, k=5, device='cpu')
out = make_eval_step(spec, bank=bank)(params, {
    'data': torch.zeros((1, 8, 32, 32, 3), dtype=torch.uint8),
    'proposals': torch.tensor([[0.0, 2.0, 2.0, 30.0, 30.0]]),
    'metadata': torch.tensor([[0.0, 902.0, 0.0, 0.0]])})
assert out['prob'].shape == (1, 80) and bool(torch.isfinite(out['prob']).all())

train_spec = build_spec(cfg, 'train')
trainable, frozen = split_params(train_spec, params)
state = optimizer.init_state(params, set(frozen))
_, _, state, aux = make_train_step(train_spec, cfg.SOLVER, bank=bank)(
    trainable, frozen, state, {
        'data': torch.zeros((1, 8, 32, 32, 3), dtype=torch.uint8),
        'proposals': torch.tensor([[0.0, 2.0, 2.0, 30.0, 30.0]]),
        'metadata': torch.tensor([[0.0, 902.0, 0.0, 0.0]]),
        'labels': torch.ones((1, 80)), 'box_mask': torch.ones(1)},
    torch.Generator().manual_seed(0), optimizer.get_lr_at_iter(cfg.SOLVER, 0))
assert bool(torch.isfinite(aux['loss'])) and state.momentum['pred_w'].any()

from lfb_tpu_torch.bank.device_bank import FrameDeviceBank
from lfb_tpu_torch.config import charades_cfg
cfg = charades_cfg({'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
                    'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
                    'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 2,
                    'TPU.COMPUTE_DTYPE': 'float32',
                    'TPU.PALLAS_BOTTLENECK': True, 'NUM_GPUS': 1})
spec = build_spec(cfg, 'test')
bank = FrameDeviceBank.build({0: {11: np.ones(2048, np.float32)}},
                             window_size=2, device='cpu')
out = make_eval_step(spec, bank=bank)(
    init_params(spec, torch.Generator().manual_seed(0)), {
        'data': torch.zeros((1, 8, 32, 32, 3), dtype=torch.uint8),
        'lfb_video_idx': torch.tensor([0]), 'lfb_center': torch.tensor([11])})
assert out['prob'].shape == (1, 157) and bool(torch.isfinite(out['prob']).all())

import os, tempfile
from lfb_tpu_torch.config import epic_noun_cfg, epic_verb_cfg
from lfb_tpu_torch.train import checkpoints
assert epic_verb_cfg({'NUM_GPUS': 1}).MODEL.NUM_CLASSES == 125
assert epic_noun_cfg().LFB.WINDOW_SIZE == 120
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, 'c2_model_iter1.pkl')
    checkpoints.save_params(path, {'pred_b': torch.ones(3)}, model_iter=1,
                            lr=0.1)
    loaded = checkpoints.load_params_into(path, {'pred_b': torch.zeros(3)},
                                          device='cpu')[0]
assert bool((loaded['pred_b'] == 1).all())
print(json.dumps({'modules': names,
                  'loaded': sorted(m for m in sys.modules
                                   if m in FORBIDDEN
                                   or m.startswith('lfb_tpu.'))}))
'''


def test_port_imports_no_jax_cv2_or_yaml():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', SCRIPT % (FORBIDDEN,)],
                          cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = sorted(m.name for m in pkgutil.walk_packages(
        [os.path.join(REPO, 'lfb_tpu_torch')], 'lfb_tpu_torch.'))
    assert result['modules'] == expected and len(expected) >= 20
    assert result['loaded'] == []


CLI_SCRIPT = r'''
import json, sys
from lfb_tpu_torch.tools import test_net
metrics = test_net.main(sys.argv[1:])
print(json.dumps({'full_map': metrics['full_map'],
                  'loaded': sorted(m for m in sys.modules
                                   if m in %r or m.startswith('lfb_tpu.'))}))
'''


def test_test_net_cli_loads_cv2_and_nothing_forbidden(tmp_path):
    pytest.importorskip('cv2')
    import torch
    from lfb_tpu_torch.core.config import load_config
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train import checkpoints
    from tests import synthetic
    ov = synthetic.build_ava(str(tmp_path), num_secs=2)
    yaml = os.path.join(REPO, 'configs', 'ava_r101_lfb_nl_3l.yaml')
    opts = ['NUM_GPUS', '1', 'TPU.REMAT', "''", 'MODEL.DEPTH', '50',
            'MODEL.VIDEO_ARC_CHOICE', '2', 'TRAIN.VIDEO_LENGTH', '4',
            'TEST.VIDEO_LENGTH', '4', 'TRAIN.CROP_SIZE', '32',
            'TEST.CROP_SIZE', '32', 'TEST.SCALE', '36',
            'LFB.WINDOW_SIZE', '3', 'TPU.COMPUTE_DTYPE', 'float32',
            'TPU.MAX_BOXES_PER_CLIP', '4', 'TEST.BATCH_SIZE', '4',
            'DATALOADER.NUM_WORKERS', '2', 'DATADIR', ov['DATADIR'],
            'AVA.FRAME_LIST_DIR', ov['AVA']['FRAME_LIST_DIR'],
            'AVA.ANNOTATION_DIR', ov['AVA']['ANNOTATION_DIR'],
            'CHECKPOINT.DIR', str(tmp_path / 'out')]
    cfg = load_config(yaml, opts)
    for key, infer in (('LFB.MODEL_PARAMS_FILE', True),
                       ('TEST.PARAMS_FILE', False)):
        path = str(tmp_path / (key + '.pkl'))
        checkpoints.save_params(path, init_params(
            build_spec(cfg, 'val', lfb_infer_only=infer),
            torch.Generator().manual_seed(0)), model_iter=0, lr=0.0)
        opts += [key, path]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', CLI_SCRIPT % (FORBIDDEN,), '--config_file',
         yaml, '--device', 'cpu'] + opts,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['loaded'] == ['cv2']
    assert 0.0 <= result['full_map'] <= 1.0
    assert (tmp_path / 'out' / 'detections_final_36_shift1_0.850.csv').is_file()
    assert (tmp_path / 'out' / 'val_lfb.pkl').is_file()
