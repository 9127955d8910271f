"""Import hygiene of the port: in a fresh interpreter, importing every
module of ``lfb_tpu_torch`` and running a tiny forward and device-bank eval
step loads neither ``jax`` nor ``cv2`` nor ``yaml`` (the GPU machines the
port runs on have no JAX install to rely on, no OpenCV and no PyYAML)."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib, json, pkgutil, sys
import numpy as np
import torch
import lfb_tpu_torch

names = sorted(m.name for m in pkgutil.walk_packages(
    lfb_tpu_torch.__path__, 'lfb_tpu_torch.'))
for name in names:
    importlib.import_module(name)

from lfb_tpu_torch.bank.device_bank import AvaDeviceBank
from lfb_tpu_torch.config import flagship_cfg
from lfb_tpu_torch.models.model import init_params
from lfb_tpu_torch.models.spec import build_spec
from lfb_tpu_torch.train.steps import make_eval_step

cfg = flagship_cfg({'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
                    'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
                    'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 2,
                    'TPU.COMPUTE_DTYPE': 'float32', 'NUM_GPUS': 1})
spec = build_spec(cfg, 'test')
params = init_params(spec, torch.Generator().manual_seed(0))
bank = AvaDeviceBank.build({0: {902: [np.ones(2048, np.float32)]}},
                           window_size=2, k=5)
out = make_eval_step(spec, bank=bank)(params, {
    'data': torch.zeros((1, 8, 32, 32, 3), dtype=torch.uint8),
    'proposals': torch.tensor([[0.0, 2.0, 2.0, 30.0, 30.0]]),
    'metadata': torch.tensor([[0.0, 902.0, 0.0, 0.0]])})
assert out['prob'].shape == (1, 80) and bool(torch.isfinite(out['prob']).all())
print(json.dumps({'modules': names,
                  'loaded': [m for m in ('jax', 'cv2', 'yaml')
                             if m in sys.modules]}))
'''


def test_port_imports_no_jax_cv2_or_yaml():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = sorted(m.name for m in pkgutil.walk_packages(
        [os.path.join(REPO, 'lfb_tpu_torch')], 'lfb_tpu_torch.'))
    assert result['modules'] == expected and len(expected) >= 20
    assert result['loaded'] == []
