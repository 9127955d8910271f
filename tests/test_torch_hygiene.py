"""Import hygiene of the port, in fresh interpreters.

* Importing every module of ``lfb_tpu_torch`` and ``chip_smoke``, running a
  tiny device-bank eval step, a tiny train step (dropout on, bank windows
  from the device bank), the same step again in a one-rank gloo group
  (``lfb_tpu_torch.parallel``) and a tiny Charades eval step (fused bottleneck,
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
  or ``lfb_tpu``; so does ``tools.train_net``'s (bank sweeps, a train step
  under ``TPU.REMAT 'stage'``, a checkpoint).
* ``python -m lfb_tpu_torch.tools.train_net --help`` and
  ``...tools.evaluate_actions --help`` load none of them, ``cv2`` included.
* Importing ``train.precise_bn``, ``train.c2_manifest``,
  ``tools.parity_eval``, ``utils.flops``, ``tools.mfu_probe``,
  ``tools.gpu_smoke`` or ``tools.bank_rehearsal`` alone loads none of them
  either, nor ``__graft_entry__``, nor does ``python -m
  lfb_tpu_torch.tools.{parity_eval,mfu_probe,gpu_smoke,bank_rehearsal}
  --help``.
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

import os, tempfile
from lfb_tpu_torch.parallel import mesh
with tempfile.TemporaryDirectory() as d:
    mesh.init_distributed('cpu', world=1, rank=0,
                          init_method='file://' + os.path.join(d, 'store'))
    _, _, _, aux = make_train_step(train_spec, cfg.SOLVER, bank=bank)(
        trainable, frozen, state, {
            'data': torch.zeros((1, 8, 32, 32, 3), dtype=torch.uint8),
            'proposals': torch.tensor([[0.0, 2.0, 2.0, 30.0, 30.0]]),
            'metadata': torch.tensor([[0.0, 902.0, 0.0, 0.0]]),
            'labels': torch.ones((1, 80)), 'box_mask': torch.ones(1)},
        torch.Generator().manual_seed(mesh.step_seed(0)), 0.01)
    assert mesh.world_size() == 1 and bool(torch.isfinite(aux['loss']))
    torch.distributed.destroy_process_group()

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


HELP_SCRIPT = r'''
import json, runpy, sys
sys.argv = [sys.argv[1], '--help']
try:
    runpy.run_module(sys.argv[0], run_name='__main__')
except SystemExit as e:
    assert e.code == 0, e.code
print(json.dumps(sorted(m for m in sys.modules
                        if m in %r or m.startswith('lfb_tpu.'))))
'''


@pytest.mark.parametrize('tool', ['train_net', 'evaluate_actions'])
def test_cli_help_loads_nothing_forbidden(tool):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', HELP_SCRIPT % (FORBIDDEN,),
         'lfb_tpu_torch.tools.' + tool],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'usage:' in proc.stdout and '--config_file' in proc.stdout or \
        '--verb_file' in proc.stdout
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


IMPORT_SCRIPT = r'''
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(m for m in sys.modules
                        if m in %r or m.startswith('lfb_tpu.'))))
'''


# The command lines among these modules, and a word their --help prints.
HELP_WORDS = {'tools.parity_eval': '--dryrun', 'tools.mfu_probe': 'grid',
              'tools.gpu_smoke': 'usage:',
              'tools.bank_rehearsal': '--bank-dtype'}


@pytest.mark.parametrize('module', ['train.precise_bn', 'train.c2_manifest',
                                    'tools.parity_eval', 'utils.flops',
                                    'tools.mfu_probe', 'tools.gpu_smoke',
                                    'tools.bank_rehearsal'])
def test_module_alone_loads_nothing_forbidden(module):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', IMPORT_SCRIPT % (FORBIDDEN + (
            '__graft_entry__',),),
         'lfb_tpu_torch.' + module],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    if module in HELP_WORDS:
        proc = subprocess.run(
            [sys.executable, '-c', HELP_SCRIPT % (FORBIDDEN + (
                '__graft_entry__',),),
             'lfb_tpu_torch.' + module],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert 'usage:' in proc.stdout and HELP_WORDS[module] in proc.stdout
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


CLI_SCRIPT = r'''
import json, sys
from lfb_tpu_torch.tools import test_net, train_net
if sys.argv[1] == 'train_net':
    checkpoint, metrics = train_net.main(sys.argv[2:])
    result = {'checkpoint': checkpoint, 'metrics': metrics}
else:
    result = {'full_map': test_net.main(sys.argv[2:])['full_map']}
result['loaded'] = sorted(m for m in sys.modules
                          if m in %r or m.startswith('lfb_tpu.'))
print(json.dumps(result))
'''


def test_test_net_cli_loads_cv2_and_nothing_forbidden(tmp_path):
    run_cli(tmp_path, 'test_net')


def test_train_net_cli_loads_cv2_and_nothing_forbidden(tmp_path):
    run_cli(tmp_path, 'train_net')


def run_cli(tmp_path, tool):
    """``tool``'s ``main`` in a fresh interpreter on a tiny AVA split."""
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
    if tool == 'train_net':
        opts += ['TPU.REMAT', 'stage', 'TRAIN.BATCH_SIZE', '2',
                 'TRAIN.PARAMS_FILE', '', 'SOLVER.MAX_ITER', '1',
                 'TRAIN.TEST_AFTER_TRAIN', 'False',
                 'AVA.FULL_EVAL_DURING_TRAINING', 'True']
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', CLI_SCRIPT % (FORBIDDEN,), tool,
         '--config_file', yaml, '--device', 'cpu'] + opts,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['loaded'] == ['cv2']
    assert (tmp_path / 'out' / 'val_lfb.pkl').is_file()
    if tool == 'test_net':
        assert 0.0 <= result['full_map'] <= 1.0
        assert (tmp_path / 'out'
                / 'detections_final_36_shift1_0.850.csv').is_file()
    else:
        assert (tmp_path / 'out' / 'train_lfb.pkl').is_file()
        assert result['metrics'] is None
        assert result['checkpoint'].endswith(os.path.join(
            'out', 'checkpoints', 'c2_model_iter1.pkl'))
