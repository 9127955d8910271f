"""``python -m lfb_tpu_torch.tools.train_net`` end to end on the CPU, against
``tools/train_net.py``.

Both run the flagship YAML (``configs/ava_r101_lfb_nl_3l.yaml``) on the tiny
on-disk AVA split of ``tests/synthetic.py``, cut as
``test_torch_tools.TINY`` (R50 arc 2, 8 channels a group, T 4, crop 32,
f32) with ``TPU.REMAT 'stage'``: the bank sweeps of both splits with the
same saved baseline pickle, then 3 training steps (batches of 4) from the
same saved seeded pickle (``TRAIN.PARAMS_FILE``; ``CHECKPOINT.CONVERT_MODEL
False``, since converting strips the classifier, which each package would
then draw from its own random stream), a checkpoint at iterations 2 and 3,
the train-time eval at 3 and the test of the last checkpoint.  Host bank
windows (``TPU.DEVICE_BANK False``, drawn by numpy, the same on both sides),
dropout 0, XLA references on the ``lfb_tpu`` side.  The schedule: no
warm-up, an LR step (x 0.1) at iteration 2 with ``SOLVER.SCALE_MOMENTUM``,
so that both the first step (the pickle's LR 0.01 against 0.04) and the LR
step rescale the momentum.

Tolerances: the losses both trainers log each iteration (``LOG_PERIOD 1``)
within 1e-5 relative; in both checkpoints ``model_iter`` and ``lr``
exactly, the params within 1e-5 and the momentum within 1e-4 of each
tensor's largest value; the banks as ``test_torch_tools.assert_same_bank``;
the frame-mAPs within 1e-6 and the detections CSVs by
``test_torch_tools.assert_same_files``, but with the share of lines whose
printed score tips by one unit bounded at 5% rather than 1%: after three
steps the two models' logits differ by f32 noise of about 1e-6, so more
scores tip across a ``%.04f`` boundary than in a pure test (20 of 1,280
lines here).  A second port run resumes from the last checkpoint bitwise.
"""

import importlib.util
import json
import logging
import os
import re
import shutil
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('cv2')

from lfb_tpu.core.config import load_config as jax_load_config  # noqa: E402
import lfb_tpu_torch.tools.train_net as port_train_net  # noqa: E402
from lfb_tpu_torch.train import checkpoints as port_ckpt  # noqa: E402
from lfb_tpu_torch.train import optimizer as port_opt  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_tools import (AVA_YAML, TINY, assert_same_bank,  # noqa: E402
                                    assert_same_files, dataset_opts,
                                    read_bank, save_weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ['TPU.REMAT', 'stage', 'TPU.DEVICE_BANK', 'False',
         'TPU.USE_PALLAS', 'False', 'TRAIN.DROPOUT_RATE', '0.0',
         'FBO_NL.DROPOUT_RATE', '0.0', 'TRAIN.BATCH_SIZE', '4',
         'CHECKPOINT.CONVERT_MODEL', 'False',
         'SOLVER.WARMUP.WARMUP_ON', 'False', 'SOLVER.STEP_SIZES', '[2, 1]',
         'SOLVER.SCALE_MOMENTUM', 'True', 'SOLVER.MAX_ITER', '3',
         'CHECKPOINT.CHECKPOINT_PERIOD', '2', 'TRAIN.EVAL_PERIOD', '3',
         'LOG_PERIOD', '1', 'TRAIN.TEST_AFTER_TRAIN', 'True']
LOSS_LINE = re.compile(r'\| Train ETA: .* Iters \[(\d+)/\d+\] Loss +(\S+)')


def _reference_train_net():
    """``tools/train_net.py`` as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location(
        'reference_train_net', os.path.join(REPO, 'tools', 'train_net.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Records(logging.Handler):
    """The messages logged while it is attached to the root logger."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        root = logging.getLogger()
        self.root_level = root.level
        root.setLevel(logging.INFO)
        root.addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)
        logging.getLogger().setLevel(self.root_level)


class RecordingTrainer(port_train_net.Trainer):
    """The port's ``Trainer``, keeping what its run did for the tests: the
    state it starts from (``start``: start_iter, LR, params and momentum,
    copied), the LR of every iteration (``lrs``), every momentum rescale
    (``momentum_scales``: (iteration, new LR / old LR)), every drained loss
    (``losses``) and every eval's metrics (``evals``).  ``made`` lists the
    trainers built while it stands in for ``train_net.Trainer``."""

    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.start = (self.start_iter, self.current_lr,
                      {k: v.clone() for k, v in self.params().items()},
                      {k: v.clone() for k, v in self.mstate.momentum.items()})
        self.lrs, self.momentum_scales, self.losses, self.evals = (
            {}, [], {}, {})
        update_train = self.train_meter.update_train

        def record_loss(loss, *rest):
            # The drain feeds the meter the losses in iteration order.
            self.losses[self.start_iter + len(self.losses)] = loss
            update_train(loss, *rest)

        self.train_meter.update_train = record_loss
        RecordingTrainer.made.append(self)

    def _update_lr(self, cur_iter):
        correct = port_opt.correct_momentum

        def record_scale(state, scale):
            self.momentum_scales.append((cur_iter, scale))
            return correct(state, scale)

        with mock.patch.object(port_opt, 'correct_momentum', record_scale):
            self.lrs[cur_iter] = super()._update_lr(cur_iter)
        return self.lrs[cur_iter]

    def evaluate(self, name='latest'):
        self.evals[name] = super().evaluate(name)
        return self.evals[name]


def recorded_main(argv):
    """``train_net.main(argv)`` with a :class:`RecordingTrainer`: (its
    return value, the trainer)."""
    RecordingTrainer.made.clear()
    with mock.patch.object(port_train_net, 'Trainer', RecordingTrainer):
        result = port_train_net.main(argv)
    (trainer,) = RecordingTrainer.made
    return result, trainer


def losses(messages):
    """{iteration: logged loss} of the '| Train ETA' lines."""
    return {int(m.group(1)): float(m.group(2))
            for m in map(LOSS_LINE.search, messages) if m}


def logged(messages, prefix):
    return [m[len(prefix):] for m in messages if m.startswith(prefix)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """One run of each side on the same split, config and pickles: (opts,
    {side: (output dir, log messages)}, the port's (last checkpoint, test
    metrics) and its trainer)."""
    root = str(tmp_path_factory.mktemp('train_net'))
    opts = TINY + dataset_opts(synthetic.build_ava(root))
    weights = save_weights(AVA_YAML, opts, root)
    opts += TRAIN + [weights[0], weights[1], 'TRAIN.PARAMS_FILE', weights[3]]
    out = {}
    dirs = {k: os.path.join(root, k) for k in ('port', 'ref')}
    os.makedirs(dirs['ref'])
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        with Records() as records:
            _reference_train_net().train(jax_load_config(
                AVA_YAML, opts + ['CHECKPOINT.DIR', dirs['ref']]))
        out['ref'] = (dirs['ref'], records.messages)
    finally:
        sys.path.remove(os.path.join(REPO, 'tools'))
    with Records() as records:
        result, trainer = recorded_main(
            ['--config_file', AVA_YAML, '--device', 'cpu'] + opts
            + ['CHECKPOINT.DIR', dirs['port']])
    out['port'] = (dirs['port'], records.messages)
    return opts, out, result, trainer


def test_train_net_logs_lfb_tpus_losses(runs):
    _, out, _, trainer = runs
    port, ref = (losses(out[k][1]) for k in ('port', 'ref'))
    assert sorted(ref) == [1, 2, 3] and sorted(port) == sorted(ref)
    for it, loss in ref.items():
        np.testing.assert_allclose(port[it], loss, rtol=1e-5, err_msg=it)
    assert sorted(trainer.losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in trainer.losses.values())
    # LR 0.04, 0.04, then the step to 0.004; the momentum rescaled from the
    # pickle's LR (0.01) at the first step, and at the LR step.
    np.testing.assert_allclose([trainer.lrs[i] for i in range(3)],
                               [0.04, 0.04, 0.004], rtol=1e-12)
    assert trainer.momentum_scales == [
        (0, 0.04 / float(np.float32(0.01))), (2, 0.004 / 0.04)]
    assert (logged(out['port'][1], 'Scaling update history by ')
            == logged(out['ref'][1], 'Scaling update history by '))


@pytest.mark.parametrize('it', [2, 3])
def test_train_net_checkpoints_match_lfb_tpu(runs, it):
    _, out, _, _ = runs
    name = os.path.join('checkpoints', 'c2_model_iter{}.pkl'.format(it))
    port, ref = (port_ckpt.read_pkl(os.path.join(out[k][0], name))['blobs']
                 for k in ('port', 'ref'))
    assert sorted(port) == sorted(ref)
    assert port['model_iter'] == ref['model_iter'] == it
    assert port['lr'] == ref['lr'] and port['lr'].dtype == ref['lr'].dtype
    for key, want in ref.items():
        if key in ('model_iter', 'lr'):
            continue
        tol = 1e-4 if key.endswith('_momentum') else 1e-5
        np.testing.assert_allclose(port[key], want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=key)


def test_train_net_banks_and_evals_match_lfb_tpu(runs):
    _, out, (last_checkpoint, test_metrics), trainer = runs
    (port_dir, port_log), (ref_dir, ref_log) = out['port'], out['ref']
    for split in ('train', 'val'):
        assert_same_bank(read_bank(port_dir, split), read_bank(ref_dir, split))
    # The train-time eval (json_stats) and the test after training.
    port_stats, ref_stats = (
        [json.loads(s) for s in logged(log, 'json_stats: ')]
        for log in (port_log, ref_log))
    assert len(port_stats) == len(ref_stats) == 1
    assert 0 <= port_stats[0]['test_full_map'] <= 1
    np.testing.assert_allclose(port_stats[0]['test_full_map'],
                               ref_stats[0]['test_full_map'], rtol=0,
                               atol=1e-6)
    assert trainer.evals['iter3']['full_map'] == port_stats[0]['test_full_map']
    ref_test = logged(ref_log, 'Test results: ')
    assert len(ref_test) == 1
    ref_map = float(re.search(r"'full_map': ([^,}]+)", ref_test[0]).group(1))
    assert last_checkpoint == os.path.join(
        os.path.abspath(port_dir), 'checkpoints', 'c2_model_iter3.pkl')
    np.testing.assert_allclose(test_metrics['full_map'], ref_map,
                               rtol=0, atol=1e-6)
    assert assert_same_files(port_dir, ref_dir, tipped_share=0.05) == [
        'detections_final_36_shift1_0.850.csv',
        'detections_iter3.csv']


def test_train_net_resumes_from_the_last_checkpoint(runs, tmp_path):
    """A port run with MAX_ITER 4 over a copy of the first run's output
    resumes at iteration 3 with the params and momentum of iter3.pkl,
    bitwise, and writes iter4.pkl."""
    opts, out, _, _ = runs
    port_dir = out['port'][0]
    resumed_dir = str(tmp_path / 'resumed')
    shutil.copytree(os.path.join(port_dir, 'checkpoints'),
                    os.path.join(resumed_dir, 'checkpoints'))
    saved = port_ckpt.read_pkl(os.path.join(
        port_dir, 'checkpoints', 'c2_model_iter3.pkl'))['blobs']
    (last_checkpoint, test_metrics), trainer = recorded_main(
        ['--config_file', AVA_YAML, '--device', 'cpu'] + opts
        + ['CHECKPOINT.DIR', resumed_dir, 'SOLVER.MAX_ITER', '4',
           'TRAIN.TEST_AFTER_TRAIN', 'False', 'LFB.LOAD_LFB', 'True',
           'LFB.LOAD_LFB_PATH', port_dir])
    start_iter, lr, params, momentum = trainer.start
    assert (start_iter, lr) == (3, float(saved['lr']))
    for name, value in params.items():
        np.testing.assert_array_equal(value.numpy(), saved[name])
    assert sorted(momentum) == sorted(trainer.trainable)
    for name, value in momentum.items():
        np.testing.assert_array_equal(value.numpy(), saved[name + '_momentum'])
    assert sorted(trainer.losses) == [3] and np.isfinite(trainer.losses[3])
    assert last_checkpoint == os.path.join(
        os.path.abspath(resumed_dir), 'checkpoints', 'c2_model_iter4.pkl')
    assert test_metrics is None
