"""The port's ``train_net`` command line on two ranks on the CPU (gloo),
against the same command line on one, and its bank sweep against
``lfb_tpu``'s on a 2-device mesh.

On the tiny on-disk splits of ``tests/synthetic.py`` with
``test_torch_tools.TINY``'s model (R50 arc 2, 8 channels a group, T 4,
crop 32, f32), dropout 0 and host bank windows (``TPU.DEVICE_BANK False``,
drawn by numpy in the loader, so every world size draws the same):

* ``tools.train_net.main`` with ``NUM_GPUS 2`` spawns two ranks
  (``parallel/launch.py``): both bank sweeps, 2 steps of 4 clips (2 a
  rank), the train-time eval, one checkpoint and the test of it.  Against
  the same command with ``NUM_GPUS 1``: the banks' rows within 1e-4 of
  their largest value (``test_torch_tools.assert_same_bank``); exactly one
  checkpoint, its params within 1e-5 and its momentum within 1e-4 of each
  tensor's largest value (a ``*_phi_b`` tensor's of its ``*_phi_w``
  tensor's: its exact gradient is zero); the detections CSVs line for
  line, with at most 5% of the ``%.04f`` scores tipped by one unit (as
  ``test_torch_train_net.py``, two steps of f32 noise); the mAPs within
  1e-5.  The val bank against ``lfb_tpu.bank.get_lfb`` on a 2-device mesh,
  within 1e-4.

``test_torch_parallel_cli.py`` has ``lfb_loader`` and ``test_net``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('cv2')

from lfb_tpu.bank import get_lfb as jax_get_lfb  # noqa: E402
from lfb_tpu.core.config import load_config as jax_load_config  # noqa: E402
from lfb_tpu.parallel import create_mesh  # noqa: E402
import lfb_tpu_torch.tools.train_net as port_train_net  # noqa: E402
from lfb_tpu_torch.train import checkpoints as port_ckpt  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_tools import (AVA_YAML, TINY,  # noqa: E402
                                    assert_same_bank, assert_same_files,
                                    dataset_opts, read_bank, save_weights)

TRAIN = ['TPU.DEVICE_BANK', 'False', 'TRAIN.DROPOUT_RATE', '0.0',
         'FBO_NL.DROPOUT_RATE', '0.0', 'TRAIN.BATCH_SIZE', '4',
         'CHECKPOINT.CONVERT_MODEL', 'False', 'SOLVER.WARMUP.WARMUP_ON',
         'False', 'SOLVER.MAX_ITER', '2', 'CHECKPOINT.CHECKPOINT_PERIOD',
         '2', 'TRAIN.EVAL_PERIOD', '2', 'LOG_PERIOD', '1',
         'TRAIN.TEST_AFTER_TRAIN', 'True', 'TPU.USE_PALLAS', 'False']


def cli(module, opts, out_dir, world, args=()):
    os.makedirs(out_dir, exist_ok=True)
    return module.main(['--config_file', opts[0], '--device', 'cpu',
                        *args] + opts[1:] + ['NUM_GPUS', str(world),
                                             'CHECKPOINT.DIR', out_dir])


@pytest.fixture(scope='module')
def ava(tmp_path_factory):
    """The tiny AVA split with its pickles, and ``train_net.main`` on it at
    each world size: (opts, root, {world: (output dir, result)})."""
    root = str(tmp_path_factory.mktemp('ava'))
    opts = TINY + dataset_opts(synthetic.build_ava(root))
    weights = save_weights(AVA_YAML, opts, root)
    opts = [AVA_YAML] + opts + weights + TRAIN + [
        'TRAIN.PARAMS_FILE', weights[3]]
    runs = {}
    for world in (1, 2):
        out = os.path.join(root, 'world{}'.format(world))
        runs[world] = (out, cli(port_train_net, opts, out, world))
    return opts, root, runs


def test_train_net_on_two_ranks_checkpoints_as_one(ava):
    _, _, runs = ava
    files = {w: sorted(os.listdir(os.path.join(out, 'checkpoints')))
             for w, (out, _) in runs.items()}
    assert files[2] == files[1] == ['c2_model_iter2.pkl']
    one, two = (port_ckpt.read_pkl(os.path.join(
        runs[w][0], 'checkpoints', 'c2_model_iter2.pkl'))['blobs']
        for w in (1, 2))
    assert sorted(two) == sorted(one)
    assert two['model_iter'] == one['model_iter'] == 2
    assert two['lr'] == one['lr']
    for key, want in one.items():
        if key in ('model_iter', 'lr'):
            continue
        tol = 1e-4 if key.endswith('_momentum') else 1e-5
        # A key bias's exact gradient is zero (the softmax over the keys
        # does not see a shift common to them all): its momentum is
        # rounding, held to the scale of its weight's.
        scale = np.abs(one[key.replace('_phi_b', '_phi_w')]).max()
        np.testing.assert_allclose(two[key], want, rtol=0, atol=tol * scale,
                                   err_msg=key)
    # Rank 0's result comes back from the spawned ranks.
    (path_1, metrics_1), (path_2, metrics_2) = runs[1][1], runs[2][1]
    assert os.path.basename(path_2) == os.path.basename(path_1)
    assert path_2.startswith(os.path.abspath(runs[2][0]))
    np.testing.assert_allclose(metrics_2['full_map'], metrics_1['full_map'],
                               rtol=0, atol=1e-5)
    assert not [f for f in os.listdir(runs[2][0])
                if f.startswith('.dist_store')]


def test_train_net_on_two_ranks_sweeps_and_tests_as_one(ava):
    opts, _, runs = ava
    (out_1, _), (out_2, _) = runs[1], runs[2]
    for split in ('train', 'val'):
        assert_same_bank(read_bank(out_2, split), read_bank(out_1, split))
    assert assert_same_files(out_2, out_1, tipped_share=0.05) == [
        'detections_final_36_shift1_0.850.csv', 'detections_iter2.csv']


def test_bank_sweep_on_two_ranks_matches_lfb_tpus_mesh_sweep(ava):
    opts, _, runs = ava
    cfg = jax_load_config(opts[0], opts[1:] + ['LFB.WRITE_LFB', 'False'])
    ref = jax_get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE, is_train=False,
                      mesh=create_mesh(2))
    assert_same_bank(read_bank(runs[2][0], 'val'), ref)
